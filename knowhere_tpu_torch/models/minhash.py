"""MINHASH_LSH: banded MinHash LSH for MHJACCARD (counterpart of
knowhere_tpu/models/minhash.py).

Behavioral parity target: reference src/index/minhash/minhash_lsh.h (584),
minhash_index_node.cc (338), minhash_util.{h,cc}: rows are MinHash signatures
(dim = total bits, elements of mh_element_bit_width bits); banded LSH buckets
with per-band (or shared) Bloom prefilter (minhash_lsh.h:56-149), optional
exact MinHash-Jaccard rerank (mh_search_with_jaccard), batch search
(mh_lsh_batch_search).

Layout: the reference stores transposed band hash KV pairs in disk/mmap
blocks (minhash_lsh.h:283-294). Here each band's KV table is a pair of flat
arrays (hash sorted ascending, row ids in hash order); probe = binary
search; the arrays serialize as sections (no table rebuild on load). Bloom
prefilters are double-hash bitmaps serialized alongside.

The MHJACCARD similarity between two signatures is the fraction of equal
hash elements; LSH bands trade recall for candidate-set size exactly as in
the reference. The signatures live on the device (elements of up to 32
bits as int32 bit patterns, wider ones as int64), and so do the band
hashes, the table sort, the Bloom bit planes, the probes and the
equal-element rerank of every query's candidates. The hashing keeps uint64
semantics in int64 tensors: products and sums wrap alike, every right shift
is masked to a logical one, an unsigned order sorts the sign-flipped bits,
and a residue modulo n_bits adds 2^64 mod n_bits back to negative values.
So the band tables and Bloom bytes equal the JAX package's (its uint64
numpy) bit for bit, and blobs load across packages without a rebuild.

mh_search_with_jaccard and refine_k are declared and never read, as in the
JAX package: candidates are always re-ranked by equal elements.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet, GenResultDataSet, GenTensorDataSet
from ..device import get_device, to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum, metric as M, normalize_metric
from ..index_node import IndexNode, PrecomputedDistanceIterator
from ..io.serialize import read_sections, write_sections
from ..status import KnowhereException, Status, expected


class MinHashConfig(BaseConfig):
    mh_element_bit_width = Entry(int, default=32, range=(1, 64), stages=[Stage.TRAIN, Stage.SEARCH])
    mh_lsh_band = Entry(int, range=(1, 65536), stages=[Stage.TRAIN], allow_empty=True)
    mh_lsh_aligned_block_size = Entry(int, default=4096, range=(1, None), stages=[Stage.TRAIN])
    mh_lsh_code_in_mem = Entry(bool, default=True, stages=[Stage.DESERIALIZE, Stage.TRAIN])
    mh_lsh_shared_bloom_filter = Entry(bool, default=False, stages=[Stage.TRAIN])
    mh_lsh_bloom_false_positive_prob = Entry(float, default=0.01, range=(0.0, 1.0), stages=[Stage.TRAIN])
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])
    with_raw_data = Entry(bool, default=False, stages=[Stage.TRAIN])
    mh_search_with_jaccard = Entry(bool, default=False, stages=[Stage.SEARCH])
    mh_lsh_batch_search = Entry(bool, default=False, stages=[Stage.SEARCH])


RERANK_CHUNK = 1 << 20  # (query, candidate) pairs compared a step on the device
ELEMENT_CHUNK = 4096  # rows unpacked a step where elements are not whole words
_U64 = 1 << 64
_SIGN = -(1 << 63)  # the int64 sign bit: x ^ _SIGN orders bit patterns as uint64
_FNV_PRIME = 1099511628211


def _i64(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - _U64 if c >= 1 << 63 else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """x mod n, x read as uint64 (n < 2^63)."""
    r = torch.remainder(x, n)
    return torch.where(x < 0, torch.remainder(r + _U64 % n, n), r)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 bit patterns (the reference's uint64)."""
    x = x ^ _lsr(x, 30)
    x = x * _i64(0xBF58476D1CE4E5B9)
    x = x ^ _lsr(x, 27)
    x = x * _i64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _to_elements(rows: np.ndarray, dim_bits: int, width: int) -> np.ndarray:
    """Packed signature bytes -> (n, n_elem) uint64 hash elements: element e
    is bits [e*width, (e+1)*width) of the LSB-first bit stream. Widths of a
    whole little-endian word read the words; other widths unpack the bits a
    block of rows at a time."""
    n = rows.shape[0]
    n_elem = dim_bits // width
    b = np.ascontiguousarray(rows.view(np.uint8).reshape(n, -1))
    if width in (8, 16, 32, 64):
        words = b[:, : n_elem * width // 8].copy().view(f"<u{width // 8}")
        return words.astype(np.uint64)
    weights = 1 << np.arange(width, dtype=np.uint64)
    out = np.empty((n, n_elem), np.uint64)
    for s in range(0, n, ELEMENT_CHUNK):
        bits = np.unpackbits(b[s : s + ELEMENT_CHUNK], axis=1, bitorder="little")[:, :dim_bits]
        out[s : s + ELEMENT_CHUNK] = bits.reshape(-1, n_elem, width).astype(np.uint64) @ weights
    return out


def _device_elements(elems: np.ndarray, width: int) -> torch.Tensor:
    """Elements on the device: int32 bit patterns at widths up to 32, int64
    ones above."""
    if width <= 32:
        return to_device(elems.astype(np.uint32).view(np.int32))
    return to_device(np.ascontiguousarray(elems).view(np.int64))


def _as_u64_bits(elems: torch.Tensor) -> torch.Tensor:
    """Device elements as int64 bit patterns of their uint64 values."""
    if elems.dtype == torch.int32:
        return elems.long() & 0xFFFFFFFF
    return elems


class VecBloom:
    """Bloom filter over uint64 keys (reference per-band Bloom prefilter,
    minhash_lsh.h:56-149 / comp/bloomfilter.h). Double hashing h1 + i*h2
    with splitmix64 mixing; the bits are one bool per position on the
    device, packed LSB first (``bits``) for the blob."""

    def __init__(self, capacity: int, fpp: float, bits: Optional[np.ndarray] = None,
                 n_bits: int = 0, n_hashes: int = 0):
        if bits is not None:
            self.n_bits = n_bits
            self.n_hashes = n_hashes
            b = to_device(np.asarray(bits, np.uint8))
            self.plane = ((b[:, None] >> torch.arange(8, device=b.device)) & 1).bool().reshape(-1)
            return
        capacity = max(int(capacity), 1)
        p = min(max(fpp, 1e-9), 0.999)
        m = int(-capacity * math.log(p) / (math.log(2) ** 2)) + 1
        self.n_bits = max(64, m)
        self.n_hashes = max(1, int(round(m / capacity * math.log(2))))
        self.plane = torch.zeros((self.n_bits + 7) // 8 * 8, dtype=torch.bool, device=get_device())

    @property
    def bits(self) -> np.ndarray:
        """The packed bytes: bit (pos & 7) of byte pos >> 3."""
        w = 1 << torch.arange(8, device=self.plane.device)
        return (self.plane.view(-1, 8).long() * w).sum(1).to(torch.uint8).cpu().numpy()

    def _positions(self, keys: torch.Tensor) -> torch.Tensor:
        h1 = _mix64(keys)
        h2 = _mix64(keys ^ _i64(0x9E3779B97F4A7C15)) | 1
        i = torch.arange(self.n_hashes, device=keys.device)[:, None]
        return _umod(h1[None, :] + i * h2[None, :], self.n_bits)

    def add_many(self, keys: torch.Tensor) -> None:
        self.plane[self._positions(keys).reshape(-1)] = True

    def contains_many(self, keys: torch.Tensor) -> torch.Tensor:
        return self.plane[self._positions(keys)].all(dim=0)


class MinHashLSHNode(IndexNode):
    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_MINHASH_LSH
        self.data_type = "bin1"
        self._lock = threading.RLock()
        self._dim = 0
        self._width = 32
        self._n_band = 0
        self._shared_bloom = False
        self._fpp = 0.01
        self._elems: Optional[torch.Tensor] = None  # (nb, n_elem) device elements (_device_elements)
        self._raw: Optional[np.ndarray] = None  # packed signatures
        # band KV tables: per band (hash sorted asc u64, row ids in that order),
        # on the host for the blob and on the device (sign-flipped keys) for probes
        self._band_hash: Optional[np.ndarray] = None  # (n_band, nb) u64
        self._band_rows: Optional[np.ndarray] = None  # (n_band, nb) i64
        self._keys_dev: Optional[torch.Tensor] = None  # (n_band, nb) band hash ^ _SIGN, ascending
        self._rows_dev: Optional[torch.Tensor] = None
        self._blooms: List[VecBloom] = []  # one per band, or [shared]
        self._tables_dirty = False
        self._last_search_stats: Dict[str, int] = {}

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        if normalize_metric(cfg.metric_type) != M.MHJACCARD:
            raise KnowhereException("MINHASH_LSH requires MHJACCARD", Status.invalid_metric_type)
        self._dim = dataset.dim
        self._width = int(cfg.mh_element_bit_width)
        if self._dim % self._width != 0:
            raise KnowhereException(
                f"dim {self._dim} not divisible by element width {self._width}", Status.invalid_args
            )
        n_elem = self._dim // self._width
        band = cfg.get("mh_lsh_band")
        self._n_band = int(band) if band else max(1, n_elem // 4)
        if n_elem % self._n_band != 0:
            raise KnowhereException(
                f"element count {n_elem} not divisible by band count {self._n_band}",
                Status.invalid_args,
            )
        self._shared_bloom = bool(cfg.get("mh_lsh_shared_bloom_filter", False))
        self._fpp = float(cfg.get("mh_lsh_bloom_false_positive_prob", 0.01) or 0.01)
        return Status.success

    def _elements(self, rows: np.ndarray) -> torch.Tensor:
        return _device_elements(_to_elements(rows, self._dim, self._width), self._width)

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        rows = np.asarray(dataset.tensor)
        with self._lock:
            elems = self._elements(rows)
            self._elems = elems if self._elems is None else torch.cat([self._elems, elems])
            self._raw = rows if self._raw is None else np.concatenate([self._raw, rows])
            self._tables_dirty = True
        return Status.success

    def _band_hashes(self, elems: torch.Tensor) -> torch.Tensor:
        """(n_band, n) band signatures as int64 bit patterns (FNV-folded,
        order-sensitive)."""
        rpb = elems.shape[1] // self._n_band
        out = torch.empty((self._n_band, elems.shape[0]), dtype=torch.int64, device=elems.device)
        for b in range(self._n_band):
            seg = _as_u64_bits(elems[:, b * rpb : (b + 1) * rpb])
            h = torch.zeros(elems.shape[0], dtype=torch.int64, device=elems.device)
            for c in range(rpb):
                h = h * _FNV_PRIME + seg[:, c]
            out[b] = h
        return out

    def _bloom_keys(self, band_idx: int, hashes: torch.Tensor) -> torch.Tensor:
        """Shared bloom mixes the band index into the key (reference
        mh_lsh_shared_bloom_filter: one filter for all bands)."""
        if not self._shared_bloom:
            return hashes
        return hashes ^ _mix64(torch.full_like(hashes[:1], band_idx + 1))

    def _ensure_tables(self) -> None:
        if not self._tables_dirty and self._band_hash is not None:
            return
        nb = self._elems.shape[0]
        bh = self._band_hashes(self._elems)  # (n_band, nb)
        keys, order = torch.sort(bh ^ _SIGN, dim=1, stable=True)
        self._keys_dev, self._rows_dev = keys, order
        self._band_hash = (keys ^ _SIGN).cpu().numpy().view(np.uint64)
        self._band_rows = order.cpu().numpy()
        if self._shared_bloom:
            bloom = VecBloom(nb * self._n_band, self._fpp)
            for b in range(self._n_band):
                bloom.add_many(self._bloom_keys(b, bh[b]))
            self._blooms = [bloom]
        else:
            self._blooms = []
            for b in range(self._n_band):
                bloom = VecBloom(nb, self._fpp)
                bloom.add_many(bh[b])
                self._blooms.append(bloom)
        self._tables_dirty = False

    def _bloom_for(self, b: int) -> VecBloom:
        return self._blooms[0] if self._shared_bloom else self._blooms[b]

    def _probe(self, keys: torch.Tensor, hit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The KV probe of (n_band, m) query band keys (sign-flipped) where
        ``hit``: every stored row whose band hash equals one, as (query
        column, row id) pairs."""
        keys = keys.contiguous()
        lo = torch.searchsorted(self._keys_dev, keys, right=False)
        hi = torch.searchsorted(self._keys_dev, keys, right=True)
        cnt = torch.where(hit, hi - lo, torch.zeros_like(lo)).reshape(-1)
        band = torch.arange(self._n_band, device=keys.device)[:, None].expand_as(lo).reshape(-1)
        col = torch.arange(keys.shape[1], device=keys.device)[None, :].expand_as(lo).reshape(-1)
        total = int(cnt.sum())
        start = torch.cumsum(cnt, 0) - cnt
        seg = torch.repeat_interleave(torch.arange(cnt.numel(), device=keys.device), cnt, output_size=total)
        pos = lo.reshape(-1)[seg] + torch.arange(total, device=keys.device) - start[seg]
        return col[seg], self._rows_dev[band[seg], pos]

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        with self._lock:
            if self._elems is None:
                return expected.Err(Status.empty_index, "index not built")
            if normalize_metric(cfg.metric_type) != M.MHJACCARD:
                return expected.Err(Status.invalid_metric_type, "MINHASH_LSH requires MHJACCARD")
            self._ensure_tables()
            k = cfg.k
            q_elems = self._elements(np.asarray(dataset.tensor))
            nq = q_elems.shape[0]
            nb = self._elems.shape[0]
            hashes = self._band_hashes(q_elems)  # (n_band, nq)

            # bloom prefilter: probe the KV table only where the filter says
            # the band hash may exist (minhash_lsh.h:56-149)
            bloom_hits = torch.stack([
                self._bloom_for(b).contains_many(self._bloom_keys(b, hashes[b])) for b in range(self._n_band)
            ])
            keys = hashes ^ _SIGN
            # batch mode probes every band for the whole query batch in one
            # pass (reference mh_lsh_batch_search); otherwise one query at a time
            if bool(cfg.get("mh_lsh_batch_search", False)):
                qidx, ids = self._probe(keys, bloom_hits)
            else:
                parts = [self._probe(keys[:, i : i + 1], bloom_hits[:, i : i + 1]) for i in range(nq)]
                qidx = torch.cat([torch.full_like(c, i) for i, (c, _) in enumerate(parts)])
                ids = torch.cat([r for _, r in parts])
            # each query's candidates: unique ids (ascending), bitset applied
            pair = torch.unique(qidx * nb + ids)
            qidx, ids = pair // nb, pair % nb
            if not bitset.empty_view():
                keep = to_device(bitset.host_mask(nb))[ids]
                qidx, ids = qidx[keep], ids[keep]
            n_hit = int(bloom_hits.sum())
            self._last_search_stats = {"bloom_skipped": bloom_hits.numel() - n_hit,
                                       "candidates": int(ids.numel()), "probes": n_hit}
            out_ids, out_d = self._rerank(q_elems, qidx, ids, nq, k)
            return expected.Ok(GenResultDataSet(nq, k, out_ids, out_d))

    def _equal_counts(self, q_elems: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Equal elements of query row qidx[j] and stored row ids[j], on the
        device, RERANK_CHUNK pairs a step."""
        parts = [
            (self._elems[ids[s : s + RERANK_CHUNK]] == q_elems[qidx[s : s + RERANK_CHUNK]]).sum(1)
            for s in range(0, ids.numel(), RERANK_CHUNK)
        ]
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=ids.device)

    def _similarity(self, counts: torch.Tensor) -> torch.Tensor:
        """MHJACCARD = the fraction of equal elements: the count over n_elem
        in f64, then f32 (numpy's mean of a bool row, cast)."""
        return (counts.double() / self._elems.shape[1]).float()

    def _rerank(self, q_elems, qidx: torch.Tensor, ids: torch.Tensor, nq: int, k: int):
        """Every query's top-k candidates (sorted by query, then id) by
        equal-element count in one batch: ties keep the lower id (the
        reference's stable argsort over ascending ids). Returns (ids (nq,k)
        -1 padded, similarities)."""
        out_ids = np.full((nq, k), -1, np.int64)
        out_d = np.zeros((nq, k), np.float32)
        if ids.numel() == 0:
            return out_ids, out_d
        counts = self._equal_counts(q_elems, qidx, ids)
        n_elem = self._elems.shape[1]
        order = torch.sort(qidx * (n_elem + 1) + (n_elem - counts), stable=True).indices
        lens = torch.bincount(qidx, minlength=nq)
        rank = torch.arange(order.numel(), device=order.device) - (torch.cumsum(lens, 0) - lens)[qidx]
        top = rank < k
        sel = order[top]
        q_top, r_top = qidx[top].cpu().numpy(), rank[top].cpu().numpy()
        out_ids[q_top, r_top] = ids[sel].cpu().numpy()
        out_d[q_top, r_top] = self._similarity(counts[sel]).cpu().numpy()
        return out_ids, out_d

    def AnnIterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True):
        with self._lock:
            if self._elems is None:
                return expected.Err(Status.empty_index, "index not built")
            q_elems = self._elements(np.asarray(dataset.tensor))
            nb = self._elems.shape[0]
            keep = bitset.host_mask(nb) if not bitset.empty_view() else None
            all_ids = torch.arange(nb, device=self._elems.device)
            its = []
            for i in range(q_elems.shape[0]):
                counts = self._equal_counts(q_elems[i : i + 1], torch.zeros_like(all_ids), all_ids)
                sim = self._similarity(counts).cpu().numpy()
                its.append(PrecomputedDistanceIterator(sim, keep, larger_is_closer=True))
            return expected.Ok(its)

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        with self._lock:
            if self._raw is None:
                return expected.Err(Status.empty_index, "index not built")
            ids = np.asarray(dataset.ids, dtype=np.int64)
            if ids.min(initial=0) < 0 or ids.max(initial=-1) >= len(self._raw):
                return expected.Err(Status.invalid_args, "id out of range")
            return expected.Ok(GenTensorDataSet(self._raw[ids], len(ids), self._dim))

    def HasRawData(self, metric_type: str = "MHJACCARD") -> bool:
        return True

    def Serialize(self, binset: BinarySet) -> Status:
        """Serializes raw signatures AND the band KV tables + bloom bitmaps
        (reference writes transposed band KV blocks, minhash_lsh.h:283-294):
        Deserialize loads them without rebuilding."""
        with self._lock:
            if self._raw is None:
                return Status.empty_index
            self._ensure_tables()
            blooms = [bl.bits for bl in self._blooms]
            arrays = {
                "raw": self._raw,
                "band_hash": self._band_hash,
                "band_rows": self._band_rows,
                "bloom_bits": np.concatenate(blooms),
            }
            blob = write_sections(
                arrays,
                meta={
                    "dim": self._dim, "width": self._width, "n_band": self._n_band,
                    "shared_bloom": self._shared_bloom, "fpp": self._fpp,
                    "bloom_meta": [
                        {"n_bits": bl.n_bits, "n_hashes": bl.n_hashes, "nbytes": int(bits.size)}
                        for bl, bits in zip(self._blooms, blooms)
                    ],
                },
            )
            binset.Append(self.Type(), blob)
            return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        with self._lock:
            self._dim = int(meta["dim"])
            self._width = int(meta["width"])
            self._n_band = int(meta["n_band"])
            self._shared_bloom = bool(meta.get("shared_bloom", False))
            self._fpp = float(meta.get("fpp", 0.01))
            self._raw = np.array(arrays["raw"])
            # decode signatures for the rerank; the LSH tables load as-is
            self._elems = self._elements(self._raw)
            if "band_hash" in arrays:
                self._band_hash = np.array(arrays["band_hash"])
                self._band_rows = np.array(arrays["band_rows"])
                self._keys_dev = to_device(self._band_hash.view(np.int64)) ^ _SIGN
                self._rows_dev = to_device(self._band_rows)
                self._blooms = []
                off = 0
                bits = np.asarray(arrays["bloom_bits"])
                for bm in meta["bloom_meta"]:
                    self._blooms.append(VecBloom(
                        1, self._fpp, bits=bits[off : off + bm["nbytes"]],
                        n_bits=bm["n_bits"], n_hashes=bm["n_hashes"],
                    ))
                    off += bm["nbytes"]
                self._tables_dirty = False
            else:  # legacy blobs carried only the raw signatures
                self._band_hash = None
                self._tables_dirty = True
            return Status.success

    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        """The reference's figure: the signatures as uint64 elements."""
        return 0 if self._elems is None else int(self._elems.numel() * 8)

    def Count(self) -> int:
        return 0 if self._elems is None else self._elems.shape[0]

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return MinHashConfig()


register_index(
    IndexEnum.INDEX_MINHASH_LSH, ("bin1",), feature.BINARY | feature.KNN | feature.MMAP
)(MinHashLSHNode)
