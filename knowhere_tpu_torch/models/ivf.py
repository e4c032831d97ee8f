"""The IVF family: IVF_FLAT, IVF_FLAT_CC, IVF_PQ, SCANN, IVF_SQ8, IVF_SQ_CC,
IVF_RABITQ, IVF_RABITQ_FASTSCAN and BIN_IVF_FLAT (counterpart of
knowhere_tpu/models/ivf.py, VARIANT "flat", "flat_cc", "pq", "scann", "sq",
"sq_cc", "rabitq", "rabitq_fastscan" and "bin").

Train runs k-means for the coarse quantizer (nlist auto-shrinks as in the
reference, MatchNlist); IVF_PQ then trains PQ codebooks on the residuals,
behind an OPQ rotation by default; SCANN trains 4-bit PQ (m = dim / sub_dim,
no OPQ) on the residuals and keeps the raw rows for its reorder
(with_raw_data); IVF_SQ8 trains its per-dim scalar grid (sq_type SQ8, SQ6,
SQ4, FP16 or BF16); IVF_RABITQ draws its random rotation and keeps a raw
refine store by default; BIN_IVF_FLAT (IVFBIN) snaps its centroids to {0,1}
by majority. Add sorts the rows by list into one contiguous store, each list
padded to LIST_ALIGN rows when the corpus is large enough, so every scan
block is one aligned slice. Search probes the nearest lists, builds the
(list block x query group) tasks, scans them and merges per query:

- IVF_FLAT, EXACT precision (the default): the full-f32 plain task scan.
- IVF_FLAT, FAST/BF16 with the int8 sidecar (aligned store, d % 128 == 0):
  the int8 scan kernel ranks a widened pool (max(4k, 48)), then an exact f32
  rerank over the raw rows returns the final distances.
- IVF_FLAT, FAST/BF16 without the sidecar (KNOWHERE_DISABLE_INT8_SCAN=1): the
  f32 scan kernel (the three-pass hi/lo bf16 product for FAST; bf16 plus exact
  rerank for BF16).
- IVF_FLAT over fp16, bf16 or int8 rows (data_type): the rows keep their
  width on the host, in the blob and on the device (fp16 rows are held there
  in bf16, as the reference holds them), a cosine corpus's normalized copy in
  bf16; no int8 sidecar, and the plain scan widens each block to f32.
- BIN_IVF_FLAT: the bits unpacked to {0,1} f32 rows on the device; HAMMING
  is L2 over them (the f32 scan kernel, one bf16 pass, below EXACT), JACCARD
  takes the plain scan.
- IVF_PQ and SCANN: queries rotate into the OPQ frame (IVF_PQ); FAST/BF16
  run the ADC scan kernel over an aligned store (SCANN's codes two to a byte,
  the nibble layout), EXACT the plain scan over decoded codes. With a refine
  store the scan keeps k * refine_k candidates (SCANN: max(k, reorder_k)) and
  the refine pass re-scores them from the stored (f32/fp16/bf16/SQ8) rows.
- IVF_SQ8: EXACT decodes the codes in the plain scan. Below EXACT, SQ8 with
  its int8 sidecar (aligned store, d % 128 == 0) runs the int8 scan kernel
  on the u8 codes in place and re-ranks the widened pool by SQ8 decode;
  without the sidecar (KNOWHERE_DISABLE_INT8_SCAN=1 at load) SQ8 and SQ6 run
  the SQ scan kernel (single bf16 pass); SQ4, FP16 and BF16 the plain scan.
- IVF_RABITQ / IVF_RABITQ_FASTSCAN: queries rotate by rot_t; below EXACT the
  RaBitQ scan kernel estimates distances from the sign bits, EXACT runs the
  same estimator in the plain scan; the raw refine store (the default)
  re-scores k * refine_k candidates, else the distance is the estimator's.
  rbq_bits / rbq_bits_query are accepted and the scan takes one bit, as in
  the reference.

A query that comes back with fewer than k results is re-probed with nprobe x4
per round until it is full (ensure_topk_full, on by default; off for SCANN).
The rerank re-scores its queries in steps whose gathered rows and merge pool
stay under REFINE_CHUNK_BYTES (one step at k=10); a scan whose merge pool
would pass SCAN_BLOCK_BYTES runs its queries in blocks of whole steps, so
every query's bits equal one block's.

Add on a built index (every variant; IVF_FLAT_CC and IVF_SQ_CC are the
names whose users add while they search) appends to a copy-on-write pending
list: Search takes an epoch snapshot under the lock, scans it outside, and
merges an exact scan of the pending rows into its result. Once the pending
rows pass max(4096, stored rows / 4), the writer builds the next epoch (the
stored rows reconstructed, the pending rows appended, re-assigned to the
same centroids and re-encoded) on a shadow node off the read lock and
swaps it in under the lock; RangeSearch, AnnIterator and Serialize merge
the pending rows first.

RangeSearch and AnnIterator run the same searches in expanding rounds (k x4
a round up to DEVICE_K_MAX, nprobe x4 while a frontier runs short), each
round through the variant's scan kernel; what the rounds cannot cover ends
in one exact pass over every stored row (_full_sorted: the rows as the
scans score them, decoded on the device, distances in float64).
GetVectorByIds returns the raw rows in their own dtype (IVF_FLAT, packed
bits for BIN_IVF_FLAT, SCANN's raw rows); PQ, SQ and RaBitQ answer
Status.not_implemented, as HasRawData says. CalcDistByIDs scores the stored
raw or refine rows as the reference does (an SQ8 refine store's codes as
their values). GetIndexMeta and GetFederVisit give feder's overview and the
probed lists.

Each upload demotes the host payloads to disk-backed memmaps
(utils/spill.py, as the reference does); an epoch that a merge replaces
deletes its files.
"""

from __future__ import annotations

import math
import os
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet, GenRangeResultDataSet, GenResultDataSet, GenTensorDataSet
from ..device import get_device, to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum, metric as M, normalize_metric
from .. import index_node as _index_node
from ..index_node import ExpandingIteratorGroup, IndexNode
from ..io.serialize import read_sections, write_sections
from ..ops import distances as D
from ..ops import quant as Q
from ..ops import range as R
from ..ops import topk as T
from ..ops.distances import DistancePrecision, get_distance_precision, pad_rows_ladder
from ..ops.adc_cuda import unpack_codes
from ..ops.ivf_cuda import LIST_ALIGN, unpack_signs
from ..ops.ivf_scan import _nib, coarse_probe, coarse_probe_host, ivf_scan_search, pool_bound, scan_route
from ..ops.kmeans import assign_rows, kmeans
from ..ops.refine import RefineStore, refine_topk_device, sq8_encode
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import as_f32, bf16_bits, bf16_to_f32, rows_to_device
from ..utils.logging import log_warning
from ..utils import tracing
from ..utils.spill import release_spill, spill_dict

MIN_POINTS_PER_CENTROID = 39  # reference ivf.cc:478
B_SLACK = 2048  # zero rows after the store: a block slice never runs off its end
# host rows copied (and their norms taken) per step of an upload: one
# zeroed buffer filled in chunks of this many bytes, never a full-size
# float64 or padded temporary (as knowhere_tpu/models/ivf.py uploads)
UPLOAD_CHUNK_BYTES = 256 << 20
# device bytes one query block of a scan may hold in its merge pool (about
# POOL_ENTRY_BYTES a candidate). A search whose pool would pass it (the
# wide-k rounds of RangeSearch and AnnIterator over many lists, a Search at
# a large k) runs its queries in blocks of whole refine chunks; at k=10 the
# block is the whole batch.
SCAN_BLOCK_BYTES = 2 << 30
POOL_ENTRY_BYTES = 32  # f32 score + int64 position, and the merge sort's copy of both
# device bytes of one query block's ADC table (m x ksub f32 a query,
# ops/ivf_scan._adc_search): a PQ batch whose table would pass it scans in
# blocks too. Neither the SIFT1M (10,240 x m 16) nor the GIST1M (1,000 x
# m 96) batch reaches it.
QTABLE_BYTES = 1 << 30
# device bytes one step of the rerank may hold: its gathered rows and their
# temporaries (RefineStore.row_bytes) and those queries' merge pool. At the
# k=10 searches of a 10,000-query batch (1M x 128, GIST 1,000 x 960) the
# step is the whole batch; the wide rounds re-score a few hundred queries
# a step.
REFINE_CHUNK_BYTES = 4 << 30
FULL_SORT_ROWS = 65536  # stored rows decoded per step of _full_sorted
FULL_SORT_QUERIES = 64  # queries per step of _full_sorted: (64, nb) distances and their sort


def match_nlist(rows: int, nlist: int) -> int:
    """nlist auto-shrink (reference MatchNlist, ivf.cc:476-487)."""
    if nlist * MIN_POINTS_PER_CENTROID > rows:
        new = max(1, rows // MIN_POINTS_PER_CENTROID)
        log_warning(f"nlist({nlist}) is too large, adjust to {new}")
        return new
    return nlist


def match_nbits(rows: int, nbits: int) -> int:
    """nbits auto-shrink so each PQ codebook can be trained (MatchNbits)."""
    while nbits > 1 and (1 << nbits) > max(rows, 2):
        nbits -= 1
    return nbits


class IvfConfig(BaseConfig):
    nlist = Entry(int, default=128, range=(1, 65536), stages=[Stage.TRAIN])
    nprobe = Entry(int, default=8, range=(1, 65536), stages=[Stage.SEARCH, Stage.ITERATOR, Stage.RANGE_SEARCH])
    use_elkan = Entry(bool, default=True, stages=[Stage.TRAIN])
    ensure_topk_full = Entry(bool, default=True, stages=[Stage.SEARCH])
    max_empty_result_buckets = Entry(int, default=2, range=(0, 65536), stages=[Stage.RANGE_SEARCH])


class IvfFlatConfig(IvfConfig):
    pass


class IvfFlatCcConfig(IvfConfig):
    ssize = Entry(int, default=48, range=(32, 2048), stages=[Stage.TRAIN])


class IvfPqConfig(IvfConfig):
    m = Entry(int, range=(1, 65536), stages=[Stage.TRAIN], allow_empty=True)
    nbits = Entry(int, default=8, range=(1, 24), stages=[Stage.TRAIN])
    refine = Entry(bool, default=False, stages=[Stage.TRAIN])
    refine_type = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])
    # OPQ rotation before PQ, on by default as in the reference
    opq = Entry(bool, default=True, stages=[Stage.TRAIN])


class ScannConfig(IvfConfig):
    reorder_k = Entry(int, range=(1, None), stages=[Stage.SEARCH], allow_empty=True)
    with_raw_data = Entry(bool, default=True, stages=[Stage.TRAIN])
    sub_dim = Entry(int, default=2, range=(1, 65536), stages=[Stage.TRAIN])
    ensure_topk_full = Entry(bool, default=False, stages=[Stage.SEARCH])


class IvfSqConfig(IvfConfig):
    sq_type = Entry(str, default="SQ8", stages=[Stage.TRAIN])
    refine = Entry(bool, default=False, stages=[Stage.TRAIN])
    refine_type = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])


class IvfSqCcConfig(IvfSqConfig):
    ssize = Entry(int, default=48, range=(32, 2048), stages=[Stage.TRAIN])
    code_size = Entry(int, default=8, range=(4, 8), stages=[Stage.TRAIN])
    raw_data_store_prefix = Entry(str, stages=[Stage.TRAIN], allow_empty=True)


class IvfRaBitQConfig(IvfConfig):
    rbq_bits = Entry(int, default=1, range=(1, 9), stages=[Stage.TRAIN])
    rbq_bits_query = Entry(int, default=0, range=(0, 8), stages=[Stage.SEARCH])
    refine = Entry(bool, default=True, stages=[Stage.TRAIN])
    refine_type = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])


_CONFIGS = {
    "flat": IvfFlatConfig, "flat_cc": IvfFlatCcConfig, "pq": IvfPqConfig, "scann": ScannConfig,
    "sq": IvfSqConfig, "sq_cc": IvfSqCcConfig, "rabitq": IvfRaBitQConfig,
    "rabitq_fastscan": IvfRaBitQConfig, "bin": IvfFlatConfig,
}
# the store each variant keeps: raw rows, PQ codes, SQ codes or RaBitQ signs
_KIND = {
    "flat": "raw", "flat_cc": "raw", "bin": "raw", "pq": "pq", "scann": "pq",
    "sq": "sq", "sq_cc": "sq", "rabitq": "rabitq", "rabitq_fastscan": "rabitq",
}
_TYPED = ("fp16", "bf16", "int8")  # data types whose raw rows keep their width
MERGE_MIN_PENDING = 4096  # pending rows merge past max(this, stored rows / 4)


class _Plan(NamedTuple):
    """How one search scans: its route (ops/ivf_scan.scan_route: a kernel's,
    or "plain") and the precision the route scans at, whether the raw rows
    re-rank the pool (two_stage), the scan's k and the k the refine store
    re-scores."""

    route: str
    prec: str
    two_stage: bool
    k_scan: int
    k_coarse: int


def _refine_chunk(row_bytes: int, pool_bytes: int) -> int:
    """Queries one rerank step re-scores: as many as keep their gathered rows
    (``row_bytes`` a query) and merge pool (``pool_bytes``) under
    REFINE_CHUNK_BYTES."""
    return max(1, REFINE_CHUNK_BYTES // (row_bytes + pool_bytes))


def _row_chunks(n: int, row_bytes: int):
    """(i0, i1) row ranges of about UPLOAD_CHUNK_BYTES each."""
    ch = max(1, UPLOAD_CHUNK_BYTES // max(row_bytes, 1))
    return ((i0, min(i0 + ch, n)) for i0 in range(0, n, ch))


def _pad_cols(a: np.ndarray, width: int, slack: int = 0) -> np.ndarray:
    """(n, d) host rows zero-padded to (n + slack, width) in one
    preallocated buffer, filled in row chunks; a itself when nothing pads."""
    if a.shape[1] == width and not slack:
        return a
    buf = np.zeros((a.shape[0] + slack, width), a.dtype)
    for i0, i1 in _row_chunks(a.shape[0], a.shape[1] * a.dtype.itemsize):
        buf[i0:i1, : a.shape[1]] = a[i0:i1]
    return buf


def _release_payload(payload: dict) -> None:
    """Delete the spill files of an epoch's host payloads that a new epoch
    replaced."""
    for v in payload.values():
        release_spill(v)


def _concat_rows(parts: List[np.ndarray]) -> np.ndarray:
    """Rows of one dtype concatenated; rows of mixed dtypes as f32, bf16 bit
    patterns widened to their values (numpy's promotion of the reference's
    mixed ml_dtypes rows)."""
    if len({p.dtype for p in parts}) == 1:
        return np.concatenate(parts, axis=0)
    return np.concatenate([as_f32(p) for p in parts], axis=0)


class IvfIndexNode(IndexNode):
    VARIANT = "flat"

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_FAISS_IVFFLAT
        self.data_type = "fp32"
        self._lock = threading.RLock()  # guards the epoch: every mutator rebinds whole fields under it
        self._writer_lock = threading.Lock()  # one writer (Add, merges); taken before _lock
        self._trained = False
        self._metric = M.L2
        self._dim = 0
        self._d_dev = 0  # device feature width (zero-padded to a 128 multiple)
        self._nlist = 0
        self._pq: Optional[Q.PQCodec] = None
        self._opq_rot: Optional[np.ndarray] = None  # OPQ rotation (d, d)
        self._sq: Optional[Q.SQCodec] = None
        self._rbq: Optional[Q.RaBitQCodec] = None
        self._sq_levels = 0  # SQ8/SQ6/SQ4 grid size; 0 for FP16/BF16 rows
        self._sq_packed4 = False
        self._refine_cfg: Optional[str] = None  # refine store kind or None
        self._centroids: Optional[np.ndarray] = None
        self._norms_raw: Optional[np.ndarray] = None  # cosine restore norms
        self._row_ids: Optional[np.ndarray] = None  # padded sorted pos -> row id (-1 pad)
        self._pos_of_row: Optional[np.ndarray] = None  # row id -> padded sorted pos (derived)
        self._offsets: Optional[np.ndarray] = None  # (nlist+1,) padded storage starts
        self._lengths: Optional[np.ndarray] = None  # (nlist,) TRUE list lengths
        self._count = 0
        self._sorted_payload = {}
        self._pending_rows: List[np.ndarray] = []  # rows added after the build, copy-on-write
        self._pending_count = 0
        self._store = None  # device tensors
        self._refine_store: Optional[RefineStore] = None
        self._assign_cache = None

    # --- helpers ---------------------------------------------------------
    @property
    def _kind(self) -> str:
        return _KIND[self.VARIANT]

    def _is_binary(self) -> bool:
        return self.VARIANT == "bin"

    def _internal_metric(self) -> str:
        return M.IP if self._metric == M.COSINE else self._metric  # cosine = normalize + IP

    def _is_l2_like(self) -> bool:
        return self._internal_metric() in (M.L2, M.HAMMING)

    def _is_jaccard(self) -> bool:
        return self._internal_metric() == M.JACCARD

    def _larger_is_closer(self) -> bool:
        # native distances: L2 / HAMMING squared-L2-like, JACCARD 1 - similarity;
        # only IP / COSINE give similarities
        return self._internal_metric() == M.IP

    def _is_rabitq(self) -> bool:
        return self._kind == "rabitq"

    def _payload_f32(self, key: str, rows) -> np.ndarray:
        """Payload ``key`` at ``rows`` (a slice or positions) as f32."""
        return as_f32(self._sorted_payload[key][rows])

    def _native(self, x: np.ndarray) -> np.ndarray:
        """Input rows as the index holds them: a bf16 corpus's as bit patterns."""
        x = np.asarray(x)
        return bf16_bits(x) if self.data_type == "bf16" and not self._is_binary() else x

    def _prep_rows(self, x: np.ndarray) -> np.ndarray:
        """Raw input rows -> f32 compute rows ({0,1} planes for binary;
        cosine-normalized)."""
        x = np.asarray(x)
        if self._is_binary():
            return D.unpack_bits_host(x.view(np.uint8), self._dim).astype(np.float32)
        x = as_f32(x)
        if self._metric == M.COSINE:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            n[n == 0] = 1.0
            x = x / n
        return x

    # --- Train ---------------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        allowed = (M.HAMMING, M.JACCARD) if self._is_binary() else (M.L2, M.IP, M.COSINE)
        if self._metric not in allowed:
            raise KnowhereException(
                f"metric {self._metric} not supported by {self.Type()}",
                Status.invalid_metric_type,
            )
        rows = dataset.rows
        self._dim = dataset.dim
        x = self._prep_rows(np.asarray(dataset.tensor))
        self._nlist = match_nlist(rows, int(cfg.nlist))
        # the cuVS configs' trainer knobs (models/cagra.py); the plain IVF
        # configs leave them unset: 12 iterations, 256 points a centroid
        n_iters = int(cfg.get("kmeans_n_iters", 12) or 12)
        frac = float(cfg.get("kmeans_trainset_fraction", 0.0) or 0.0)
        mppc = max(1, int(rows * frac) // max(self._nlist, 1)) if frac > 0.0 else 256
        centroids, assign_full = kmeans(x, self._nlist, n_iters=n_iters, seed=1234, max_points_per_centroid=mppc)
        if self._is_binary():
            # binary IVF: centroids snap to {0,1} planes (majority vote); the
            # snapped centroids invalidate the assignment
            centroids = (centroids > 0.5).astype(np.float32)
            assign_full = None
        self._centroids = centroids
        # Build = Train + Add on the same rows reuses the assignment
        self._assign_cache = None if assign_full is None else (
            rows, float(x[:: max(rows // 7, 1), 0].sum()), assign_full
        )
        if self.VARIANT == "pq":
            m = cfg.m if cfg.m is not None else max(1, self._dim // 2)
            if self._dim % m != 0:
                raise KnowhereException(f"dim {self._dim} not divisible by m {m}", Status.invalid_args)
            nbits = match_nbits(rows, int(cfg.nbits))
            if nbits > 8:
                raise KnowhereException("PQ codes are one byte: nbits must be <= 8", Status.invalid_args)
            resid = x - centroids[assign_full]
            if cfg.get("opq", True) and rows >= 4 * (1 << nbits):
                self._opq_rot, self._pq = Q.opq_train(resid, int(m), nbits)
            else:
                self._opq_rot, self._pq = None, Q.pq_train(resid, int(m), nbits)
            self._refine_cfg = self._refine_kind(cfg)
        elif self.VARIANT == "scann":
            sub_dim = int(cfg.sub_dim)
            if self._dim % sub_dim != 0:
                raise KnowhereException(f"dim {self._dim} not divisible by sub_dim {sub_dim}", Status.invalid_args)
            resid = x - centroids[assign_full]
            self._pq = Q.pq_train(resid, self._dim // sub_dim, match_nbits(rows, 4))
            self._refine_cfg = "raw" if cfg.with_raw_data else None
        elif self._kind == "sq":
            self._sq = Q.sq_train(x, cfg.sq_type or "SQ8")
            self._refine_cfg = self._refine_kind(cfg)
        elif self._is_rabitq():
            self._rbq = Q.rabitq_make(self._dim)
            self._refine_cfg = self._refine_kind(cfg) or ("raw" if cfg.get("refine", True) else None)
        self._trained = True
        return Status.success

    @staticmethod
    def _refine_kind(cfg: Config) -> Optional[str]:
        if not cfg.get("refine", False):
            return None
        rt = (cfg.get("refine_type") or "DATA_VIEW").upper()
        if rt in ("UINT8_QUANT", "UINT8", "SQ8"):
            return "sq8"
        if rt in ("FLOAT16_QUANT", "FP16"):
            return "fp16"
        if rt in ("BFLOAT16_QUANT", "BF16"):
            return "bf16"
        return "raw"

    # --- Add -------------------------------------------------------------------
    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        """The first Add builds the store; an Add on a built index appends
        to the pending list (copy-on-write: a search's snapshot keeps its
        epoch) and merges it into the next epoch once it passes
        max(MERGE_MIN_PENDING, stored rows / 4)."""
        if not self._trained:
            return Status.index_not_trained
        x_in = self._native(dataset.tensor)
        with self._writer_lock:
            if self._row_ids is not None:
                with self._lock:
                    self._pending_rows = self._pending_rows + [x_in]
                    self._pending_count += x_in.shape[0]
                    need_merge = self._pending_count > max(MERGE_MIN_PENDING, len(self._row_ids) // 4)
                if need_merge:
                    self._merge_pending_offlock()
                return Status.success
            with self._lock:
                self._build_storage(x_in)
        return Status.success

    def _merged_rows(self) -> np.ndarray:
        """The stored rows (reconstructed, in id order) followed by the
        pending rows."""
        return _concat_rows(([self._reconstruct_all()] if self._count else []) + self._pending_rows)

    def _merge_pending(self) -> None:
        """Fold the pending rows into the store. The caller holds both locks."""
        if not self._pending_rows:
            return
        merged = self._merged_rows()
        old = self._sorted_payload
        self._pending_rows, self._pending_count, self._row_ids = [], 0, None
        self._build_storage(merged)
        _release_payload(old)

    def _merge_pending_offlock(self) -> None:
        """The epoch merge off the read lock: the next epoch is built on a
        shadow node, then every field is swapped in under _lock, so searches
        keep scanning the old epoch meanwhile (the reference's CC contract,
        ivf.cc:605-631). The caller holds _writer_lock, not _lock."""
        if not self._pending_rows:
            return
        merged = self._merged_rows()
        shadow = object.__new__(type(self))
        shadow.__dict__.update(self.__dict__)
        shadow._pending_rows, shadow._pending_count, shadow._row_ids = [], 0, None
        shadow._build_storage(merged)
        new_state = {k: v for k, v in shadow.__dict__.items() if k not in ("_lock", "_writer_lock")}
        with self._lock:
            old = self._sorted_payload
            self.__dict__.update(new_state)
        # a search still scanning the old epoch keeps reading its maps: an
        # unlinked file stays mapped until the last view goes
        _release_payload(old)

    def _reconstruct_all(self) -> np.ndarray:
        """Rows in id order for a re-merge: the stored raw rows (packed bits
        for binary; a cosine corpus's rows un-normalized, as f32), else the
        decoded codes (faiss's reconstruct-based re-add)."""
        if self._is_binary():
            return self._sorted_payload["bits"][self._pos_of_row]
        if "data" in self._sorted_payload:
            if self._metric == M.COSINE and self._norms_raw is not None:
                return self._payload_f32("data", self._pos_of_row) * self._norms_raw[:, None]
            return self._sorted_payload["data"][self._pos_of_row]
        nb_pad = len(self._row_ids)
        dec = np.concatenate(
            [self._decode_sorted_block(s, min(s + FULL_SORT_ROWS, nb_pad)) for s in range(0, nb_pad, FULL_SORT_ROWS)]
        )
        return dec[self._pos_of_row]

    def _decode_sorted_block(self, s: int, e: int) -> np.ndarray:
        """f32 rows at sorted positions [s, e) on the host, decoded as the
        reference decodes them for a re-merge (the raw refine rows where
        there are some)."""
        if self._refine_cfg == "raw" and "refine" in self._sorted_payload:
            return self._payload_f32("refine", slice(s, e))
        if self._kind == "raw":
            if self._is_binary():
                return D.unpack_bits_host(self._sorted_payload["bits"][s:e], self._dim).astype(np.float32)
            return self._payload_f32("data", slice(s, e))
        lists = np.clip(np.searchsorted(self._offsets, np.arange(s, e), side="right") - 1, 0, self._nlist - 1)
        if self._kind == "pq":
            codes = self._sorted_payload["codes"][s:e]
            books = self._pq.codebooks
            dec = np.concatenate([books[j][codes[:, j]] for j in range(books.shape[0])], axis=1)
            if self._opq_rot is not None:  # the codes are in the rotated frame
                dec = dec @ self._opq_rot
            return dec + self._centroids[lists]
        if self._kind == "sq":
            codec = self._sq
            if codec.sq_type in ("FP16", "BF16"):
                return self._payload_f32("codes", slice(s, e))
            codes = self._sorted_payload["codes"][s:e]
            if codec.sq_type == "SQ4":
                lo, hi = (codes & 0xF).astype(np.float32), (codes >> 4).astype(np.float32)
                q = np.stack([lo, hi], axis=-1).reshape(codes.shape[0], -1)[:, : codec.dim]
            else:
                q = codes.astype(np.float32)
            return codec.vmin + (q + 0.5) / codec.levels * codec.vdiff
        signs = D.unpack_bits_host(self._sorted_payload["signs_packed"][s:e], self._dim).astype(np.float32) * 2.0 - 1.0
        r = self._sorted_payload["r_norm"][s:e].astype(np.float32)
        # the rotated residual is sign / sqrt(d) * r_norm, un-rotated into data space
        return self._centroids[lists] + ((signs / np.sqrt(self._dim)) * r[:, None]) @ self._rbq.rotation

    def _build_storage(self, x_in: np.ndarray) -> None:
        x = self._prep_rows(x_in)
        nb = x.shape[0]
        cache = self._assign_cache
        if cache is not None and cache[0] == nb and cache[1] == float(x[:: max(nb // 7, 1), 0].sum()):
            assign = cache[2]
        else:
            assign = assign_rows(x, self._centroids)
        self._assign_cache = None
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=self._nlist).astype(np.int64)
        self._count = nb
        self._lengths = counts
        # large corpora: each list padded to a LIST_ALIGN multiple, so every
        # scan block is one aligned slice (the scan kernels need it)
        align_min = int(os.environ.get("KNOWHERE_IVF_ALIGN_MIN", 32768))
        pad_counts = (counts + LIST_ALIGN - 1) // LIST_ALIGN * LIST_ALIGN if nb >= align_min else counts
        self._offsets = np.zeros(self._nlist + 1, dtype=np.int64)
        np.cumsum(pad_counts, out=self._offsets[1:])
        nb_pad = int(self._offsets[-1])
        true_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        dst = np.arange(nb, dtype=np.int64) + np.repeat(self._offsets[:-1] - true_starts, counts)
        self._row_ids = np.full(nb_pad, -1, dtype=np.int64)
        self._row_ids[dst] = order
        self._pos_of_row = np.empty(nb, dtype=np.int64)
        self._pos_of_row[order] = dst

        def place(a_sorted: np.ndarray, fill=0) -> np.ndarray:
            """Scatter unpadded sorted rows into the aligned layout."""
            if nb_pad == nb:
                return a_sorted
            out = np.full((nb_pad, *a_sorted.shape[1:]), fill, a_sorted.dtype)
            out[dst] = a_sorted
            return out

        x_sorted = x[order]
        if self._is_binary():
            self._sorted_payload = {"bits": place(np.packbits(x_sorted.astype(np.uint8), axis=1, bitorder="little"))}
        elif self._kind == "raw":
            # typed corpora keep their width; a cosine corpus stores its
            # normalized rows (in bf16 when typed) and the norms
            typed = self.data_type in _TYPED
            if self._metric != M.COSINE:
                raw_sorted = self._native(x_in)[order] if typed else np.asarray(x_in).astype(np.float32)[order]
            else:
                raw_sorted = bf16_bits(x_sorted) if typed else x_sorted
                self._norms_raw = np.linalg.norm(as_f32(x_in), axis=1).astype(np.float32)
            self._sorted_payload = {"data": place(raw_sorted)}
        elif self._kind == "sq":
            self._sorted_payload = {"codes": place(Q.sq_encode(self._sq, x_sorted))}
        elif self._is_rabitq():
            packed, r_norm, t = Q.rabitq_encode(self._rbq, x, self._centroids, assign)
            self._sorted_payload = {
                "signs_packed": place(packed[order]),
                "r_norm": place(r_norm[order]),
                "t": place(t[order], fill=1),
            }
        else:
            resid = x - self._centroids[assign]
            if self._opq_rot is not None:
                resid = resid @ self._opq_rot.T
            self._sorted_payload = {"codes": place(Q.pq_encode(self._pq, resid)[order])}
        # refine payload, in padded sorted order so positions line up
        if self._refine_cfg == "raw":
            self._sorted_payload["refine"] = place(x_sorted)
        elif self._refine_cfg == "fp16":
            self._sorted_payload["refine"] = place(x_sorted.astype(np.float16))
        elif self._refine_cfg == "bf16":
            self._sorted_payload["refine"] = place(bf16_bits(x_sorted))
        elif self._refine_cfg == "sq8":
            codes, vmin, vdiff = sq8_encode(x_sorted)
            self._sorted_payload.update(refine=place(codes), refine_vmin=vmin, refine_vdiff=vdiff)
        self._upload()

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Install the state an IVF node serializes (the arrays and meta of
        knowhere_tpu's IvfIndexNode.Serialize) and upload it; a "bfloat16"
        section arrives as its uint16 bit patterns."""
        if meta.get("variant") != self.VARIANT:
            raise KnowhereException(
                f"blob holds IVF variant {meta.get('variant')!r}", Status.invalid_serialized_index_type
            )
        self._metric = meta["metric"]
        self._dim = int(meta["dim"])
        self._nlist = int(meta["nlist"])
        self.data_type = meta.get("data_type", "fp32")
        self._refine_cfg = meta.get("refine_cfg")
        self._centroids = np.asarray(arrays["centroids"], dtype=np.float32)
        self._row_ids = np.asarray(arrays["row_ids"], dtype=np.int64)
        self._offsets = np.asarray(arrays["offsets"], dtype=np.int64)
        valid = self._row_ids >= 0
        self._count = int(valid.sum())
        self._pending_rows, self._pending_count = [], 0
        self._pos_of_row = np.empty(self._count, dtype=np.int64)
        self._pos_of_row[self._row_ids[valid]] = np.nonzero(valid)[0]
        if "lengths" in arrays:
            self._lengths = np.asarray(arrays["lengths"], dtype=np.int64)
        else:  # pre-alignment blob: storage was compact
            csum = np.concatenate([[0], np.cumsum(valid)])
            self._lengths = (csum[self._offsets[1:]] - csum[self._offsets[:-1]]).astype(np.int64)
        self._norms_raw = np.asarray(arrays["norms_raw"]) if "norms_raw" in arrays else None
        self._sorted_payload = {
            k_[len("payload_"):]: np.asarray(v) for k_, v in arrays.items() if k_.startswith("payload_")
        }
        if "pq_codebooks" in arrays:
            books = np.asarray(arrays["pq_codebooks"], dtype=np.float32)
            self._pq = Q.PQCodec(books, books.shape[0], int(meta["pq_nbits"]))
            rot = arrays.get("opq_rotation")
            self._opq_rot = None if rot is None else np.asarray(rot, dtype=np.float32)
        if "sq_type" in meta:
            self._sq = Q.SQCodec(
                meta["sq_type"],
                np.asarray(arrays["sq_vmin"]) if "sq_vmin" in arrays else None,
                np.asarray(arrays["sq_vdiff"]) if "sq_vdiff" in arrays else None,
                dim=self._dim,
            )
        if "rbq_rotation" in arrays:
            self._rbq = Q.RaBitQCodec(np.asarray(arrays["rbq_rotation"], dtype=np.float32), self._dim)
        self._trained = True
        self._upload()

    def _upload(self) -> None:
        """Host payloads -> device store, with B_SLACK zero rows at the end and
        features zero-padded to a 128 multiple when d > 64 (leaves L2/IP and
        the binary metrics unchanged and lets the scan kernels take the
        store; SQ4's packed codes keep the true width)."""
        d = self._dim
        sq4 = self._sq is not None and self._sq.sq_type == "SQ4"
        self._d_dev = -(-d // 128) * 128 if d > 64 and d % 128 != 0 and not sq4 else d
        dcol = self._d_dev - d

        def cpad(a: np.ndarray) -> np.ndarray:
            return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, dcol)]) if dcol else a

        self._store = {
            "centroids": to_device(cpad(self._centroids)),
            "offsets_dev": to_device(np.asarray(self._offsets, dtype=np.int32)),
            "lens_dev": to_device(np.asarray(self._lengths, dtype=np.int32)),
        }
        if self._kind == "raw":
            self._upload_raw()
        elif self._kind == "sq":
            self._upload_sq(cpad)
        elif self._is_rabitq():
            self._upload_rabitq(cpad)
        else:
            self._upload_pq(cpad)
        self._refine_store = None
        if self._refine_cfg and "refine" in self._sorted_payload:
            rows = rows_to_device(_pad_cols(self._sorted_payload["refine"], self._d_dev))
            if self._refine_cfg == "sq8":
                self._refine_store = RefineStore(
                    "sq8", rows,
                    to_device(cpad(self._sorted_payload["refine_vmin"])),
                    to_device(cpad(self._sorted_payload["refine_vdiff"])),
                )
            else:
                self._refine_store = RefineStore("raw", rows)
        # the device store is the search structure; the host payloads (read
        # by Serialize, GetVectorByIds, CalcDistByIDs, the covering pass and
        # the epoch merges) become disk-backed memmaps, as in the reference
        spill_dict(self._sorted_payload)

    def _upload_raw(self) -> None:
        """Raw store: the rows at their width (f32; bf16 for bf16 and fp16
        corpora, fp16 rounded to bf16 as the reference stores it; int8;
        {0,1} f32 planes for binary) and their norms, filled in row chunks
        into one zeroed buffer; the int8 sidecar for f32 rows."""
        d = self._dim
        if self._is_binary():
            src, nb_rows = self._sorted_payload["bits"], self._sorted_payload["bits"].shape[0]
        else:
            src = self._sorted_payload["data"]
            nb_rows = src.shape[0]
        bf16 = src.dtype in (np.uint16, np.float16)
        dtype = np.uint16 if bf16 else (np.float32 if self._is_binary() else src.dtype)
        buf = np.zeros((nb_rows + B_SLACK, self._d_dev), dtype)
        norms = np.zeros(nb_rows + B_SLACK, np.float32)
        for i0, i1 in _row_chunks(nb_rows, d * 4):
            if self._is_binary():
                c = D.unpack_bits_host(src[i0:i1], d).astype(np.float32)
                buf[i0:i1, :d] = c
            elif bf16:
                bits = bf16_bits(src[i0:i1])
                buf[i0:i1, :d] = bits
                c = bf16_to_f32(bits)
            else:
                buf[i0:i1, :d] = src[i0:i1]
                c = np.asarray(src[i0:i1], dtype=np.float32)
            norms[i0:i1] = np.einsum("ij,ij->i", c, c, dtype=np.float64)
        self._store["data"] = rows_to_device(buf)
        self._store["norms"] = to_device(norms)
        if buf.dtype == np.float32 and not self._is_binary():
            self._build_int8_sidecar(src, self._d_dev - d)

    def _upload_pq(self, cpad) -> None:
        """PQ store in the ADC kernel's layout: row-major (nb_pad + slack, mb)
        uint8 codes, so a task reads one contiguous 512 * mb-byte slice (nib:
        ksub=16 and even m pack subspace j in the low nibble of byte j and
        j + m/2 in its high nibble); bf16 codebooks; the per-list bf16 CLUT
        (centroid/codebook cross terms of the residual L2 expansion, made in
        float64 as in the reference); f32 codebooks for the EXACT decode scan.
        Under OPQ the scan runs in the rotated frame: queries rotate by rot_t
        and the centroid terms use the rotated centroids (cent_scan), while
        the coarse probe and the refine stay in the original frame."""
        books = np.asarray(self._pq.codebooks, np.float32)  # (m, ksub, sub)
        m, ksub, sub = books.shape
        codes = self._sorted_payload["codes"]
        if ksub == 16 and m % 2 == 0:
            codes = codes[:, : m // 2] | (codes[:, m // 2 :] << 4)
        buf = np.zeros((codes.shape[0] + B_SLACK, codes.shape[1]), np.uint8)
        buf[: codes.shape[0]] = codes
        cents_scan = self._centroids
        if self._opq_rot is not None:
            cents_scan = (self._centroids @ self._opq_rot.T).astype(np.float32)
            dcol = self._d_dev - self._dim
            self._store["rot_t"] = to_device(np.pad(self._opq_rot.T, ((0, dcol), (0, dcol))))
            self._store["cent_scan"] = to_device(cpad(cents_scan))
        if self._is_l2_like():
            c3 = cents_scan.reshape(self._nlist, m, sub).astype(np.float64)
            b64 = books.astype(np.float64)
            clut = (2.0 * np.einsum("lms,mvs->lmv", c3, b64) + np.sum(b64**2, axis=-1)[None]).astype(np.float32)
        else:
            clut = np.zeros((self._nlist, m, ksub), np.float32)
        self._store.update(
            codes=to_device(buf),
            codebooks=to_device(books),
            books=to_device(books).to(torch.bfloat16),
            clut=to_device(clut.reshape(self._nlist, m * ksub)).to(torch.bfloat16),
        )

    def _upload_sq(self, cpad) -> None:
        """SQ store: codes column-padded (padded columns decode to 0 through
        zero vmin / vdiff; SQ4 keeps its packed width) plus slack rows; the
        grid's vmin / vdiff; for SQ8 the int8 sidecar."""
        t = self._sq.sq_type
        codes = self._sorted_payload["codes"]
        width = codes.shape[1] if t == "SQ4" else self._d_dev
        self._store["codes"] = rows_to_device(_pad_cols(codes, width, B_SLACK))
        self._sq_levels, self._sq_packed4 = 0, False
        if t in ("SQ4", "SQ6", "SQ8"):
            self._store["vmin"] = to_device(cpad(self._sq.vmin))
            self._store["vdiff"] = to_device(cpad(self._sq.vdiff))
            self._sq_levels, self._sq_packed4 = self._sq.levels, t == "SQ4"
            if t == "SQ8":
                self._build_sq8_int8_sidecar(cpad)

    def _upload_rabitq(self, cpad) -> None:
        """RaBitQ store: the sign bits repacked at the device width (d_dev / 8
        bytes a row; padded columns meet zero query residuals), r_norm and t
        per row (t pads with 1), the rotation zero-extended on both axes
        (rot_t) and the rotated centroids, computed on the host in f32."""
        nb_rows = self._sorted_payload["signs_packed"].shape[0]
        signs01 = D.unpack_bits_host(self._sorted_payload["signs_packed"], self._dim)
        signs = np.zeros((nb_rows + B_SLACK, self._d_dev // 8), np.uint8)
        signs[:nb_rows] = np.packbits(cpad(signs01), axis=1, bitorder="little")
        r_norm = np.zeros(nb_rows + B_SLACK, np.float32)
        r_norm[:nb_rows] = self._sorted_payload["r_norm"]
        t = np.ones(nb_rows + B_SLACK, np.float32)
        t[:nb_rows] = self._sorted_payload["t"]
        dcol = self._d_dev - self._dim
        rot = self._rbq.rotation.astype(np.float32)
        self._store.update(
            signs=to_device(signs),
            r_norm=to_device(r_norm),
            t=to_device(t),
            rot_t=to_device(np.pad(rot.T, ((0, dcol), (0, dcol)))),
            centroids_rot=to_device(cpad((self._centroids @ rot.T).astype(np.float32))),
        )

    def _build_sq8_int8_sidecar(self, cpad) -> None:
        """int8 scan sidecar for SQ8: the grid x = vmin + (c + 0.5) * s with
        s = vdiff / levels factors into the raw sidecar's estimator with the
        codes c - 128 (the kernel recentres the u8 codes in place), the query
        transform scale = s and mu = 0; the norms are the exact f64 norms of
        the decoded rows. Derived, never serialized, and rebuilt
        bit-identically to the reference."""
        if os.environ.get("KNOWHERE_DISABLE_INT8_SCAN") == "1":
            return
        offs = self._offsets
        if offs is None or int(offs[-1]) == 0 or not (offs % LIST_ALIGN == 0).all() or self._d_dev % 128 != 0:
            return
        nb_pad = int(offs[-1])
        codes = np.asarray(self._sorted_payload["codes"][:nb_pad])
        s = self._sq.vdiff.astype(np.float32) / float(self._sq.levels)
        nrm = np.empty(nb_pad, np.float32)
        ch = max(1, (256 << 20) // max(codes.shape[1] * 4, 1))
        for i0 in range(0, nb_pad, ch):
            i1 = min(i0 + ch, nb_pad)
            dec = self._sq.vmin[None, :] + (codes[i0:i1].astype(np.float32) + 0.5) * s[None, :]
            nrm[i0:i1] = np.einsum("ij,ij->i", dec, dec, dtype=np.float64)
        self._store["i8_nrm"] = to_device(nrm)
        self._store["i8_scale"] = to_device(cpad(s.astype(np.float32)))
        self._store["i8_mu"] = to_device(np.zeros(self._d_dev, np.float32))

    def _build_int8_sidecar(self, data: np.ndarray, dcol: int) -> None:
        """int8 scan sidecar for the raw f32 store: per-dim symmetric codes
        (centred for L2) and exact centred norms. Derived, never serialized,
        and rebuilt bit-identically to the reference (multiply by the f32
        reciprocal, np.rint)."""
        if os.environ.get("KNOWHERE_DISABLE_INT8_SCAN") == "1":
            return
        offs = self._offsets
        if offs is None or int(offs[-1]) == 0 or not (offs % LIST_ALIGN == 0).all() or self._d_dev % 128 != 0:
            return
        nb_pad = int(offs[-1])
        x = data[:nb_pad]
        d = x.shape[1]
        n_true = int(np.asarray(self._lengths).sum())
        ch = max(1, (256 << 20) // max(d * 4, 1))
        if self._is_l2_like() and n_true > 0:
            acc = np.zeros(d, np.float64)
            for i0 in range(0, nb_pad, ch):  # pad rows are zeros
                acc += np.asarray(x[i0 : i0 + ch], np.float32).sum(0, dtype=np.float64)
            mu = (acc / n_true).astype(np.float32)
        else:
            mu = np.zeros(d, np.float32)
        amax = np.zeros(d, np.float32)
        for i0 in range(0, nb_pad, ch):
            c = np.asarray(x[i0 : i0 + ch], np.float32) - mu
            np.abs(c, out=c)
            np.maximum(amax, c.max(0), out=amax)
        s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
        inv = (1.0 / s).astype(np.float32)
        codes = np.zeros((nb_pad + B_SLACK, self._d_dev), np.int8)
        nrm = np.empty(nb_pad, np.float32)
        for i0 in range(0, nb_pad, ch):
            i1 = min(i0 + ch, nb_pad)
            c = np.asarray(x[i0:i1], np.float32) - mu
            nrm[i0:i1] = np.einsum("ij,ij->i", c, c, dtype=np.float64)
            c *= inv
            np.rint(c, out=c)
            np.clip(c, -127, 127, out=c)
            codes[i0:i1, :d] = c.astype(np.int8)
        self._store["data_i8"] = to_device(codes)
        self._store["i8_nrm"] = to_device(nrm)
        self._store["i8_scale"] = to_device(np.pad(s, (0, dcol)))
        self._store["i8_mu"] = to_device(np.pad(mu, (0, dcol)))

    # --- Search ---------------------------------------------------------------
    def _pad_q_host(self, xq: np.ndarray) -> np.ndarray:
        """Row ladder + feature zero-padding to the device width."""
        q = pad_rows_ladder(xq)
        if q.shape[1] != self._d_dev:
            q = np.pad(q, ((0, 0), (0, self._d_dev - q.shape[1])))
        return q

    def _keep_sorted_mask(self, bitset: BitsetView) -> Optional[torch.Tensor]:
        if bitset.empty_view():
            return None
        keep = bitset.host_mask(self.Count())
        rid = self._row_ids
        keep_sorted = np.zeros(len(rid) + B_SLACK, dtype=bool)
        valid = rid >= 0
        keep_sorted[: len(rid)][valid] = keep[rid[valid]]
        return to_device(keep_sorted)

    def _scan_plan(self, k: int, refine_k: int, reorder_k: Optional[int] = None) -> _Plan:
        """The reference's precision strategy: EXACT scans full f32; binary
        rows and the quantized codes scan bf16; raw f32 rows scan the
        three-pass product at FAST, one bf16 pass plus an exact rerank of a
        widened pool at BF16; below EXACT a raw or SQ8 store with an int8
        sidecar ranks a widened pool with the int8 scan, re-ranked from the
        stored rows unless a refine store re-scores it."""
        gp = get_distance_precision()
        nb = len(self._row_ids)
        k_coarse = k
        if self._refine_store is not None:
            k_coarse = max(k, reorder_k) if reorder_k is not None else max(k, k * max(1, refine_k))
        if gp == DistancePrecision.EXACT:
            prec = "exact"
        elif self._is_binary() or self._kind != "raw" or gp == DistancePrecision.BF16:
            prec = "bf16"
        else:
            prec = "fast"
        two_stage = gp == DistancePrecision.BF16 and self._kind == "raw" and not self._is_binary()
        two_stage = two_stage and self._refine_store is None
        k_scan = min(max(4 * k_coarse, 32), max(nb, 1)) if two_stage else k_coarse
        if gp != DistancePrecision.EXACT and not self._is_jaccard() and "i8_nrm" in self._store:
            # int8 candidates (raw or SQ8), re-ranked from the raw rows or by
            # SQ8 decode unless a refine store re-scores them
            prec, two_stage = "int8", self._refine_store is None
            k_scan = min(max(4 * k_coarse, 48), max(nb, 1))
        route, prec = scan_route(
            self._store, self._d_dev, k_scan, self._offsets, prec, self._sq_levels, self._sq_packed4,
            self._is_jaccard(),
        )
        return _Plan(route, prec, two_stage, k_scan, k_coarse)

    def _rerank(self, plan: _Plan, k: int) -> Optional[Tuple[RefineStore, int]]:
        """(store, k kept) of the pass that re-scores the scan's pool, or None
        when the scan's scores are final."""
        if plan.two_stage:
            if self._kind == "sq":  # exact under the stored values: SQ8 decode
                st = self._store
                return RefineStore("sq8", st["codes"], st["vmin"], st["vdiff"]), plan.k_coarse
            return RefineStore("raw", self._store["data"]), plan.k_coarse
        if self._refine_store is not None:
            return self._refine_store, k
        return None

    def _scan_blocks(self, plan: _Plan, nprobe: int, nq: int, rerank):
        """(query row ranges or None for one block, pool width, refine chunk)
        of one scan. The merged pool holds its candidates in its first
        ``width`` columns, so the rerank gathers no more. The rerank
        re-scores ``chunk`` queries a step (_refine_chunk). A batch whose
        merge pool would pass SCAN_BLOCK_BYTES scans its first nq rows in
        blocks of whole chunks (at least one), so each query is re-scored in
        the same step as in one block, and keeps its bits. On the ADC route
        a block's table stays under QTABLE_BYTES as well."""
        pool = pool_bound(plan.route, self._lengths, nprobe, plan.k_scan)
        width = min(plan.k_scan, pool)
        pool_bytes = pool * POOL_ENTRY_BYTES
        chunk = 1 if rerank is None else _refine_chunk(width * rerank[0].row_bytes(), pool_bytes)
        nqb = SCAN_BLOCK_BYTES // pool_bytes
        if plan.route == "adc":
            m, ksub, _ = self._store["books"].shape
            nqb = min(nqb, QTABLE_BYTES // (m * ksub * 4))
        nqb = max(1, nqb // chunk) * chunk
        if nqb >= nq:
            return None, width, chunk
        return [(b, min(b + nqb, nq)) for b in range(0, nq, nqb)], width, chunk

    def _run_scan(self, q_pad_dev, probes, plan: _Plan, keep_sorted, k: int, nq: int):
        """Scan (in the OPQ frame for IVF_PQ) one padded query batch and
        re-rank its first nq rows, in query blocks when the merge pool is
        wide (_scan_blocks): (scores or dists, positions, "score" | "dist")
        of those nq rows, on the device."""
        with tracing.span("ivf.scan"):
            is_l2 = self._is_l2_like()
            q_scan = q_pad_dev @ self._store["rot_t"] if "rot_t" in self._store else q_pad_dev
            nprobe = self._nlist if probes is None else probes.shape[1]
            rerank = self._rerank(plan, k)
            blocks, width, chunk = self._scan_blocks(plan, nprobe, nq, rerank)
            outs = []
            for b0, b1 in blocks or [(0, q_pad_dev.shape[0])]:  # one block: the whole padded batch
                s, p = ivf_scan_search(
                    q_scan[b0:b1], self._store, None if probes is None else probes[b0:b1], self._offsets,
                    plan.k_scan, is_l2, keep_sorted=keep_sorted, prec=plan.prec, list_lengths=self._lengths,
                    sq_levels=self._sq_levels, sq_packed4=self._sq_packed4, route=plan.route,
                    is_jaccard=self._is_jaccard(),
                )
                n = min(b1, nq) - b0
                if rerank is not None:
                    with tracing.span("ivf.refine"):
                        s, p = self._rescore(q_pad_dev[b0 : b0 + n], p[:n, :width], rerank, chunk, is_l2)
                outs.append((s[:n], p[:n]))
            mode = "score" if rerank is None else "dist"
            if len(outs) == 1:
                return (*outs[0], mode)
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), mode

    @staticmethod
    def _rescore(q, cand, rerank, chunk: int, is_l2: bool):
        store, k_out = rerank
        d_r, p_r = refine_topk_device(q, store, cand, k_out, is_l2, chunk)
        if d_r.shape[1] < k_out:  # a pool narrower than k_out: the refine's own padding
            pad = (0, k_out - d_r.shape[1])
            d_r = torch.nn.functional.pad(d_r, pad, value=float("inf") if is_l2 else -float("inf"))
            p_r = torch.nn.functional.pad(p_r, pad, value=-1)
        return d_r, p_r

    def _rescan_subset(self, xq_sub: np.ndarray, probes_sub: np.ndarray, plan: _Plan, keep_sorted, k: int):
        """ensure_topk_full retry for a query subset with host probes."""
        n_sub = xq_sub.shape[0]
        q_pad = self._pad_q_host(xq_sub)
        fill = np.full((q_pad.shape[0] - n_sub, probes_sub.shape[1]), -1, np.int32)
        s, p, _ = self._run_scan(to_device(q_pad), np.concatenate([probes_sub, fill]), plan, keep_sorted, k, n_sub)
        with tracing.span("ivf.readback", wait=True):
            return s[:n_sub].cpu().numpy(), p[:n_sub].cpu().numpy().astype(np.int64)

    def _search_batch(
        self, xq: np.ndarray, k: int, nprobe: int, keep_sorted, n_valid: int,
        ensure_topk_full: bool, q_pad_dev: torch.Tensor, refine_k: int = 1, reorder_k: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (nq,k) native convention, ids (nq,k) original rows)."""
        from ..comp import check_current_cancellation

        check_current_cancellation()
        nq = xq.shape[0]
        is_l2 = self._is_l2_like()
        nb = len(self._row_ids)
        with tracing.span("ivf.probe"):
            plan = self._scan_plan(k, refine_k, reorder_k)
            nprobe_cur = min(max(1, nprobe), self._nlist)
            nq_pad = q_pad_dev.shape[0]
            if nprobe_cur >= self._nlist:
                probes = None  # full probe: the deterministic full-scan layout
            elif plan.route != "plain" or nq * self._nlist * max(self._dim, 1) > 1 << 24:
                # a kernel path (the reference's fused path) keeps the probe on the device
                probes = coarse_probe(q_pad_dev, self._store["centroids"], nprobe=nprobe_cur, is_l2=is_l2)
                # padded query rows would probe real lists: mask them out
                row = torch.arange(nq_pad, device=probes.device)[:, None]
                probes = torch.where(row < nq, probes, torch.full_like(probes, -1))
            else:
                probes = coarse_probe_host(xq, self._centroids, nprobe_cur, is_l2)
                probes = np.concatenate([probes, np.full((nq_pad - nq, probes.shape[1]), -1, np.int32)])
        s, p, mode = self._run_scan(q_pad_dev, probes, plan, keep_sorted, k, nq)
        with tracing.span("ivf.readback", wait=True):
            best_s = s[:nq].cpu().numpy()
            best_p = p[:nq].cpu().numpy().astype(np.int64)

        # ensure_topk_full: re-probe only the short queries, nprobe x4 a round
        if ensure_topk_full and nprobe_cur < self._nlist:
            with tracing.span("ivf.topk_full"):
                want = min(best_p.shape[1], n_valid)
                while True:
                    check_current_cancellation()
                    unfilled = (best_p >= 0).sum(axis=1) < want
                    if not unfilled.any() or nprobe_cur >= self._nlist:
                        break
                    active = np.nonzero(unfilled)[0]
                    nprobe_cur = min(self._nlist, nprobe_cur * 4)
                    if len(active) * self._nlist <= 1 << 20:
                        probes_act = coarse_probe_host(xq[active], self._centroids, nprobe_cur, is_l2)
                    else:
                        q_act = to_device(self._pad_q_host(xq[active]))[: len(active)]
                        probes_act = coarse_probe(
                            q_act, self._store["centroids"], nprobe=nprobe_cur, is_l2=is_l2
                        ).cpu().numpy()
                    best_s[active], best_p[active] = self._rescan_subset(
                        xq[active], probes_act, plan, keep_sorted, k
                    )

        with tracing.span("ivf.result"):
            if mode == "dist":
                dists = best_s
            elif self._is_rabitq():  # the estimator's score is the negated distance for L2
                dists = -best_s if is_l2 else best_s
            elif self._is_jaccard():  # the scan scores the similarity
                dists = 1.0 - best_s
            elif is_l2:
                qsq = np.sum(xq.astype(np.float64) ** 2, axis=1).astype(np.float32)
                dists = qsq[:, None] - best_s
            else:
                dists = best_s
            dists = np.where(best_p >= 0, dists, np.float32(np.inf if is_l2 else -np.inf))
            k_cut = min(k, dists.shape[1])
            dists, best_p = dists[:, :k_cut], best_p[:, :k_cut]
            if k_cut < k:  # tiny index: fewer candidates than k
                fillv = np.float32(np.inf if is_l2 else -np.inf)
                dists = np.pad(dists, ((0, 0), (0, k - k_cut)), constant_values=fillv)
                best_p = np.pad(best_p, ((0, 0), (0, k - k_cut)), constant_values=-1)
            ids = np.where(best_p >= 0, self._row_ids[np.clip(best_p, 0, nb - 1)], -1)
            return dists, ids

    def _queries(self, dataset: DataSet) -> Tuple[np.ndarray, torch.Tensor]:
        """(compute rows on the host, the padded batch on the device, cached
        on the dataset)."""
        xq = self._prep_rows(np.asarray(dataset.tensor))
        q_pad_dev = dataset.cached_device(
            f"ivf_qpad:{self._metric}:{self._d_dev}:{get_device()}",
            lambda: to_device(self._pad_q_host(xq)),
        )
        return xq, q_pad_dev

    def _n_valid(self, bitset: BitsetView) -> int:
        return self.Count() - (bitset.count() if not bitset.empty_view() else 0)

    def _epoch_snapshot(self) -> "IvfIndexNode":
        """A point-in-time view for a search outside the lock: every mutator
        rebinds whole fields under _lock, so a shallow copy of the fields
        taken under it is one consistent epoch."""
        snap = object.__new__(type(self))
        snap.__dict__.update(self.__dict__)
        return snap

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        with self._lock:
            if self._row_ids is None:
                return expected.Err(Status.empty_index, "index not built")
            metric = normalize_metric(cfg.metric_type)
            if metric != self._metric:
                return expected.Err(
                    Status.invalid_metric_type, f"index built with {self._metric}, searched with {metric}"
                )
            snap = self._epoch_snapshot()
        # the scan runs outside the lock on the snapshot: a concurrent Add
        # never waits for it, and its epoch swap changes nothing under it
        with tracing.span("ivf.queries"):
            xq, q_pad_dev = snap._queries(dataset)
            keep_sorted = snap._keep_sorted_mask(bitset)
        dists, ids = snap._search_batch(
            xq, cfg.k, int(cfg.get("nprobe", 8)), keep_sorted, snap._n_valid(bitset),
            bool(cfg.get("ensure_topk_full", True)), q_pad_dev, int(cfg.get("refine_k", 1) or 1),
            cfg.get("reorder_k"),
        )
        with tracing.span("ivf.result"):
            if snap._pending_count:
                dists, ids = snap._merge_with_pending(xq, cfg.k, dists, ids, bitset)
            return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))

    def _merge_with_pending(self, xq, k: int, dists, ids, bitset: BitsetView):
        """The search's (dists, ids) merged with an exact scan of the pending
        rows (ops/topk.knn_device; HAMMING as L2 over {0,1} rows), by a
        stable sort on the host: the stored rows first among equals."""
        pend = self._prep_rows(_concat_rows(self._pending_rows))
        base_count = self._count
        mask = None
        if not bitset.empty_view():
            mask = to_device(bitset.host_mask(base_count + pend.shape[0])[base_count:])
        internal = self._internal_metric()
        p_d, p_i = T.knn_device(
            to_device(xq), to_device(pend), min(k, pend.shape[0]), M.L2 if internal == M.HAMMING else internal,
            mask=mask,
        )
        p_d, p_i = p_d.cpu().numpy(), p_i.cpu().numpy()
        p_i = np.where(p_i >= 0, p_i + base_count, -1)
        larger = self._larger_is_closer()
        cat_d = np.concatenate([dists, p_d], axis=1)
        cat_i = np.concatenate([ids, p_i], axis=1)
        key = np.where(cat_i >= 0, cat_d, -np.inf if larger else np.inf)
        order = np.argsort(-key if larger else key, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(cat_d, order, 1), np.take_along_axis(cat_i, order, 1)

    # --- the covering exact pass (iterator / range-search completion) --------
    def _decode_rows(self, s: int, e: int) -> torch.Tensor:
        """Rows at sorted positions [s, e), true width, on the device: the
        values the scans score against (the raw refine rows when there are
        some; PQ, SQ and RaBitQ decode their codes). f32, except RaBitQ's
        decode, which the reference computes in float64. Typed raw rows are
        read from the host payload, as the reference reads them (its device
        copy of an fp16 corpus is in bf16)."""
        st, d = self._store, self._dim
        if self._refine_cfg == "raw" and self._refine_store is not None:
            return self._refine_store.data[s:e, :d].float()
        if self._kind == "raw":
            if st["data"].dtype != torch.float32:
                return to_device(self._payload_f32("data", slice(s, e)))
            return st["data"][s:e, :d]
        if self._kind == "sq":
            codes = st["codes"][s:e]
            if self._sq.sq_type in ("FP16", "BF16"):
                return codes[:, :d].float()
            if self._sq_packed4:
                q = torch.stack([codes & 0xF, codes >> 4], dim=-1).reshape(codes.shape[0], -1)[:, :d].float()
            else:
                q = codes[:, :d].float()
            return st["vmin"][:d] + (q + 0.5) / self._sq_levels * st["vdiff"][:d]
        pos = torch.arange(s, e, device=st["offsets_dev"].device, dtype=torch.int32)
        lists = (torch.searchsorted(st["offsets_dev"], pos, right=True) - 1).clamp(0, self._nlist - 1)
        cents = st["centroids"][:, :d][lists]
        if self._kind == "pq":
            books = st["codebooks"]  # (m, ksub, sub) f32
            m = books.shape[0]
            codes = unpack_codes(st["codes"][s:e], m, _nib(st))
            dec = books[torch.arange(m, device=books.device)[None, :], codes].reshape(e - s, -1)
            if self._opq_rot is not None:  # the codes are in the rotated frame
                dec = dec @ st["rot_t"][:d, :d].T
            return dec + cents
        # RaBitQ: the rotated residual is sign / sqrt(d) * r_norm, un-rotated
        signs = unpack_signs(st["signs"][s:e], d).double()
        resid = (signs / math.sqrt(d)) * st["r_norm"][s:e].double()[:, None]
        return cents.double() + resid @ st["rot_t"][:d, :d].T.double()

    def _full_sorted(self, xq: np.ndarray, bitset: BitsetView) -> Tuple[np.ndarray, np.ndarray]:
        """The covering exact pass over every stored row: (dists, ids), each
        (nq, n_valid) on the host, best first in the native convention. The
        distances are float64 over the decoded rows (_decode_rows), rounded
        to f32, then stably sorted in storage order, as the reference's host
        pass; here on the device, FULL_SORT_QUERIES queries and
        FULL_SORT_ROWS rows a step."""
        rid = self._row_ids
        nq, nb_pad = xq.shape[0], len(rid)
        is_l2 = self._is_l2_like()
        larger = self._larger_is_closer()
        invalid = rid < 0
        if not bitset.empty_view():
            invalid = invalid | ~bitset.host_mask(self.Count())[np.clip(rid, 0, None)]
        n_valid = int((~invalid).sum())
        invalid_dev, rid_dev = to_device(invalid), to_device(rid)
        out_d = np.empty((nq, n_valid), np.float32)
        out_i = np.empty((nq, n_valid), np.int64)
        for q0 in range(0, nq, FULL_SORT_QUERIES):
            q64 = to_device(np.asarray(xq[q0 : q0 + FULL_SORT_QUERIES], np.float64))
            dists = torch.empty((q64.shape[0], nb_pad), dtype=torch.float32, device=q64.device)
            for s in range(0, nb_pad, FULL_SORT_ROWS):
                e = min(s + FULL_SORT_ROWS, nb_pad)
                blk = self._decode_rows(s, e).double()
                dots = q64 @ blk.T
                if self._is_jaccard():
                    union = q64.sum(1)[:, None] + blk.sum(1)[None, :] - dots
                    dots = 1.0 - dots / torch.clamp(union, min=1e-12)
                elif is_l2:
                    dots = (q64**2).sum(1)[:, None] - 2 * dots + (blk**2).sum(1)[None, :]
                dists[:, s:e] = dots.float()
            dists.masked_fill_(invalid_dev[None, :], -float("inf") if larger else float("inf"))
            order = torch.sort(-dists if larger else dists, dim=1, stable=True).indices[:, :n_valid]
            out_d[q0 : q0 + FULL_SORT_QUERIES] = torch.gather(dists, 1, order).cpu().numpy()
            out_i[q0 : q0 + FULL_SORT_QUERIES] = rid_dev[order].cpu().numpy()
        return out_d, out_i

    # --- RangeSearch, AnnIterator -------------------------------------------
    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        """Expanding-k searches over the probed lists until every query's
        frontier leaves the radius (k x4 a round from 256; nprobe, from at
        least 8, x4 whenever a frontier runs short, since that means the
        probed lists ran dry; max_empty_result_buckets rounds that add
        nothing end it); queries still in range at DEVICE_K_MAX are
        completed by the covering exact pass. Then the window, and
        range_search_k."""
        with self._writer_lock, self._lock:
            if self._row_ids is None:
                return expected.Err(Status.empty_index, "index not built")
            self._merge_pending()
            return self._range_search(dataset, cfg, bitset)

    def _range_search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        from ..comp import check_current_cancellation

        xq, q_pad_dev = self._queries(dataset)
        nq = xq.shape[0]
        radius = cfg.get("radius", 0.0)
        range_filter = cfg.get("range_filter", float("inf"))
        two_sided = np.isfinite(range_filter)
        larger = self._larger_is_closer()
        keep_sorted = self._keep_sorted_mask(bitset)
        n_valid = self._n_valid(bitset)
        nprobe = min(max(int(cfg.get("nprobe", 8) or 8), 8), self._nlist)
        max_empty = int(cfg.get("max_empty_result_buckets", 2) or 2)

        k_cur = min(256, max(1, n_valid))
        cap = min(n_valid, _index_node.DEVICE_K_MAX)
        empty_rounds = 0
        while True:
            check_current_cancellation()
            dists, ids = self._search_batch(xq, k_cur, nprobe, keep_sorted, n_valid, False, q_pad_dev, 1)
            filled = ids[:, -1] >= 0
            if (~filled).any() and nprobe < self._nlist:
                nprobe = min(self._nlist, nprobe * 4)
                continue
            if k_cur >= cap:
                break
            frontier = dists[:, -1]
            still_in = ((frontier > radius) if larger else (frontier < radius)) & filled
            if not still_in.any():
                empty_rounds += 1
                if empty_rounds > max_empty:
                    break
            else:
                empty_rounds = 0
            k_cur = min(cap, k_cur * 4)

        if cap < n_valid:  # queries still growing at the device cap: the covering pass
            frontier = dists[:, -1]
            frontier_in = (frontier > radius) if larger else (frontier < radius)
            needy = ((ids >= 0).sum(axis=1) < n_valid) & (frontier_in | (ids[:, -1] < 0))
            if needy.any():
                act = np.nonzero(needy)[0]
                pad = ((0, 0), (0, n_valid - dists.shape[1]))
                dists = np.pad(dists, pad, constant_values=np.float32(-np.inf if larger else np.inf))
                ids = np.pad(ids, pad, constant_values=-1)
                for s in range(0, len(act), FULL_SORT_QUERIES):
                    sub = act[s : s + FULL_SORT_QUERIES]
                    dists[sub], ids[sub] = self._full_sorted(xq[sub], bitset)

        keep = (ids >= 0) & R.in_window(dists, radius, range_filter, larger, two_sided)
        rsk = cfg.get("range_search_k", -1)
        if rsk is not None and rsk >= 0:
            keep &= np.cumsum(keep, axis=1) <= rsk
        lims = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(keep.sum(axis=1), out=lims[1:])
        return expected.Ok(GenRangeResultDataSet(nq, ids[keep], dists[keep], lims))

    def AnnIterator(
        self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True
    ) -> "expected[List]":
        """Resumable rounds (the reference's workspace iterator): round r
        searches with nprobe0 * 4^r lists and k0 * 4^r results, then one
        covering exact pass once k passes DEVICE_K_MAX. The pending rows are
        merged first; the rounds scan that epoch."""
        with self._writer_lock, self._lock:
            if self._row_ids is None:
                return expected.Err(Status.empty_index, "index not built")
            self._merge_pending()
            snap = self._epoch_snapshot()
        return snap._ann_iterator(dataset, cfg, bitset)

    def _ann_iterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[List]":
        xq, q_pad_dev = self._queries(dataset)
        keep_sorted = self._keep_sorted_mask(bitset)
        n_valid = self._n_valid(bitset)
        nprobe0 = min(max(int(cfg.get("nprobe", 8) or 8), 16), self._nlist)
        k0 = int(min(max(n_valid, 1), 8192))
        covered = {"done": False}

        def round_fn(r: int):
            if covered["done"]:
                return None  # an earlier round covered everything
            k_r = max(1, min(n_valid, k0 << (2 * r)))
            nprobe_r = min(self._nlist, nprobe0 << (2 * r))
            if k_r >= n_valid and nprobe_r >= self._nlist and k_r <= _index_node.DEVICE_K_MAX:
                covered["done"] = True
            if k_r > _index_node.DEVICE_K_MAX:
                covered["done"] = True
                d_f, i_f = self._full_sorted(xq, bitset)
                return i_f, d_f
            dists, ids = self._search_batch(xq, k_r, nprobe_r, keep_sorted, n_valid, True, q_pad_dev, 1)
            return ids, dists

        group = ExpandingIteratorGroup(xq.shape[0], self.Count(), round_fn)
        larger = self._larger_is_closer()
        return expected.Ok([group.make_iterator(i, larger_is_closer=larger) for i in range(xq.shape[0])])

    # --- rows by id ---------------------------------------------------------
    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        """The stored rows of ``ids`` in their own dtype: packed bits for
        binary, SCANN's raw rows, a typed corpus's fp16 / int8 rows or bf16
        bit patterns (a cosine corpus's rows un-normalized and cast back)."""
        if not self.HasRawData(self._metric):
            return expected.Err(Status.not_implemented, "index does not store raw data")
        with self._lock:
            if self._row_ids is None:
                return expected.Err(Status.empty_index, "index not built")
            ids = np.asarray(dataset.ids, dtype=np.int64)
            if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self.Count():
                return expected.Err(Status.invalid_args, "id out of range")
            pos = self._pos_of_row[ids]
            if self._is_binary():
                out = self._sorted_payload["bits"][pos]
            elif "refine" in self._sorted_payload and self._refine_cfg == "raw":
                out = self._sorted_payload["refine"][pos]
            elif self._metric == M.COSINE and self._norms_raw is not None:  # the stored rows are normalized
                out = self._payload_f32("data", pos) * self._norms_raw[ids][:, None]
                out = bf16_bits(out) if self.data_type == "bf16" else out.astype(
                    {"fp16": np.float16, "int8": np.int8}.get(self.data_type, np.float32)
                )
            else:
                out = self._sorted_payload["data"][pos]
            return expected.Ok(GenTensorDataSet(out, len(ids), self._dim))

    def CalcDistByIDs(self, query_ds, bitset, ids, rows) -> "expected[np.ndarray]":
        """Distances of every query to the stored rows ``ids``: (nq,
        len(ids)) f32, on the device. The rows are the raw payload, else the
        refine payload, taken as f32 values as the reference takes them (an
        SQ8 refine store's uint8 codes as they are, not decoded)."""
        key = "data" if "data" in self._sorted_payload else "refine"
        if key not in self._sorted_payload:
            return expected.Err(Status.not_implemented, "no raw data for CalcDistByIDs")
        sub = to_device(self._payload_f32(key, self._pos_of_row[np.asarray(ids, dtype=np.int64)]))
        q = to_device(self._prep_rows(np.asarray(query_ds.tensor)))
        internal = self._internal_metric()
        return expected.Ok(D.pairwise_distance(internal, q, sub, D.base_aux(internal, sub)).cpu().numpy())

    def HasRawData(self, metric_type: str = "L2") -> bool:
        # reference CommonHasRawData (ivf.cc:177-199): FLAT / FLAT_CC / BIN
        # true, SCANN with its raw rows, PQ / SQ / SQ_CC / RaBitQ false
        if self._kind == "raw":
            return True
        return self.VARIANT == "scann" and self._refine_cfg == "raw"

    # --- feder -----------------------------------------------------------------------
    def GetIndexMeta(self, cfg: Config) -> "expected[DataSet]":
        """feder's IVF overview (reference feder/IVFFlat.h): the lists' true
        sizes beside the index's shape."""
        import json

        if self._offsets is None:
            return expected.Err(Status.empty_index, "index not built")
        meta = {
            "index_type": self.Type(),
            "metric_type": self._metric,
            "nlist": self._nlist,
            "dim": self._dim,
            "count": self.Count(),
            "list_sizes": (self._lengths if self._lengths is not None else np.diff(self._offsets)).tolist(),
        }
        ds = DataSet()
        ds.set("json_info", json.dumps(meta))
        return expected.Ok(ds)

    def GetFederVisit(self, dataset: DataSet, cfg: Config) -> "expected[DataSet]":
        """trace_visit: each query's probed lists and their sizes, by the
        host coarse probe (reference feder/IVFFlat.h FederResult)."""
        import json

        if self._offsets is None:
            return expected.Err(Status.empty_index, "index not built")
        xq = self._prep_rows(np.asarray(dataset.tensor))
        probes = coarse_probe_host(xq, self._centroids, int(cfg.get("nprobe", 8) or 8), self._is_l2_like())
        lens = self._lengths if self._lengths is not None else np.diff(self._offsets)
        traces = [[{"list_id": int(lst), "size": int(lens[lst])} for lst in row.tolist() if lst >= 0] for row in probes]
        ds = DataSet()
        ds.set("json_id_set", json.dumps(traces))
        return expected.Ok(ds)

    # --- serialization ------------------------------------------------------------------
    def Serialize(self, binset: BinarySet) -> Status:
        with self._writer_lock, self._lock:
            if self._row_ids is None:
                return Status.empty_index
            self._merge_pending()
            arrays = {
                "centroids": self._centroids,
                "row_ids": self._row_ids,
                "offsets": self._offsets,
                "lengths": self._lengths,
            }
            for k_, v in self._sorted_payload.items():
                arrays["payload_" + k_] = np.asarray(v)
            if self._norms_raw is not None:
                arrays["norms_raw"] = self._norms_raw
            meta = {
                "variant": self.VARIANT,
                "metric": self._metric,
                "dim": self._dim,
                "nlist": self._nlist,
                "data_type": self.data_type,
                "refine_cfg": self._refine_cfg,
            }
            if self._pq is not None:
                arrays["pq_codebooks"] = self._pq.codebooks
                meta["pq_nbits"] = self._pq.nbits
                if self._opq_rot is not None:
                    arrays["opq_rotation"] = self._opq_rot
            if self._sq is not None:
                meta["sq_type"] = self._sq.sq_type
                if self._sq.vmin is not None:
                    arrays["sq_vmin"] = self._sq.vmin
                    arrays["sq_vdiff"] = self._sq.vdiff
            if self._rbq is not None:
                arrays["rbq_rotation"] = self._rbq.rotation
            bf16 = tuple(k_ for k_, v in arrays.items() if v.dtype == np.uint16)
            binset.Append(self.Type(), write_sections(arrays, meta=meta, bf16=bf16))
            return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        if meta.get("variant") != self.VARIANT:
            return Status.invalid_serialized_index_type
        with self._lock:
            self.load_state(arrays, meta)
        return Status.success

    # --- introspection ---------------------------------------------------------------------
    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        return sum(np.asarray(v).nbytes for v in self._sorted_payload.values()) + (
            self._centroids.nbytes if self._centroids is not None else 0
        )

    def Count(self) -> int:
        return (0 if self._row_ids is None else self._count) + self._pending_count

    def Type(self) -> str:
        return self.index_type

    @classmethod
    def CreateConfig(cls) -> Config:
        return _CONFIGS[cls.VARIANT]()


class IvfFlatNode(IvfIndexNode):
    VARIANT = "flat"


class IvfFlatCcNode(IvfIndexNode):
    VARIANT = "flat_cc"


class IvfPqNode(IvfIndexNode):
    VARIANT = "pq"


class ScannNode(IvfIndexNode):
    VARIANT = "scann"


class IvfSqNode(IvfIndexNode):
    VARIANT = "sq"


class IvfSqCcNode(IvfIndexNode):
    VARIANT = "sq_cc"


class IvfRaBitQNode(IvfIndexNode):
    VARIANT = "rabitq"


class IvfRaBitQFastScanNode(IvfIndexNode):
    VARIANT = "rabitq_fastscan"


class BinIvfFlatNode(IvfIndexNode):
    VARIANT = "bin"


_DENSE_TYPES = ("fp32",) + _TYPED
_F = feature
for _name, _node, _extra in (
    (IndexEnum.INDEX_FAISS_IVFFLAT, IvfFlatNode, _F.MMAP | _F.EMB_LIST),
    (IndexEnum.INDEX_FAISS_IVFFLAT_CC, IvfFlatCcNode, 0),
    (IndexEnum.INDEX_FAISS_IVFSQ8, IvfSqNode, _F.MMAP),
    (IndexEnum.INDEX_FAISS_IVFSQ_CC, IvfSqCcNode, 0),
    (IndexEnum.INDEX_FAISS_IVFPQ, IvfPqNode, _F.MMAP),
    (IndexEnum.INDEX_FAISS_SCANN, ScannNode, _F.MMAP),
    (IndexEnum.INDEX_FAISS_IVFRABITQ, IvfRaBitQNode, _F.MMAP),
    (IndexEnum.INDEX_FAISS_IVFRABITQ_FASTSCAN, IvfRaBitQFastScanNode, 0),
):
    register_index(_name, _DENSE_TYPES, _F.ALL_DENSE_TYPE | _F.KNN | _extra)(_node)
# IVFBIN: the legacy name the reference registers beside BIN_IVF_FLAT (ivf.cc:1926)
for _name in (IndexEnum.INDEX_FAISS_BIN_IVFFLAT, "IVFBIN"):
    register_index(_name, ("bin1",), _F.BINARY | _F.KNN | _F.MMAP)(BinIvfFlatNode)
# the legacy faiss-GPU names keep the plain IVF configs (reference ivf.cc:1957-1962)
for _name, _node in (
    (IndexEnum.INDEX_FAISS_GPU_IVFFLAT, IvfFlatNode),
    (IndexEnum.INDEX_FAISS_GPU_IVFPQ, IvfPqNode),
    (IndexEnum.INDEX_FAISS_GPU_IVFSQ8, IvfSqNode),
):
    register_index(_name, _DENSE_TYPES, _F.ALL_DENSE_TYPE | _F.KNN | _F.GPU)(_node)
