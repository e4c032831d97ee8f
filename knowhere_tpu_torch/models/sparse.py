"""Sparse vectors: brute force and the inverted-index family
(SPARSE_INVERTED_INDEX, SPARSE_WAND and their _CC names); counterpart of
knowhere_tpu/models/sparse.py.

Reference behaviour reproduced:
- SparseRow storage and the BM25 doc-value computer
  (include/knowhere/sparse_utils.h:62-201);
- sparse brute force with BM25 (src/common/comp/brute_force.cc
  SearchSparse): scipy products on the host, the recall oracle;
- the inverted-index family (src/index/sparse/sparse_index_node.cc): IP and
  BM25, drop_ratio_build / drop_ratio_search, refine_factor, every
  inverted_index_algo name, growable CC nodes with concurrent reads and
  writes, the posting codecs, the persisted engine choice.

Sparse rows on the Python surface are dicts {dim: value} (or (indices,
values) pairs). The engines live in ops/sparse_ops.py: every DAAT name
routes to the hybrid head/tail engine, or, after a one-shot timed probe or
with non-default window knobs, to the windowed pruner; TAAT_NAIVE takes the
padded engine.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet, GenRangeResultDataSet, GenResultDataSet
from ..device import to_device
from ..factory import register_index
from ..feature import feature
from ..index_node import IndexNode, PrecomputedDistanceIterator
from ..index_param import IndexEnum
from ..index_param import metric as M
from ..index_param import normalize_metric
from ..io.serialize import read_sections, write_sections
from ..ops import bitpack
from ..ops.range import apply_range_search_k
from ..ops.sparse_ops import (
    SparsePostings,
    bm25_transform,
    build_hybrid_slab,
    build_padded_docs,
    build_postings,
    build_window_max,
    exact_rescore_pool,
    flatten_rows,
    hybrid_bm25_slab,
    padded_bm25_vals,
    sparse_full_scores,
    sparse_full_scores_hybrid,
    sparse_full_scores_padded,
    sparse_search,
    sparse_search_hybrid,
    sparse_search_padded,
    sparse_search_pruned,
)
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import bf16_bits, rows_to_device
from ..utils.spill import spill_array

# ---------------------------------------------------------------------------
# CSR helpers and brute force
# ---------------------------------------------------------------------------


def rows_to_csr(rows) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows -> row-major CSR (indptr int64, indices int32, values f32), each
    row's entries sorted by (dim, value) as ``sorted(row.items())`` sorts
    them."""
    dims, vals, rids, _ = flatten_rows(rows)
    key = rids * (int(dims.max(initial=0)) + 1) + dims  # row, then dim
    order = np.argsort(key, kind="stable")
    if (np.diff(key[order]) == 0).any():  # a dim twice in a row (pairs rows only): then by value
        order = np.lexsort((vals, key))
    indptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(np.bincount(rids, minlength=len(rows)), out=indptr[1:])
    return indptr, dims[order].astype(np.int32), vals[order]


def csr_to_rows(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray) -> List[Dict[int, float]]:
    """Row-major CSR -> {dim: value} rows (python ints and floats)."""
    ind, val, ptr = np.asarray(indices).tolist(), np.asarray(values).tolist(), np.asarray(indptr).tolist()
    return [dict(zip(ind[a:b], val[a:b])) for a, b in zip(ptr[:-1], ptr[1:])]


def bm25_doc_values(
    values: np.ndarray, row_sums: np.ndarray, indptr: np.ndarray, k1: float, b: float, avgdl: float
) -> np.ndarray:
    """Per-element BM25 doc value tf*(k1+1) / (tf + k1*(1 - b + b*dl/avgdl))
    (sparse_utils.h); ``row_sums`` is the document length (sum of tf)."""
    avgdl = max(avgdl, 1e-9)
    dl = np.repeat(row_sums, np.diff(indptr))
    return values * (k1 + 1.0) / (values + k1 * (1.0 - b + b * dl / avgdl))


def _score_matrix(
    base_csr: Tuple[np.ndarray, np.ndarray, np.ndarray],
    q_rows,
    nb: int,
    metric_name: str,
    bm25_params: Optional[Tuple[float, float, float]],
    drop_ratio_search: float = 0.0,
) -> np.ndarray:
    """(nq, nb) sparse inner-product / BM25 scores on the host: one scipy
    product of the queries' CSR with the base's transpose. Query blocks run
    on threads (scipy releases the GIL in the product); each row's result
    does not depend on the blocking."""
    from scipy import sparse as sp

    from ..ops.sparse_ops import _drop_items

    indptr, indices, values = base_csr
    nq = len(q_rows)
    scores = np.zeros((nq, nb), dtype=np.float32)
    if not len(indices):
        return scores
    if metric_name == M.BM25:
        k1, b, avgdl = bm25_params
        row_sums = np.add.reduceat(values, indptr[:-1]) if len(values) else np.zeros(nb)
        row_sums = np.where(np.diff(indptr) == 0, 0.0, row_sums)
        vals_eff = bm25_doc_values(values, row_sums, indptr, k1, b, avgdl)
    else:
        vals_eff = values
    vocab = int(indices.max()) + 1
    D = sp.csr_matrix((vals_eff.astype(np.float32), indices.astype(np.int64), indptr), shape=(nb, vocab))
    q_indptr, q_idx, q_val = [0], [], []
    for qrow in q_rows:
        for d, v in _drop_items(qrow, drop_ratio_search):
            if 0 <= int(d) < vocab:
                q_idx.append(int(d))
                q_val.append(float(v))
        q_indptr.append(len(q_idx))
    Q = sp.csr_matrix(
        (np.asarray(q_val, np.float32), np.asarray(q_idx, np.int64), np.asarray(q_indptr, np.int64)),
        shape=(nq, vocab),
    )
    DT = D.T.tocsr()
    # the product's own CSR holds up to chunk x nb entries a block in flight
    chunk = max(1, min(nq, (64 << 20) // max(nb * 4, 1)))

    def block(s0: int) -> None:
        e0 = min(s0 + chunk, nq)
        scores[s0:e0] = (Q[s0:e0] @ DT).toarray()

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for fut in [ex.submit(block, s0) for s0 in range(0, nq, chunk)]:
            fut.result()
    return scores


def _load_sparse_cfg(json_cfg: dict, stage: Stage):
    cfg = BaseConfig()
    st, msg = Config.load(cfg, json_cfg or {}, stage)
    if st != Status.success:
        return None, st, msg
    m = normalize_metric(cfg.metric_type)
    if m not in (M.IP, M.BM25):
        return None, Status.invalid_metric_type, f"sparse search supports IP/BM25, got {m}"
    if m == M.BM25 and (cfg.bm25_k1 is None or cfg.bm25_b is None or cfg.bm25_avgdl is None):
        return None, Status.invalid_param_in_json, "BM25 requires bm25_k1/bm25_b/bm25_avgdl"
    return cfg, Status.success, ""


def _sparse_scores_for(base_dataset: DataSet, query_dataset: DataSet, cfg, m: str) -> np.ndarray:
    base_rows = base_dataset.tensor
    bm25 = (cfg.bm25_k1, cfg.bm25_b, cfg.bm25_avgdl) if m == M.BM25 else None
    return _score_matrix(rows_to_csr(base_rows), query_dataset.tensor, len(base_rows), m, bm25)


def _filtered(scores: np.ndarray, bitset: Optional[BitsetView], nb: int) -> np.ndarray:
    if bitset is not None and not bitset.empty_view():
        scores = np.where(bitset.host_mask(nb)[None, :], scores, -np.inf)
    return scores


def brute_force_search_sparse(
    base_dataset: DataSet, query_dataset: DataSet, json_cfg: dict, bitset: Optional[BitsetView]
) -> "expected[DataSet]":
    cfg, st, msg = _load_sparse_cfg(json_cfg, Stage.SEARCH)
    if st != Status.success:
        return expected.Err(st, msg)
    m = normalize_metric(cfg.metric_type)
    nb = len(base_dataset.tensor)
    scores = _filtered(_sparse_scores_for(base_dataset, query_dataset, cfg, m), bitset, nb)
    k = cfg.k
    nq = scores.shape[0]
    kk = min(k, nb)
    top_s, top_i = torch.topk(torch.from_numpy(scores), kk, dim=1)
    top_s, top_i = top_s.numpy(), top_i.numpy()
    order = np.lexsort((top_i, -top_s), axis=1)  # score descending, then the lower id
    top_s, top_i = np.take_along_axis(top_s, order, 1), np.take_along_axis(top_i, order, 1)
    valid = top_s > 0  # zero / -inf overlap is no match; valid slots come first
    ids = np.full((nq, k), -1, dtype=np.int64)
    dists = np.zeros((nq, k), dtype=np.float32)
    ids[:, :kk] = np.where(valid, top_i, -1)
    dists[:, :kk] = np.where(valid, top_s, 0.0)
    return expected.Ok(GenResultDataSet(nq, k, ids, dists))


def brute_force_range_search_sparse(
    base_dataset: DataSet, query_dataset: DataSet, json_cfg: dict, bitset: Optional[BitsetView]
) -> "expected[DataSet]":
    cfg, st, msg = _load_sparse_cfg(json_cfg, Stage.RANGE_SEARCH)
    if st != Status.success:
        return expected.Err(st, msg)
    m = normalize_metric(cfg.metric_type)
    nb = len(base_dataset.tensor)
    scores = _filtered(_sparse_scores_for(base_dataset, query_dataset, cfg, m), bitset, nb)
    radius, range_filter = cfg.radius, cfg.range_filter
    two_sided = np.isfinite(range_filter)
    nq = scores.shape[0]
    all_ids, all_dists = [], []
    lims = np.zeros(nq + 1, dtype=np.int64)
    for i in range(nq):
        keep_i = scores[i] > radius
        if two_sided:
            keep_i &= scores[i] <= range_filter
        sel = np.nonzero(keep_i)[0]
        vals = scores[i, sel]
        order = np.argsort(-vals, kind="stable")
        all_ids.append(sel[order].astype(np.int64))
        all_dists.append(vals[order].astype(np.float32))
        lims[i + 1] = lims[i] + len(sel)
    ids = np.concatenate(all_ids) if all_ids else np.empty(0, np.int64)
    dists = np.concatenate(all_dists) if all_dists else np.empty(0, np.float32)
    ids, dists, lims = apply_range_search_k(ids, dists, lims, cfg.get("range_search_k", -1), larger_is_closer=True)
    return expected.Ok(GenRangeResultDataSet(nq, ids, dists, lims))


def brute_force_ann_iterator_sparse(
    base_dataset: DataSet, query_dataset: DataSet, json_cfg: dict, bitset: Optional[BitsetView]
) -> "expected[list]":
    cfg, st, msg = _load_sparse_cfg(json_cfg, Stage.ITERATOR)
    if st != Status.success:
        return expected.Err(st, msg)
    m = normalize_metric(cfg.metric_type)
    scores = _sparse_scores_for(base_dataset, query_dataset, cfg, m)
    nb = len(base_dataset.tensor)
    keep = bitset.host_mask(nb) if bitset is not None and not bitset.empty_view() else None
    return expected.Ok([PrecomputedDistanceIterator(row, keep, larger_is_closer=True) for row in scores])


# ===========================================================================
# The inverted-index family
# ===========================================================================

# the engine probe runs on corpora and batches at least this large; smaller
# ones take the hybrid engine (the probe would cost more than it saves)
PROBE_MIN_ROWS = 100_000
PROBE_MIN_QUERIES = 64

_ALGOS = ("INHERIT", "TAAT_NAIVE", "DAAT_WAND", "DAAT_MAXSCORE", "BLOCK_MAX_WAND", "BLOCK_MAX_MAXSCORE", "SINDI")
_CODECS = ("flat", "none", "block_streamvbyte", "block_maskedvbyte", "block_adaptive", "adaptive", "delta_varint")


class SparseInvertedIndexConfig(BaseConfig):
    # reference sparse_index_config.h: drop ratios are [0, 1) half-open
    drop_ratio_build = Entry(float, default=0.0, range=(0.0, 1.0), stages=[Stage.TRAIN], exclusive_hi=True)
    drop_ratio_search = Entry(
        float, default=0.0, range=(0.0, 1.0), exclusive_hi=True,
        stages=[Stage.SEARCH, Stage.RANGE_SEARCH, Stage.ITERATOR],
    )
    refine_factor = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])
    dim_max_score_ratio = Entry(float, default=1.05, range=(0.5, 1.3), stages=[Stage.SEARCH])
    search_algo = Entry(str, default="INHERIT", stages=[Stage.SEARCH])
    inverted_index_algo = Entry(str, default="DAAT_MAXSCORE", stages=[Stage.TRAIN])
    inverted_index_codec = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    block_max_block_size = Entry(int, default=128, range=(1, 65536), stages=[Stage.TRAIN])
    quant_type = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    sindi_window_size = Entry(int, default=65535, range=(1024, 65535), stages=[Stage.SEARCH])

    def check_and_adjust(self, stage):
        st, msg = super().check_and_adjust(stage)
        if st != Status.success:
            return st, msg
        algo = (self.inverted_index_algo or "DAAT_MAXSCORE").upper()
        if algo not in _ALGOS:
            return Status.invalid_value_in_json, f"unknown inverted_index_algo {algo}"
        return Status.success, ""


def _bm25_key(cfg: Config) -> Tuple[float, float, float]:
    return (round(float(cfg.get("bm25_k1")), 6), round(float(cfg.get("bm25_b")), 6), round(float(cfg.get("bm25_avgdl")), 6))


class SparseInvertedIndexNode(IndexNode):
    IS_WAND = False  # SPARSE_WAND differs only in its default algorithm name

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_SPARSE_INVERTED_INDEX
        self.data_type = "sparse"
        self._lock = threading.RLock()
        # single-writer lock (epoch merges): always taken before self._lock
        self._writer_lock = threading.Lock()
        self._metric = M.IP
        self._dim = 0
        self._rows: List[Dict[int, float]] = []
        self._postings: Optional[SparsePostings] = None
        self._drop_ratio_build = 0.0
        self._doc_ids_dev = None
        self._vals_dev = None
        self._bm25_cache: Dict[tuple, object] = {}
        self._pending: List[Dict[int, float]] = []
        self._build_algo = "DAAT_MAXSCORE"
        self._build_codec: Optional[str] = None
        # derived structures of the current postings epoch (engines, window
        # maxima, row-major CSR, engine choices); rebound on every rebuild so
        # a search snapshot keeps its epoch's. A racing duplicate lazy fill
        # computes the same value.
        self._caches: Dict[tuple, object] = {}
        self._last_search_stats: Dict[str, int] = {}
        self._last_probe: Dict[str, object] = {}  # the last engine probe's choice and seconds

    # --- build ----------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        if self._metric not in (M.IP, M.BM25):
            raise KnowhereException(f"sparse index supports IP/BM25, got {self._metric}", Status.invalid_metric_type)
        self._drop_ratio_build = float(cfg.get("drop_ratio_build", 0.0) or 0.0)
        self._build_algo = (cfg.get("inverted_index_algo") or "DAAT_MAXSCORE").upper()
        codec = (cfg.get("inverted_index_codec") or "").lower()
        if codec and codec not in _CODECS:  # sparse_index_node.cc:538
            raise KnowhereException(f"unknown inverted_index_codec {codec}", Status.invalid_value_in_json)
        self._build_codec = codec or None
        self._dim = dataset.dim
        return Status.success

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        rows = list(dataset.tensor)
        with self._writer_lock:
            if self._postings is None and not self._rows:
                with self._lock:
                    self._rows = rows
                    self._rebuild()
            else:
                # growable semantics (every node accepts appends, as the
                # reference's growable base does); copy-on-write so search
                # snapshots keep their epoch
                with self._lock:
                    self._pending = self._pending + rows
                    need_merge = len(self._pending) > max(1024, len(self._rows) // 4)
                if need_merge:
                    self._merge_pending_offlock()
        return Status.success

    def _merge_pending(self) -> None:
        """Caller holds both self._writer_lock and self._lock."""
        if not self._pending:
            return
        self._rows = self._rows + self._pending
        self._pending = []
        self._rebuild()

    def _merge_pending_offlock(self) -> None:
        """Epoch merge off the read lock: rebuild the postings from a stable
        view, then swap the fields in one short locked pass; searches keep
        scanning the old epoch meanwhile (sparse_index_node.cc:928-939).
        Caller holds self._writer_lock, not self._lock."""
        with self._lock:
            pending = self._pending
        if not pending:
            return
        rows = self._rows + pending
        postings = build_postings(rows, self._drop_ratio_build)
        doc_ids_dev, vals_dev = to_device(postings.doc_ids), to_device(postings.vals)
        with self._lock:
            self._rows = rows
            self._pending = []
            self._postings = postings
            self._doc_ids_dev = doc_ids_dev
            self._vals_dev = vals_dev
            self._bm25_cache = {}
            self._caches = {}

    def _rebuild(self) -> None:
        self._postings = build_postings(self._rows, self._drop_ratio_build)
        self._doc_ids_dev = to_device(self._postings.doc_ids)
        self._vals_dev = to_device(self._postings.vals)
        self._bm25_cache = {}
        self._caches = {}

    def _bm25_vals(self, cfg: Config) -> Tuple[np.ndarray, object]:
        """(host, device) BM25 posting values for cfg's parameters."""
        if cfg.get("bm25_k1") is None or cfg.get("bm25_b") is None or cfg.get("bm25_avgdl") is None:
            raise KnowhereException("BM25 requires bm25_k1/bm25_b/bm25_avgdl", Status.invalid_param_in_json)
        key = _bm25_key(cfg)
        if key not in self._bm25_cache:
            host = bm25_transform(self._postings, *key)
            self._bm25_cache[key] = (host, to_device(host))
        return self._bm25_cache[key]

    def _vals_for(self, cfg: Config):
        return self._vals_dev if self._metric != M.BM25 else self._bm25_vals(cfg)[1]

    def _padded_for(self, cfg: Config):
        """(PaddedDocs, dims_dev, vals_dev) of the current epoch and metric
        (the TAAT_NAIVE engine), or None when padding is pathological."""
        got = self._caches.get("padded")
        if got is None:
            p = build_padded_docs(self._rows, self._drop_ratio_build)
            if p is None:
                self._caches["padded"] = (None, None)
                return None
            dims_dev = to_device(p.dims_pad)
            # the device copy is the engine; the host matrices only feed
            # metric re-transforms, so they spill to disk-backed memmaps
            p.dims_pad = spill_array(p.dims_pad)
            p.vals_pad = spill_array(p.vals_pad)
            got = self._caches["padded"] = (p, dims_dev)
        p, dims_dev = got
        if p is None:
            return None
        if self._metric != M.BM25:
            vkey = ("pvals", "ip")
            if vkey not in self._caches:
                self._caches[vkey] = to_device(np.asarray(p.vals_pad))
            return p, dims_dev, self._caches[vkey]
        # one slot (the latest parameters): the transformed values are
        # corpus-sized, so a slot a parameter set would grow without bound
        pkey = _bm25_key(cfg)
        slot = self._caches.get(("pvals", "bm25"))
        if slot is None or slot[0] != pkey:
            slot = self._caches[("pvals", "bm25")] = (pkey, to_device(padded_bm25_vals(p, *pkey)))
        return p, dims_dev, slot[1]

    def _hybrid_for(self, cfg: Config):
        """(HybridSlab, slab_dev, tail_vals_dev, tail_ids_dev) of the current
        epoch and metric (the head/tail engine), or None for an empty corpus.

        Resident compression (the reference keeps postings compressed,
        block_inverted_index.h + codec/): the tail's doc ids are a fixed
        ceil(log2(nb))-bit stream decoded inside the gather (ops/bitpack.py,
        exact), and the slab and tail values are bf16 (round to nearest
        even; an exact rescore of the top pool in _search_hybrid keeps the
        answer exact). KNOWHERE_SPARSE_PACKED_IDS=0 holds the ids as u16 /
        int32, KNOWHERE_SPARSE_RESIDENT_BF16=0 the values as f32."""
        got = self._caches.get("hybrid")
        if got is None:
            h = build_hybrid_slab(self._rows, self._drop_ratio_build)
            if h is None:
                self._caches["hybrid"] = (None, None)
                return None
            if os.environ.get("KNOWHERE_SPARSE_PACKED_IDS") == "0":
                h.tail_bits = 0
                ids = h.tail.doc_ids
                ids_dev = to_device(ids.astype(np.uint16).view(np.int16) if h.nb <= 0xFFFF else ids)
            else:
                h.tail_bits = bitpack.width_for(h.nb)
                packed = bitpack.pack_fixed(h.tail.doc_ids.astype(np.uint32), h.tail_bits)
                ids_dev = to_device(packed.view(np.int32))
            # the host slab only feeds metric re-transforms after the upload
            h.slab = spill_array(h.slab)
            got = self._caches["hybrid"] = (h, ids_dev)
        h, tail_ids_dev = got
        if h is None:
            return None
        bf16 = os.environ.get("KNOWHERE_SPARSE_RESIDENT_BF16", "1") != "0"
        h.vals_bf16 = bf16

        def resident(a):
            return rows_to_device(bf16_bits(a)) if bf16 else to_device(np.asarray(a, np.float32))

        if self._metric != M.BM25:
            slot = self._caches.get(("hvals", "ip"))
            if slot is None:
                slot = self._caches[("hvals", "ip")] = (resident(h.slab), resident(h.tail.vals))
            return h, slot[0], slot[1], tail_ids_dev
        pkey = _bm25_key(cfg)
        slot = self._caches.get(("hvals", "bm25"))
        if slot is None or slot[0] != pkey:
            slot = self._caches[("hvals", "bm25")] = (
                pkey, resident(hybrid_bm25_slab(h, *pkey)), resident(bm25_transform(h.tail, *pkey)),
            )
        return h, slot[1], slot[2], tail_ids_dev

    def _bm25_rescore_params(self, cfg: Config):
        """(k1, b, avgdl, row_sums) for exact_rescore_pool, or None for IP."""
        if self._metric != M.BM25:
            return None
        return float(cfg.get("bm25_k1")), float(cfg.get("bm25_b")), float(cfg.get("bm25_avgdl")), self._postings.row_sums

    def _vals_host_for(self, cfg: Config) -> tuple:
        """(host metric-transformed posting values, cache key): the window
        maxima of the pruned search are taken over them."""
        if self._metric != M.BM25:
            return self._postings.vals, ("ip",)
        return self._bm25_vals(cfg)[0], _bm25_key(cfg)

    # --- search ------------------------------------------------------------
    def _epoch_snapshot(self) -> "SparseInvertedIndexNode":
        """Point-in-time view for a search off the lock: mutators rebind
        whole fields under self._lock, so a shallow copy of __dict__ under
        the same lock is one consistent epoch."""
        snap = object.__new__(type(self))
        snap.__dict__.update(self.__dict__)
        return snap

    def _pending_scores(self, q_rows, cfg: Config, bitset: BitsetView) -> Optional[np.ndarray]:
        """Exact host scores of the queries against the pending rows,
        (nq, npend), -inf where a row has no overlap or is filtered; None
        without pending rows."""
        pending = self._pending
        if not pending:
            return None
        base_nb = self._postings.nb if self._postings is not None else 0
        npend = len(pending)
        bm25 = (float(cfg.get("bm25_k1")), float(cfg.get("bm25_b")), float(cfg.get("bm25_avgdl"))) if (
            self._metric == M.BM25) else None
        out = _score_matrix(rows_to_csr(pending), q_rows, npend, self._metric, bm25)
        # zero overlap is no match, as the engines score the merged rows
        out[out <= 0] = -np.inf
        if not bitset.empty_view():
            out[:, ~bitset.host_mask(base_nb + npend)[base_nb:]] = -np.inf
        return out

    def _search_scores(self, dataset: DataSet, cfg: Config, bitset: BitsetView, k: int):
        with self._lock:
            if self._postings is None:
                raise KnowhereException("index not built", Status.empty_index)
            snap = self._epoch_snapshot()
        # the scan runs outside the lock on the snapshot's epoch; a
        # concurrent Add never waits behind it (sparse_index_node.cc:928-939)
        q_rows = list(dataset.tensor)
        mask = None if bitset.empty_view() else to_device(bitset.host_mask(snap._postings.nb))
        vals = snap._vals_for(cfg)
        drop = float(cfg.get("drop_ratio_search", 0.0) or 0.0)
        algo = (cfg.get("search_algo") or "INHERIT").upper()
        if algo == "INHERIT":  # the build's algorithm (sparse_index_config.h:127-130)
            algo = snap._build_algo or ("DAAT_WAND" if snap.IS_WAND else "DAAT_MAXSCORE")
        rf = int(cfg.get("refine_factor", 1) or 1)
        wsize = int(np.clip(int(cfg.get("sindi_window_size", 65535) or 65535), 1024, 65535))
        nw = max(1, -(-snap._postings.nb // wsize))
        # each engine is built lazily inside the branch that uses it
        if algo == "TAAT_NAIVE":
            padded = snap._padded_for(cfg)
            if padded is not None:
                scores, ids = snap._search_padded(padded, q_rows, cfg, k, drop, mask, self, nw, wsize)
            else:
                scores, ids = sparse_search(
                    snap._postings, vals, snap._doc_ids_dev, q_rows, k, drop_ratio_search=drop, mask=mask
                )
        else:
            # the DAAT names score with the head/tail engine; non-default
            # window knobs select the windowed pruner, so their contracts
            # stay observable (sparse_index_config.h:97-162)
            ratio_raw = float(cfg.get("dim_max_score_ratio", 1.05) or 1.05)
            window_knobs = (
                int(cfg.get("sindi_window_size", 65535) or 65535) != 65535 or abs(ratio_raw - 1.05) > 1e-9
            )
            hybrid = None if window_knobs else snap._hybrid_for(cfg)
            if hybrid is not None and self._pick_engine(snap, hybrid, q_rows, cfg, k, drop, rf, mask) == "hybrid":
                scores, ids = snap._search_hybrid(hybrid, q_rows, cfg, k, drop, rf, mask, self)
            else:
                scores, ids = snap._search_pruned(q_rows, cfg, k, drop, rf, mask, self)
        pend = snap._pending_scores(q_rows, cfg, bitset)
        if pend is not None:
            base_nb = snap._postings.nb
            kp = min(k, pend.shape[1])
            ordp = np.argsort(-pend, axis=1, kind="stable")[:, :kp]
            sp = np.take_along_axis(pend, ordp, 1)
            ip = np.where(np.isfinite(sp), ordp.astype(np.int64) + base_nb, -1)
            cat_s = np.concatenate([scores, sp], axis=1)
            cat_i = np.concatenate([ids, ip], axis=1)
            order = np.argsort(-np.where(cat_i >= 0, cat_s, -np.inf), axis=1, kind="stable")[:, :k]
            scores = np.take_along_axis(cat_s, order, 1)
            ids = np.take_along_axis(cat_i, order, 1)
        return scores, ids

    def _pick_engine(self, snap, hybrid, q_rows, cfg, k: int, drop: float, rf: int, mask) -> str:
        """Hybrid or the windowed pruner, by a one-shot timed probe an
        (epoch, drop, bitset) key, cached (and persisted by Serialize).
        Small corpora and batches skip the probe (hybrid).
        KNOWHERE_SPARSE_AUTO_ENGINE=0 pins hybrid, =pruned the pruner. A
        failing engine raises: the probe does not hide it."""
        forced = os.environ.get("KNOWHERE_SPARSE_AUTO_ENGINE", "")
        if forced == "0":
            return "hybrid"
        if forced == "pruned":
            return "pruned"
        if snap._postings.nb < PROBE_MIN_ROWS or len(q_rows) < PROBE_MIN_QUERIES:
            return "hybrid"
        key = ("engine_choice", round(drop, 2), bool(mask is not None))
        cached = snap._caches.get(key)
        if cached is not None:
            return cached
        probe = q_rows[: min(32, len(q_rows))]
        t_probe = time.perf_counter()
        times = {}
        for name, fn in (
            ("hybrid", lambda: snap._search_hybrid(hybrid, probe, cfg, k, drop, rf, mask, self)),
            ("pruned", lambda: snap._search_pruned(probe, cfg, k, drop, rf, mask, self)),
        ):
            fn()  # warm: uploads, lazy structures
            t0 = time.perf_counter()
            fn()
            times[name] = time.perf_counter() - t0
        best = min(times, key=times.get)  # hybrid on a tie
        snap._caches[key] = best
        self._last_probe = {"choice": best, "probe_s": time.perf_counter() - t_probe, **{f"{n}_s": t for n, t in times.items()}}
        return best

    def _csr_cache(self):
        """Row-major CSR of the rows, for exact rescoring (epoch-cached)."""
        csr = self._caches.get("csr")
        if csr is None:
            csr = self._caches["csr"] = rows_to_csr(self._rows)
        return csr

    def _search_padded(self, padded3, q_rows, cfg, k: int, drop: float, mask, live, nw, wsize):
        """The padded exhaustive scan (TAAT_NAIVE): exact scores, the
        query-term drop on the host."""
        p, dims_dev, vals_dev = padded3
        scores, ids = sparse_search_padded(
            p, dims_dev, vals_dev, q_rows, k, drop_ratio_search=drop, mask=mask
        )
        live._last_search_stats = {
            "windows_scanned_a": len(q_rows) * nw, "windows_scanned_b": 0, "windows_total": len(q_rows) * nw,
            "n_windows": nw, "window_size": wsize, "engine": "padded_exhaustive",
        }
        return scores, ids

    def _search_hybrid(self, hybrid4, q_rows, cfg, k: int, drop: float, rf: int, mask, live):
        """The head/tail scan, then an exact host rescore of the pool: the
        k*rf pool when a query-term drop made scores approximate, else the
        2k pool when values are bf16 (the gate that keeps the answer exact)."""
        h, slab_dev, tail_vals_dev, tail_ids_dev = hybrid4
        want_refine = rf > 1 and drop > 0
        bf16_gate = h.vals_bf16 and not want_refine
        k_pool = k * rf if want_refine else (min(2 * k, h.nb) if bf16_gate else k)
        scores, ids = sparse_search_hybrid(
            h, slab_dev, tail_vals_dev, tail_ids_dev, q_rows, k_pool, drop_ratio_search=drop, mask=mask,
            tail_bits=h.tail_bits,
        )
        if want_refine or bf16_gate:
            t0 = time.perf_counter()
            scores, ids = exact_rescore_pool(self._csr_cache(), q_rows, ids, k, bm25=self._bm25_rescore_params(cfg))
            rescore_ms = (time.perf_counter() - t0) * 1e3
        live._last_search_stats = {
            "engine": "hybrid_slab", "head_dims": h.F, "head_nnz": h.head_nnz, "total_nnz": h.total_nnz,
            "tail_nnz": h.total_nnz - h.head_nnz,
            **({"rescore_ms": rescore_ms} if want_refine or bf16_gate else {}),
        }
        return scores, ids

    def _search_pruned(self, q_rows, cfg: Config, k: int, drop: float, rf: int, mask, live):
        """The windowed pruner (ops/sparse_ops.sparse_search_pruned) on a
        snapshot; its window maxima and CSR cache into the epoch's dict."""
        wsize = int(cfg.get("sindi_window_size", 65535) or 65535)
        ratio = float(cfg.get("dim_max_score_ratio", 1.05) or 1.05)
        vals_host, vkey = self._vals_host_for(cfg)
        wkey = ("wmax", wsize, vkey)
        wmax = self._caches.get(wkey)
        if wmax is None:
            wmax = self._caches[wkey] = build_window_max(self._postings, vals_host, wsize)
        stats: Dict[str, int] = {}
        scores, ids = sparse_search_pruned(
            self._postings, self._vals_for(cfg), self._doc_ids_dev, q_rows, k,
            wmax=wmax, refine_factor=rf, dim_max_score_ratio=ratio, drop_ratio_search=drop, mask=mask,
            csr=self._csr_cache() if (rf > 1 and drop > 0) else None, stats=stats,
            bm25=self._bm25_rescore_params(cfg),
        )
        live._last_search_stats = dict(stats, engine="pruned")
        return scores, ids

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(Status.invalid_metric_type, f"index built with {self._metric}, searched with {metric}")
        k = cfg.k
        scores, ids = self._search_scores(dataset, cfg, bitset, k)
        scores = np.where(ids >= 0, scores, 0.0)
        return expected.Ok(GenResultDataSet(dataset.rows, k, ids, scores))

    def _full_scores(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> np.ndarray:
        """Exact scores of every row: (nq, nb) f32, -inf = no overlap or
        filtered (the reference's BF-scores iterator,
        sparse_index_node.cc:254)."""
        with self._writer_lock, self._lock:
            self._merge_pending()
            if self._postings is None:
                raise KnowhereException("index not built", Status.empty_index)
            q_rows = list(dataset.tensor)
            mask = None if bitset.empty_view() else to_device(bitset.host_mask(self._postings.nb))
            drop = float(cfg.get("drop_ratio_search", 0.0) or 0.0)
            hybrid = self._hybrid_for(cfg)
            if hybrid is not None:
                h, slab_dev, tail_vals_dev, tail_ids_dev = hybrid
                return sparse_full_scores_hybrid(
                    h, slab_dev, tail_vals_dev, tail_ids_dev, q_rows, drop_ratio_search=drop, mask=mask,
                    tail_bits=h.tail_bits,
                )
            padded = self._padded_for(cfg)
            if padded is not None:
                p, dims_dev, vals_dev = padded
                return sparse_full_scores_padded(
                    p, dims_dev, vals_dev, q_rows, drop_ratio_search=drop, mask=mask
                )
            return sparse_full_scores(
                self._postings, self._vals_for(cfg), self._doc_ids_dev, q_rows, drop_ratio_search=drop, mask=mask
            )

    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        radius = cfg.get("radius", 0.0)
        range_filter = cfg.get("range_filter", float("inf"))
        two_sided = np.isfinite(range_filter)
        # complete: exact full scores, then the radius (a huge radius returns
        # every overlapping row)
        scores = self._full_scores(dataset, cfg, bitset)
        nq = scores.shape[0]
        lims = np.zeros(nq + 1, np.int64)
        out_i, out_d = [], []
        rsk = cfg.get("range_search_k", -1)
        for i in range(nq):
            keep_i = scores[i] > radius
            if two_sided:
                keep_i &= scores[i] <= range_filter
            sel = np.nonzero(keep_i)[0]
            sel = sel[np.argsort(-scores[i, sel], kind="stable")]
            if rsk is not None and rsk >= 0:
                sel = sel[:rsk]
            out_i.append(sel.astype(np.int64))
            out_d.append(scores[i, sel])
            lims[i + 1] = lims[i] + len(sel)
        ids_cat = np.concatenate(out_i) if out_i else np.empty(0, np.int64)
        d_cat = np.concatenate(out_d) if out_d else np.empty(0, np.float32)
        return expected.Ok(GenRangeResultDataSet(nq, ids_cat, d_cat, lims))

    def AnnIterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True):
        # exact full scores, sorted lazily in chunks: streams best-first down
        # to the last overlapping row (index_node.h:815-937)
        scores = self._full_scores(dataset, cfg, bitset)
        return expected.Ok([PrecomputedDistanceIterator(row, np.isfinite(row), larger_is_closer=True) for row in scores])

    # --- vectors / lifecycle ---------------------------------------------------
    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        with self._writer_lock, self._lock:
            self._merge_pending()
            ids = np.asarray(dataset.ids, dtype=np.int64)
            if len(self._rows) == 0:
                return expected.Err(Status.empty_index, "index not built")
            if ids.min(initial=0) < 0 or ids.max(initial=-1) >= len(self._rows):
                return expected.Err(Status.invalid_args, "id out of range")
            out = [self._rows[int(i)] for i in ids]
            ds = DataSet()
            ds.set("tensor", out)
            ds.is_sparse = True
            ds.rows = len(out)
            ds.dim = self._dim
            return expected.Ok(ds)

    def HasRawData(self, metric_type: str = "IP") -> bool:
        # raw data are reconstructible only when nothing was dropped
        return self._drop_ratio_build == 0.0 and normalize_metric(metric_type) == M.IP

    def Serialize(self, binset: BinarySet) -> Status:
        from .. import native

        with self._writer_lock, self._lock:
            self._merge_pending()
            if self._postings is None:
                return Status.empty_index
            indptr, indices, values = rows_to_csr(self._rows)
            # posting codecs by the reference's names (sparse_index_node.cc:
            # 527-538): the vbyte family is the varint stream, block_adaptive
            # the smaller of varint and bitpack, "" / flat raw indices
            want = (self._build_codec or "block_adaptive").lower()
            if want in ("", "flat", "none"):
                blob, codec = indices.tobytes(), "raw"
            elif want in ("block_streamvbyte", "block_maskedvbyte", "delta_varint"):
                blob, codec = native.encode_csr_indices(indices, indptr), "delta_varint"
            else:
                blob, codec = native.encode_csr_indices_adaptive(indices, indptr)
            arrays = {"indptr": indptr, "indices_codec": np.frombuffer(blob, dtype=np.uint8), "values": values}
            # the probe's choices travel with the blob, so every replica that
            # loads it serves the same engine
            engine_choices = {
                f"{key[1]}|{int(key[2])}": v
                for key, v in self._caches.items()
                if isinstance(key, tuple) and key and key[0] == "engine_choice"
            }
            meta = {
                "metric": self._metric,
                "dim": self._dim,
                "rows": len(self._rows),
                "drop_ratio_build": self._drop_ratio_build,
                "build_algo": self._build_algo,
                "index_type": self.Type(),
                "indices_codec": codec,
                **({"engine_choices": engine_choices} if engine_choices else {}),
            }
            binset.Append(self.Type(), write_sections(arrays, meta=meta))
            return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        from .. import native

        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        with self._lock:
            self._metric = meta["metric"]
            self._dim = int(meta["dim"])
            self._drop_ratio_build = float(meta.get("drop_ratio_build", 0.0))
            self._build_algo = meta.get("build_algo", "DAAT_MAXSCORE")
            indptr = np.asarray(arrays["indptr"])
            if "indices_codec" in arrays:
                codec = meta.get("indices_codec", "delta_varint")
                blob = np.asarray(arrays["indices_codec"]).tobytes()
                if codec == "raw":
                    indices = np.frombuffer(blob, dtype=np.int32)
                else:
                    indices = native.decode_csr_indices_any(blob, indptr, codec)
            else:
                indices = np.asarray(arrays["indices"])
            self._rows = csr_to_rows(indptr, indices, np.asarray(arrays["values"]))
            self._rebuild()
            for key_s, name in (meta.get("engine_choices") or {}).items():
                drop_s, mask_s = key_s.split("|")
                self._caches[("engine_choice", float(drop_s), bool(int(mask_s)))] = name
        return Status.success

    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        if self._postings is None:
            return 0
        return int(self._postings.doc_ids.nbytes + self._postings.vals.nbytes)

    def Count(self) -> int:
        return len(self._rows) + len(self._pending)

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return SparseInvertedIndexConfig()


class SparseWandNode(SparseInvertedIndexNode):
    IS_WAND = True


# "sparse" is the package's short name; "sparse_u32_f32" the reference's
# data-type string (feature.h:23-35)
_SPARSE_TYPES = ("sparse", "sparse_u32_f32")
register_index(
    IndexEnum.INDEX_SPARSE_INVERTED_INDEX, _SPARSE_TYPES, feature.SPARSE_FLOAT32 | feature.KNN | feature.MMAP
)(SparseInvertedIndexNode)
register_index(IndexEnum.INDEX_SPARSE_WAND, _SPARSE_TYPES, feature.SPARSE_FLOAT32 | feature.KNN | feature.MMAP)(
    SparseWandNode
)
register_index(IndexEnum.INDEX_SPARSE_INVERTED_INDEX_CC, _SPARSE_TYPES, feature.SPARSE_FLOAT32 | feature.KNN)(
    SparseInvertedIndexNode
)
register_index(IndexEnum.INDEX_SPARSE_WAND_CC, _SPARSE_TYPES, feature.SPARSE_FLOAT32 | feature.KNN)(SparseWandNode)
