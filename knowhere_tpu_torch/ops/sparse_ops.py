"""Sparse scoring engines on the device (counterpart of
knowhere_tpu/ops/sparse_ops.py).

The reference's DAAT WAND / MaxScore / BlockMax searchers
(src/index/sparse/searcher/*) are pruning schedules over the same inner
product; the engines here compute those scores batched, term at a time:

- the postings engine: dim-major CSR postings; a query chunk's touched
  postings are gathered, weighted and scatter-added into a dense
  (chunk, nb) accumulator, then one top-k;
- the padded engine (TAAT_NAIVE): documents as padded fixed-width rows of
  remapped dims, scored block by block against a dense query matrix with a
  running top-k pool;
- the hybrid head/tail engine (the default): the F dims with the most
  postings as a dense (F, nb_pad) slab, scored by one f32 product, the
  other dims as postings scatter-added on top;
- the windowed pruner: per-dim per-window posting maxima bound each
  window's score; a query scans only the windows that can reach its
  running threshold.

The host assembles, per query chunk, the segments of the postings it
touches (start, length, query, weight); the device expands them into
entries (:func:`_expand_segments`), gathers the doc ids and values and
scatter-adds with ``index_put_(accumulate=True)``, which on CUDA sorts the
indices and sums each one's contributions in a fixed order, so repeated
searches give the same bits. Selections take the leftmost among equal
scores (``ops/topk.topk_leftmost``), as ``jax.lax.top_k`` does; scores <= 0
are "no match" (-inf) and their ids -1.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comp import check_current_cancellation
from ..device import to_device
from .bitpack import unpack_gather
from .topk import topk_leftmost

_NEG_INF = -float("inf")
# columns of the head slab widened to f32 at a time: the resident slab may
# be bf16, and the product runs in f32 over a column block (F x 32,768 x 4
# bytes, 84 MB at F=640) instead of a widened copy of the whole slab
HEAD_BLOCK_COLS = 32768


@dataclass
class SparsePostings:
    """Dim-major CSR postings."""

    dim_start: Dict[int, Tuple[int, int]]  # dim -> (start, end) into entries
    doc_ids: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) f32 (raw term frequencies / weights)
    row_sums: np.ndarray  # (nb,) f32 document lengths (sum of tf)
    nb: int


def _row_items(row):
    return row.items() if isinstance(row, dict) else zip(*row)


def _keys(row):
    return row.keys() if isinstance(row, dict) else row[0]


def _values(row):
    return row.values() if isinstance(row, dict) else row[1]


def flatten_rows(rows) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rows ({dim: value} dicts or (indices, values) pairs) -> row-major
    (dims int64, values f32, row ids int64, row sums f32). The row sums add
    each row's values in f32 in row order, as the reference's loops do."""
    lens = np.fromiter((len(r) for r in map(_keys, rows)), np.int64, len(rows))
    total = int(lens.sum())
    dims = np.fromiter(chain.from_iterable(map(_keys, rows)), np.int64, total)
    vals = np.fromiter(chain.from_iterable(map(_values, rows)), np.float32, total)
    rids = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    row_sums = np.zeros(len(rows), np.float32)
    np.add.at(row_sums, rids, vals)
    return dims, vals, rids, row_sums


def _drop_build(dims, vals, rids, drop_ratio_build):
    if drop_ratio_build > 0 and vals.size:
        keep = np.abs(vals) >= np.quantile(np.abs(vals), drop_ratio_build)
        return dims[keep], vals[keep], rids[keep]
    return dims, vals, rids


def _dim_major(dims, docs, vals, nb, row_sums) -> SparsePostings:
    order = np.argsort(dims, kind="stable")
    dims, docs, vals = dims[order], docs[order], vals[order]
    uniq, starts = np.unique(dims, return_index=True)
    ends = np.append(starts[1:], dims.size)
    dim_start = {int(d): (int(s), int(e)) for d, s, e in zip(uniq, starts, ends)}
    return SparsePostings(dim_start, docs.astype(np.int32), vals.astype(np.float32), row_sums, nb)


def build_postings(rows: List[Dict[int, float]], drop_ratio_build: float = 0.0) -> SparsePostings:
    dims, vals, rids, row_sums = flatten_rows(rows)
    dims, vals, rids = _drop_build(dims, vals, rids, drop_ratio_build)
    return _dim_major(dims, rids, vals, len(rows), row_sums)


def bm25_transform(p: SparsePostings, k1: float, b: float, avgdl: float) -> np.ndarray:
    """Per-entry BM25 doc value from stored tf."""
    avgdl = max(avgdl, 1e-9)
    dl = p.row_sums[p.doc_ids]
    return (p.vals * (k1 + 1.0) / (p.vals + k1 * (1.0 - b + b * dl / avgdl))).astype(np.float32)


def _drop_items(row, drop_ratio_search: float):
    items = list(_row_items(row))
    if drop_ratio_search > 0 and items:
        absvals = np.abs(np.asarray([v for _, v in items], np.float32))
        thresh = np.quantile(absvals, drop_ratio_search)
        items = [(d, v) for d, v in items if abs(v) >= thresh]
    return items


# ---------------------------------------------------------------------------
# Segments of postings: assembled on the host, expanded on the device
# ---------------------------------------------------------------------------


class _Segments:
    """Host lists of posting segments [start, start + len) with the query
    row (of the chunk) and weight each belongs to."""

    def __init__(self) -> None:
        self.starts: list = []
        self.lens: list = []
        self.qids: list = []
        self.ws: list = []

    def add(self, start: int, length: int, qid: int, w: float) -> None:
        self.starts.append(start)
        self.lens.append(length)
        self.qids.append(qid)
        self.ws.append(w)

    def add_many(self, starts: np.ndarray, lens: np.ndarray, qid: int, w: float) -> None:
        self.starts.extend(starts.tolist())
        self.lens.extend(lens.tolist())
        self.qids.extend([qid] * len(lens))
        self.ws.extend([w] * len(lens))

    def __bool__(self) -> bool:
        return any(n > 0 for n in self.lens)


def _expand_segments(seg: _Segments) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(entry index, query row, weight) of every entry the segments cover,
    on the device, in segment order."""
    lens_h = np.asarray(seg.lens, np.int64)
    starts = to_device(np.asarray(seg.starts, np.int64))
    lens = to_device(lens_h)
    qids = to_device(np.asarray(seg.qids, np.int64))
    ws = to_device(np.asarray(seg.ws, np.float32))
    total = int(lens_h.sum())
    owner = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens  # each segment's first position
    entry = starts[owner] + (torch.arange(total, device=lens.device) - first[owner])
    return entry, qids[owner], ws[owner]


def _query_segments(dim_start, q_rows, s0: int, e0: int, drop_ratio_search: float) -> _Segments:
    seg = _Segments()
    for qi in range(s0, e0):
        for d, v in _drop_items(q_rows[qi], drop_ratio_search):
            slot = dim_start.get(int(d))
            if slot is not None:
                seg.add(slot[0], slot[1] - slot[0], qi - s0, v)
    return seg


def _finish(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Filtered columns and scores <= 0 (no overlap) -> -inf."""
    if mask is not None:
        scores = torch.where(mask[None, :], scores, _NEG_INF)
    return torch.where(scores > 0, scores, _NEG_INF)


def _topk(scores: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Leftmost top-k of finished scores -> host (scores, ids), -1 where
    -inf."""
    s, i = topk_leftmost(scores, k)
    i = torch.where(s == _NEG_INF, -1, i)
    return s.cpu().numpy(), i.cpu().numpy().astype(np.int64)


def _scatter_postings(scores, doc_ids_dev, vals_dev, seg: _Segments, tail_bits: int = 0) -> None:
    """scores[q, doc] += w * val over every entry of the segments."""
    entry, qid, w = _expand_segments(seg)
    if tail_bits:
        docs = unpack_gather(doc_ids_dev, entry, tail_bits)
    else:
        docs = doc_ids_dev[entry].to(torch.int64)
        if doc_ids_dev.dtype == torch.int16:  # u16 ids held as their int16 bits
            docs &= 0xFFFF
    contrib = w * vals_dev[entry].to(torch.float32)
    scores.index_put_((qid, docs), contrib, accumulate=True)


def _score_postings(doc_ids_dev, vals_dev, seg, mask, nqc: int, nb: int) -> torch.Tensor:
    scores = torch.zeros((nqc, nb), dtype=torch.float32, device=vals_dev.device)
    _scatter_postings(scores, doc_ids_dev, vals_dev, seg)
    return _finish(scores, mask)


def _device_topk(doc_ids_dev, vals_dev, seg, mask, nqc: int, nb: int, k: int):
    """One scatter-add and top-k over the segments' postings -> host
    ((nqc, k) scores, (nqc, k) ids)."""
    return _topk(_score_postings(doc_ids_dev, vals_dev, seg, mask, nqc, nb), k)


def sparse_full_scores(
    postings: SparsePostings,
    vals_dev: torch.Tensor,
    doc_ids_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Exact scores for every document: (nq, nb) f32, -inf where no
    overlap (the reference's BF-scores iterator, sparse_index_node.cc:254)."""
    nq, nb = len(q_rows), postings.nb
    out = np.full((nq, nb), -np.inf, np.float32)
    q_chunk = min(1024, max(16, (256 << 20) // max(nb * 4, 1)))
    for s0 in range(0, nq, q_chunk):
        check_current_cancellation()
        e0 = min(s0 + q_chunk, nq)
        seg = _query_segments(postings.dim_start, q_rows, s0, e0, drop_ratio_search)
        if not seg:
            continue
        out[s0:e0] = _score_postings(doc_ids_dev, vals_dev, seg, mask, e0 - s0, nb).cpu().numpy()
    return out


def sparse_search(
    postings: SparsePostings,
    vals_dev: torch.Tensor,
    doc_ids_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    k: int,
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    q_chunk: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """The postings engine: (scores (nq,k) f32, ids (nq,k) int64, -1 padded)."""
    nq, nb = len(q_rows), postings.nb
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    kk = min(k, nb)
    # the dense (chunk, nb) accumulator stays under 256 MB
    q_chunk = max(q_chunk, min(1024, max(64, (256 << 20) // max(nb * 4, 1))))
    for s0 in range(0, nq, q_chunk):
        check_current_cancellation()
        e0 = min(s0 + q_chunk, nq)
        seg = _query_segments(postings.dim_start, q_rows, s0, e0, drop_ratio_search)
        if not seg:
            continue
        out_s[s0:e0, :kk], out_i[s0:e0, :kk] = _device_topk(doc_ids_dev, vals_dev, seg, mask, e0 - s0, nb, kk)
    return out_s, out_i


def _padded_mask(mask: Optional[torch.Tensor], n_pad: int) -> Optional[torch.Tensor]:
    """A keep mask of >= nb rows widened to n_pad rows (the pad rows
    filtered)."""
    if mask is None:
        return None
    out = torch.zeros(n_pad, dtype=torch.bool, device=mask.device)
    out[: mask.shape[0]] = mask
    return out


# ---------------------------------------------------------------------------
# Padded doc-major engine (TAAT_NAIVE)
# ---------------------------------------------------------------------------


@dataclass
class PaddedDocs:
    """Doc-major padded storage with remapped dims."""

    dims_pad: np.ndarray  # (nb_pad, L) int32, remapped; sentinel = n_dims
    vals_pad: np.ndarray  # (nb_pad, L) f32 raw term weights; 0 at padding
    dim_map: Dict[int, int]  # original dim id -> remapped [0, n_dims)
    n_dims: int
    L: int
    nb: int  # true rows (nb_pad >= nb, sentinel rows beyond)
    row_sums: np.ndarray  # (nb_pad,) f32 document lengths (for BM25)


def build_padded_docs(
    rows: List[Dict[int, float]],
    drop_ratio_build: float = 0.0,
    max_pad_ratio: float = 4.0,
    max_elements: int = 64 << 20,
) -> Optional[PaddedDocs]:
    """None when the length distribution makes padding pathological (max
    nnz > max(max_pad_ratio * p99, 256)), the padded matrix would pass
    max_elements, or the vocabulary passes 2**17 dims (the dense query
    matrix a chunk uploads): the caller takes another engine."""
    nb = len(rows)
    if nb == 0:
        return None
    lens = np.fromiter((len(k) for k in map(_keys, rows)), np.int64, nb)
    max_len = int(lens.max(initial=0))
    if max_len == 0:
        return None
    p99 = float(np.quantile(lens, 0.99))
    if max_len > max(max_pad_ratio * p99, 256):
        return None
    L_est = max(8, -(-max_len // 8) * 8)
    if (nb + 256) * L_est > max_elements:
        return None
    dims, vals, rids, row_sums_all = flatten_rows(rows)
    dims, vals, rids = _drop_build(dims, vals, rids, drop_ratio_build)
    uniq = np.unique(dims)
    n_dims = int(uniq.size)
    if n_dims > (1 << 17):
        return None
    dim_map = {int(d): i for i, d in enumerate(uniq)}
    remapped = np.searchsorted(uniq, dims).astype(np.int32)
    counts = np.bincount(rids, minlength=nb)
    L = int(counts.max(initial=1))
    L = max(8, -(-L // 8) * 8)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(dims.size, dtype=np.int64) - np.repeat(starts, counts)
    nb_pad = max(256, -(-nb // 256) * 256)
    dims_pad = np.full((nb_pad, L), n_dims, np.int32)
    vals_pad = np.zeros((nb_pad, L), np.float32)
    dims_pad[rids, slot] = remapped
    vals_pad[rids, slot] = vals
    row_sums = np.zeros(nb_pad, np.float32)
    row_sums[:nb] = row_sums_all
    return PaddedDocs(dims_pad, vals_pad, dim_map, n_dims, L, nb, row_sums)


def padded_bm25_vals(p: PaddedDocs, k1: float, b: float, avgdl: float) -> np.ndarray:
    """BM25 doc-value transform of vals_pad (reference sparse_utils.h)."""
    avgdl = max(avgdl, 1e-9)
    dl = p.row_sums[:, None]
    tf = p.vals_pad
    out = tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl / avgdl))
    return np.where(tf > 0, out, 0.0).astype(np.float32)


def _pick_block_w(L: int, nqc: int, nb_pad: int, budget_bytes: int = 128 << 20) -> int:
    """Largest W that divides nb_pad (a multiple of 256), is a multiple of
    256, and keeps the (W, L, nqc) gather under budget."""
    target = int(np.clip((budget_bytes // max(L * nqc * 4, 1)) // 256 * 256, 256, 16384))
    w = min(target, nb_pad)
    while w > 256 and nb_pad % w:
        w -= 256
    return max(w, 256)


def densify_queries(padded: PaddedDocs, q_rows, s0: int, e0: int, drop_ratio_search: float) -> np.ndarray:
    """(n_dims+1, e0-s0) dense transposed query matrix; the sentinel row
    (n_dims) is zero."""
    QT = np.zeros((padded.n_dims + 1, e0 - s0), np.float32)
    for ci, qi in enumerate(range(s0, e0)):
        for d, v in _drop_items(q_rows[qi], drop_ratio_search):
            r = padded.dim_map.get(int(d))
            if r is not None:
                QT[r, ci] += v
    return QT


def _padded_block(dims_dev, vals_dev, QT, keep, r0: int, W: int) -> torch.Tensor:
    """(nqc, W) finished scores of rows [r0, r0 + W)."""
    d = dims_dev[r0 : r0 + W].to(torch.int64)
    L, nqc = d.shape[1], QT.shape[1]
    g = QT[d.reshape(-1)].reshape(W, L, nqc)
    sb = torch.einsum("wln,wl->nw", g, vals_dev[r0 : r0 + W])
    return _finish(sb, None if keep is None else keep[r0 : r0 + W])


def sparse_search_padded(
    padded: PaddedDocs,
    dims_dev: torch.Tensor,
    vals_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    k: int,
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exhaustive exact scan in blocks of W rows with a running top-k pool
    (the pool before the block's columns, so earlier ids win ties)."""
    nq = len(q_rows)
    nb_pad = padded.dims_pad.shape[0]
    kk = min(k, padded.nb)
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    keep = _padded_mask(mask, nb_pad)
    dev = dims_dev.device
    for s0 in range(0, nq, 256):
        check_current_cancellation()
        e0 = min(s0 + 256, nq)
        nqc = e0 - s0
        W = _pick_block_w(padded.L, nqc, nb_pad)
        QT = to_device(densify_queries(padded, q_rows, s0, e0, drop_ratio_search))
        pool_s = torch.full((nqc, kk), _NEG_INF, dtype=torch.float32, device=dev)
        pool_i = torch.full((nqc, kk), -1, dtype=torch.int64, device=dev)
        for r0 in range(0, nb_pad, W):
            sb = _padded_block(dims_dev, vals_dev, QT, keep, r0, W)
            ids_b = torch.arange(r0, r0 + W, device=dev).expand(nqc, W)
            pool_s, sel = topk_leftmost(torch.cat([pool_s, sb], 1), kk)
            pool_i = torch.gather(torch.cat([pool_i, ids_b], 1), 1, sel)
        pool_i = torch.where(torch.isfinite(pool_s), pool_i, -1)
        out_s[s0:e0, :kk] = pool_s.cpu().numpy()
        out_i[s0:e0, :kk] = pool_i.cpu().numpy()
    return out_s, out_i


def sparse_full_scores_padded(
    padded: PaddedDocs,
    dims_dev: torch.Tensor,
    vals_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Exact (nq, nb) scores, -inf = no overlap / filtered."""
    nq = len(q_rows)
    nb_pad = padded.dims_pad.shape[0]
    out = np.full((nq, padded.nb), -np.inf, np.float32)
    q_chunk = min(256, max(16, (256 << 20) // max(nb_pad * 4, 1)))
    keep = _padded_mask(mask, nb_pad)
    for s0 in range(0, nq, q_chunk):
        check_current_cancellation()
        e0 = min(s0 + q_chunk, nq)
        W = _pick_block_w(padded.L, e0 - s0, nb_pad)
        QT = to_device(densify_queries(padded, q_rows, s0, e0, drop_ratio_search))
        blocks = [_padded_block(dims_dev, vals_dev, QT, keep, r0, W) for r0 in range(0, nb_pad, W)]
        out[s0:e0] = torch.cat(blocks, 1)[:, : padded.nb].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Hybrid head/tail engine (the default exact scorer)
#
# The vocabulary is split by posting length: the top-F dims by nnz (where
# the Zipf mass lives, and whose postings WAND cannot skip) form a dense
# (F, nb_pad) slab scored by one f32 product a query chunk; the other dims
# stay postings, short by construction, scatter-added on top. Exact at any
# drop_ratio_search (the drop filters query terms only, as in the
# reference, sparse_index_config.h:97-126).
# ---------------------------------------------------------------------------


@dataclass
class HybridSlab:
    """Frequency-split storage: dense head slab + CSR tail postings."""

    head_dims: np.ndarray  # (F,) original dim ids, nnz-descending
    head_map: Dict[int, int]  # original dim id -> slab row
    slab: np.ndarray  # (F, nb_pad) f32 raw term values; 0 = absent
    tail: SparsePostings  # postings restricted to tail dims
    row_sums: np.ndarray  # (nb,) f32 document lengths (full rows, for BM25)
    nb: int
    nb_pad: int
    F: int
    head_nnz: int  # entries covered by the slab
    total_nnz: int
    tail_bits: int = 0  # >0: resident tail ids are a pack_fixed u32 stream
    vals_bf16: bool = False  # resident values stored bf16 (gated rescore)


def build_hybrid_slab(
    rows: List[Dict[int, float]],
    drop_ratio_build: float = 0.0,
    budget_bytes: int = 512 << 20,
) -> Optional[HybridSlab]:
    """None when the corpus has no entries. F fits the slab budget, is a
    multiple of 128 and at most 4,096."""
    nb = len(rows)
    if nb == 0:
        return None
    dims, vals, rids, row_sums = flatten_rows(rows)
    if not dims.size:
        return None
    dims, vals, rids = _drop_build(dims, vals, rids, drop_ratio_build)
    uniq, counts = np.unique(dims, return_counts=True)
    n_dims = int(uniq.size)
    nb_pad = max(256, -(-nb // 256) * 256)
    f_budget = max(128, int(budget_bytes // (4 * nb_pad)) // 128 * 128)
    F = min(-(-n_dims // 128) * 128, f_budget, 4096)
    order = np.argsort(-counts, kind="stable")
    head_dims = uniq[order[: min(n_dims, F)]]
    head_map = {int(d): i for i, d in enumerate(head_dims)}
    is_head = np.isin(dims, head_dims)
    slab = np.zeros((F, nb_pad), np.float32)
    hsel = np.nonzero(is_head)[0]
    if hsel.size:
        sorted_to_slot = np.argsort(head_dims, kind="stable")
        slab[sorted_to_slot[np.searchsorted(np.sort(head_dims), dims[hsel])], rids[hsel]] = vals[hsel]
    tsel = np.nonzero(~is_head)[0]
    tail = _dim_major(dims[tsel], rids[tsel], vals[tsel], nb, row_sums)
    return HybridSlab(head_dims, head_map, slab, tail, row_sums, nb, nb_pad, F, int(hsel.size), int(dims.size))


def hybrid_bm25_slab(h: HybridSlab, k1: float, b: float, avgdl: float) -> np.ndarray:
    """BM25 doc-value transform of the head slab (sparse_utils.h computer)."""
    avgdl = max(avgdl, 1e-9)
    dl = np.zeros(h.nb_pad, np.float32)
    dl[: h.nb] = h.row_sums
    tf = h.slab
    out = tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl[None, :] / avgdl))
    return np.where(tf > 0, out, 0.0).astype(np.float32)


def _hybrid_chunk(h: HybridSlab, q_rows, s0: int, e0: int, drop_ratio_search: float):
    """A chunk's head weights as a dense (nqc, F) host matrix and its tail
    postings as segments."""
    Qh = np.zeros((e0 - s0, h.F), np.float32)
    seg = _Segments()
    for ci, qi in enumerate(range(s0, e0)):
        for d, v in _drop_items(q_rows[qi], drop_ratio_search):
            slot = h.head_map.get(int(d))
            if slot is not None:
                Qh[ci, slot] += np.float32(v)
                continue
            rng = h.tail.dim_start.get(int(d))
            if rng is not None:
                seg.add(rng[0], rng[1] - rng[0], ci, v)
    return Qh, seg


def _hybrid_scores(slab_dev, tail_vals_dev, tail_ids_dev, Qh, seg, keep, tail_bits: int) -> torch.Tensor:
    """Finished (nqc, nb_pad) scores of a chunk: the head product in f32,
    over column blocks of the (possibly bf16) slab widened one at a time,
    then the tail's scatter-add."""
    q = to_device(Qh)
    nb_pad = slab_dev.shape[1]
    scores = torch.empty((q.shape[0], nb_pad), dtype=torch.float32, device=q.device)
    for c0 in range(0, nb_pad, HEAD_BLOCK_COLS):
        c1 = min(c0 + HEAD_BLOCK_COLS, nb_pad)
        scores[:, c0:c1] = q @ slab_dev[:, c0:c1].to(torch.float32)
    if seg:
        _scatter_postings(scores, tail_ids_dev, tail_vals_dev, seg, tail_bits)
    return _finish(scores, keep)


def sparse_search_hybrid(
    h: HybridSlab,
    slab_dev: torch.Tensor,
    tail_vals_dev: torch.Tensor,
    tail_doc_ids_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    k: int,
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    tail_bits: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact head product + tail scatter. ((nq,k) f32, (nq,k) int64 ids)."""
    nq = len(q_rows)
    kk = min(k, h.nb)
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    keep = _padded_mask(mask, h.nb_pad)
    for s0 in range(0, nq, 256):
        check_current_cancellation()
        e0 = min(s0 + 256, nq)
        Qh, seg = _hybrid_chunk(h, q_rows, s0, e0, drop_ratio_search)
        scores = _hybrid_scores(slab_dev, tail_vals_dev, tail_doc_ids_dev, Qh, seg, keep, tail_bits)
        out_s[s0:e0, :kk], out_i[s0:e0, :kk] = _topk(scores, kk)
    return out_s, out_i


def sparse_full_scores_hybrid(
    h: HybridSlab,
    slab_dev: torch.Tensor,
    tail_vals_dev: torch.Tensor,
    tail_doc_ids_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    tail_bits: int = 0,
) -> np.ndarray:
    """Exact (nq, nb) scores via the head/tail split, -inf = no overlap."""
    nq = len(q_rows)
    out = np.full((nq, h.nb), -np.inf, np.float32)
    keep = _padded_mask(mask, h.nb_pad)
    q_chunk = min(256, max(16, (256 << 20) // max(h.nb_pad * 4, 1)))
    for s0 in range(0, nq, q_chunk):
        check_current_cancellation()
        e0 = min(s0 + q_chunk, nq)
        Qh, seg = _hybrid_chunk(h, q_rows, s0, e0, drop_ratio_search)
        scores = _hybrid_scores(slab_dev, tail_vals_dev, tail_doc_ids_dev, Qh, seg, keep, tail_bits)
        out[s0:e0] = scores[:, : h.nb].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Windowed pruned search: the DAAT WAND / MaxScore / BlockMax / SINDI analog
#
# The doc axis is cut into windows of sindi_window_size docs; per-dim
# per-window posting maxima (block_max_data.h) bound each window's score,
#     U[w] = dim_max_score_ratio * sum_t q_t * window_max[t][w],
# and a query scans only the windows whose bound can reach its running
# threshold. Scanned windows are scored exactly by the postings engine, so
# with dim_max_score_ratio >= 1 and no term drop the result equals the
# exhaustive scan; a ratio < 1 prunes harder and may lose recall, as the
# reference documents (sparse_index_config.h:97-126).
# ---------------------------------------------------------------------------


@dataclass
class WindowMaxData:
    """Per-dim per-window posting maxima + entry spans (block-max data)."""

    W: int  # docs per window (clamped to [1024, 65535], sparse_index_config.h:158-162)
    n_windows: int
    # dim -> (window ids asc, window max val, entry start, entry end)
    per_dim: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]


def build_window_max(postings: SparsePostings, vals_host: np.ndarray, window_size: int) -> WindowMaxData:
    W = int(np.clip(window_size, 1024, 65535))
    n_windows = max(1, -(-postings.nb // W))
    per_dim: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = {}
    for d, (s, e) in postings.dim_start.items():
        wins = postings.doc_ids[s:e].astype(np.int64) // W  # docs ascend within a dim
        uwin, starts = np.unique(wins, return_index=True)
        ends = np.append(starts[1:], e - s)
        v = vals_host[s:e]
        wmax = np.maximum.reduceat(v, starts).astype(np.float32) if v.size else np.empty(0, np.float32)
        per_dim[int(d)] = (uwin.astype(np.int64), wmax, (starts + s).astype(np.int64), (ends + s).astype(np.int64))
    return WindowMaxData(W, n_windows, per_dim)


def _concat_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenated [starts[i], ends[i]) ranges as one int32 index array."""
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int32)
    ex = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.repeat(starts - ex, lens) + np.arange(total, dtype=np.int64)).astype(np.int32)


def _window_segments(wm: WindowMaxData, chunk_items, wsel: np.ndarray) -> _Segments:
    """Segments of each query's terms restricted to its selected windows
    (wsel: (nqc, n_windows) bool)."""
    seg = _Segments()
    for ci, items in enumerate(chunk_items):
        if not wsel[ci].any():
            continue
        for d, v in items:
            slot = wm.per_dim.get(int(d))
            if slot is None:
                continue
            uwin, _, st, en = slot
            pick = wsel[ci][uwin]
            if pick.any():
                seg.add_many(st[pick], en[pick] - st[pick], ci, v)
    return seg


def exact_rescore_pool(
    csr: Tuple[np.ndarray, np.ndarray, np.ndarray],
    q_rows,
    cand_ids: np.ndarray,  # (nq, pool) int64, -1 padded
    k: int,
    bm25: Optional[Tuple[float, float, float, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rescore each query's candidate pool exactly with the full query
    against the row-major CSR on the host, and return the top-k (the
    reference's refine pass, sparse_index_config.h:84-96). For BM25 pass
    (k1, b, avgdl, row_sums): the CSR holds raw term frequencies, and the
    rescore applies the BM25 doc-value transform per entry."""
    indptr, indices, values = csr
    nq = len(q_rows)
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    if bm25 is not None:
        k1, b, avgdl, row_sums = bm25
        avgdl = max(avgdl, 1e-9)
    for ci in range(nq):
        qitems = sorted(_row_items(q_rows[ci]))
        if not qitems:
            continue
        qd = np.asarray([d for d, _ in qitems], np.int64)
        qw = np.asarray([w for _, w in qitems], np.float32)
        cand = cand_ids[ci][cand_ids[ci] >= 0]
        if cand.size == 0:
            continue
        st = indptr[cand]
        en = indptr[cand + 1]
        eidx = _concat_ranges(st, en)
        owner = np.repeat(np.arange(cand.size), (en - st))
        dims_c = indices[eidx]
        pos = np.searchsorted(qd, dims_c)
        pos_c = np.clip(pos, 0, qd.size - 1)
        hit = qd[pos_c] == dims_c
        doc_vals = values[eidx]
        if bm25 is not None:
            dl = row_sums[cand[owner]]
            doc_vals = doc_vals * (k1 + 1.0) / (doc_vals + k1 * (1.0 - b + b * dl / avgdl))
        contrib = np.where(hit, doc_vals * qw[pos_c], 0.0)
        sc = np.zeros(cand.size, np.float32)
        np.add.at(sc, owner, contrib)
        order = np.argsort(-sc, kind="stable")[:k]
        nres = order.size
        out_s[ci, :nres] = sc[order]
        out_i[ci, :nres] = cand[order]
    return out_s, out_i


def sparse_search_pruned(
    postings: SparsePostings,
    vals_dev: torch.Tensor,
    doc_ids_dev: torch.Tensor,
    q_rows: List[Dict[int, float]],
    k: int,
    *,
    wmax: WindowMaxData,
    refine_factor: int = 1,
    dim_max_score_ratio: float = 1.05,
    drop_ratio_search: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    csr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    stats: Optional[dict] = None,
    bm25: Optional[Tuple[float, float, float, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Window-pruned scoring: per query, scan only the windows whose bound
    reaches the running threshold; refine_factor widens the first pass and
    (with drop_ratio_search > 0) triggers an exact full-query rescore of the
    top refine_factor*k candidates against the row-major CSR."""
    nq = len(q_rows)
    nb = postings.nb
    nw = wmax.n_windows
    rf = max(int(refine_factor), 1)
    ratio = float(dim_max_score_ratio)
    k_out = min(max(k * rf, k), nb)
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    q_chunk = min(256, max(16, (128 << 20) // max(nb * 4, 1)))
    n_scanned_a = n_scanned_b = 0
    for s0 in range(0, nq, q_chunk):
        check_current_cancellation()
        e0 = min(s0 + q_chunk, nq)
        nqc = e0 - s0
        chunk_items = [_drop_items(q_rows[qi], drop_ratio_search) for qi in range(s0, e0)]
        bounds = np.zeros((nqc, nw), np.float32)
        for ci, items in enumerate(chunk_items):
            for d, v in items:
                slot = wmax.per_dim.get(int(d))
                if slot is not None:
                    bounds[ci, slot[0]] += v * slot[1]
        bounds *= ratio

        # phase A: the top-bound windows, with room for the refine pool
        n_sel = min(nw, max(1, -(-max(4 * k_out, 2048) // wmax.W)))
        selA = np.argsort(-bounds, axis=1, kind="stable")[:, :n_sel]
        wselA = np.zeros((nqc, nw), bool)
        for ci in range(nqc):
            wselA[ci, selA[ci][bounds[ci, selA[ci]] > 0]] = True
        n_scanned_a += int(wselA.sum())
        seg = _window_segments(wmax, chunk_items, wselA)
        if not seg:
            continue
        sA, iA = _device_topk(doc_ids_dev, vals_dev, seg, mask, nqc, nb, k_out)

        # phase B: the other windows whose bound reaches the pool's k_out-th
        # score (not the k-th: the refine pass reorders the whole pool)
        kth = sA[:, min(k_out, sA.shape[1]) - 1].copy()
        kth[~np.isfinite(kth)] = -np.inf
        need_b = (bounds >= kth[:, None]) & ~wselA & (bounds > 0)
        if need_b.any():
            n_scanned_b += int(need_b.sum())
            seg = _window_segments(wmax, chunk_items, need_b)
            if seg:
                sB, iB = _device_topk(doc_ids_dev, vals_dev, seg, mask, nqc, nb, k_out)
                cat_s = np.concatenate([sA, sB], axis=1)
                cat_i = np.concatenate([iA, iB], axis=1)
                key = np.where(cat_i >= 0, cat_s, -np.inf)
                order = np.argsort(-key, axis=1, kind="stable")[:, :k_out]
                sA = np.take_along_axis(cat_s, order, 1)
                iA = np.take_along_axis(cat_i, order, 1)

        # refine: exact full-query rescore of the pool (only the query-term
        # drop made scores approximate; window scans are exact)
        if rf > 1 and drop_ratio_search > 0 and csr is not None:
            out_s[s0:e0], out_i[s0:e0] = exact_rescore_pool(csr, q_rows[s0:e0], iA, k, bm25=bm25)
            continue
        kk = min(k, sA.shape[1])
        out_s[s0:e0, :kk] = sA[:, :kk]
        out_i[s0:e0, :kk] = iA[:, :kk]
    if stats is not None:
        stats["windows_scanned_a"] = n_scanned_a
        stats["windows_scanned_b"] = n_scanned_b
        stats["windows_total"] = nq * nw
        stats["n_windows"] = nw
        stats["window_size"] = wmax.W
    return out_s, out_i
