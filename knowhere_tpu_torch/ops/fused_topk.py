"""Single-pass flat kNN scan (counterpart of knowhere_tpu/ops/pallas_topk.py).

``fused_knn_scan`` scores every corpus row against every query in one bf16
pass (q and the rows rounded to bf16, products and sums in f32), score
``2*dot - norms`` for L2 or ``dot - norms`` for IP (norms are 0 for real IP
rows, 1e38 for pad rows), and keeps the top-k per query with the smaller row
id winning among equal scores; a slot whose score is <= -1e38/2 gets id -1.
For CUDA tensors it launches the kernel of csrc/fused_knn.cu (a partial scan
per corpus split, then a merge of the splits' lists) and counts the call in
``fused_knn_scan.launches``; for CPU tensors it runs
``fused_knn_scan_plain``. ``fused_knn`` is the host wrapper (the reference's
``pallas_knn``): numpy queries in, numpy distances and int64 ids out.

This is the exact FLAT scan's single-pass baseline: no index path calls it,
as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from . import cuda_build
from .topk import topk_leftmost

NEG_INF = -1e38
ROW_TILE = 64  # corpus rows per kernel tile: the corpus is padded to it
FEAT_CHUNK = 32  # the kernel stages features in chunks of 32
MAX_K = 1024
_MAX_SPLITS = 128
_PLAIN_ROWS = 65536  # corpus rows per step of the plain version
_PART_BYTES = 256 << 20  # bound on the (splits, nq, k) partial lists
_QUERY_CHUNK = 16384  # queries per fused_knn_scan call of fused_knn


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).float()


def fused_knn_scan_plain(q, base, norms, *, k: int, is_l2: bool):
    """Plain PyTorch version: bf16-rounded q and rows, f32 product, a running
    top-k over corpus tiles (the running list first, so the smaller id wins
    ties). Returns (scores (nq,k) f32, ids (nq,k) int32)."""
    nq = q.shape[0]
    a = 2.0 if is_l2 else 1.0
    qb = _bf16(q)
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for r0 in range(0, base.shape[0], _PLAIN_ROWS):
        tile = _bf16(base[r0 : r0 + _PLAIN_ROWS])
        s = a * (qb @ tile.T) - norms[r0 : r0 + _PLAIN_ROWS].float()[None, :]
        ids = torch.arange(r0, r0 + tile.shape[0], device=q.device)
        cat_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_s, sel = topk_leftmost(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(cat_i, 1, sel)
    best_i = torch.where(best_s <= NEG_INF / 2, torch.full_like(best_i, -1), best_i)
    return best_s, best_i.int()


def _splits(n_tiles: int, nq_pad: int, k: int) -> Tuple[int, int]:
    """(rows per split, splits): about 2,048 partial blocks in all, the
    partial lists under _PART_BYTES."""
    q_blocks = nq_pad // ROW_TILE
    want = max(1, min(n_tiles, _MAX_SPLITS, -(-2048 // q_blocks), _PART_BYTES // (nq_pad * k * 8)))
    tiles_per = -(-n_tiles // want)
    return tiles_per * ROW_TILE, -(-n_tiles // tiles_per)


def fused_knn_scan(
    q: torch.Tensor,  # (nq, d) f32
    base: torch.Tensor,  # (nb, d) f32, nb a multiple of ROW_TILE (pad rows norm 1e38)
    norms: torch.Tensor,  # (nb,) f32: |b|^2 for L2, zeros for IP
    *,
    k: int,
    is_l2: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per query: (scores (nq,k) larger-is-better f32, ids (nq,k) int32)."""
    if not q.is_cuda:
        return fused_knn_scan_plain(q, base, norms, k=k, is_l2=is_l2)
    nb, d = base.shape
    nq = q.shape[0]
    if nb % ROW_TILE or d % FEAT_CHUNK or q.shape[1] != d or not 1 <= k <= MAX_K:
        raise ValueError(f"fused_knn_scan: bad shape nb={nb} d={d} k={k} (nb % {ROW_TILE}, d % {FEAT_CHUNK})")
    if base.dtype != torch.float32 or norms.dtype != torch.float32 or norms.shape != (nb,):
        raise TypeError("fused_knn_scan takes an f32 base (nb, d) and f32 norms (nb,)")
    if base.device != q.device or norms.device != q.device:
        raise ValueError("fused_knn_scan: base and norms must lie on the query's device")
    nq_pad = -(-max(nq, 1) // ROW_TILE) * ROW_TILE
    qp = torch.nn.functional.pad(q.float(), (0, 0, 0, nq_pad - nq)).contiguous()
    base, norms = base.contiguous(), norms.contiguous()
    rows_per, n_splits = _splits(nb // ROW_TILE, nq_pad, k)
    part_s = torch.empty((n_splits, nq_pad, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((n_splits, nq_pad, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_fused_knn(
        p(base), p(norms), p(qp), p(part_s), p(part_i), p(out_s), p(out_i),
        nb, nq, nq_pad, d, k, rows_per, n_splits, 2.0 if is_l2 else 1.0, cuda_build.stream_of(q),
    )
    cuda_build.check(code, "fused_knn_scan")
    fused_knn_scan.launches += 1
    return out_s, out_i


fused_knn_scan.launches = 0


def pad_base(base: torch.Tensor, norms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad rows to a ROW_TILE multiple (zero rows with norm 1e38, which never
    win) and features to a FEAT_CHUNK multiple (zero columns leave every dot
    unchanged)."""
    nb, d = base.shape
    pr, pc = (-nb) % ROW_TILE, (-d) % FEAT_CHUNK
    base = torch.nn.functional.pad(base.float(), (0, pc, 0, pr))
    norms = torch.nn.functional.pad(norms.float(), (0, pr), value=1e38)
    return base, norms


def host_result(s: torch.Tensor, i: torch.Tensor, q: np.ndarray, nb: int, is_l2: bool):
    """The scan's (scores, ids) as fused_knn returns them: numpy distances in
    the metric's convention and int64 ids; ids of pad rows and empty slots
    are -1 with distance inf (L2) or -inf (IP)."""
    s = s.cpu().numpy()
    i = i.cpu().numpy().astype(np.int64)
    i = np.where(i >= nb, -1, i)  # padded rows
    if is_l2:
        qsq = np.sum(q.astype(np.float64) ** 2, axis=1).astype(np.float32)
        dists = qsq[:, None] - s
    else:
        dists = s
    dists = np.where(i >= 0, dists, np.float32(np.inf if is_l2 else -np.inf))
    return dists, i


def fused_knn(
    q: np.ndarray,
    base: torch.Tensor,
    k: int,
    metric: str,
    norms: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper (the reference's ``pallas_knn``): pads the corpus, runs
    the scan, returns numpy (dists native convention, ids int64); ids of pad
    rows and empty slots are -1 with distance inf (L2) or -inf (IP)."""
    metric = metric.upper()
    is_l2 = metric == "L2"
    nb, d = base.shape
    if norms is None:
        b = base.float()
        norms = (b * b).sum(1) if is_l2 else torch.zeros(nb, dtype=torch.float32, device=base.device)
    base_p, norms_p = pad_base(base, norms)
    q = np.asarray(q, dtype=np.float32)
    s_parts, i_parts = [], []
    for s0 in range(0, q.shape[0], _QUERY_CHUNK):
        qc = to_device(q[s0 : s0 + _QUERY_CHUNK])
        qc = torch.nn.functional.pad(qc, (0, base_p.shape[1] - d))
        sc, ic = fused_knn_scan(qc, base_p, norms_p, k=k, is_l2=is_l2)
        s_parts.append(sc)
        i_parts.append(ic)
    return host_result(torch.cat(s_parts), torch.cat(i_parts), q, nb, is_l2)
