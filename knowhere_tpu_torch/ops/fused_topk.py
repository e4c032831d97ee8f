"""Single-pass flat kNN scan (counterpart of knowhere_tpu/ops/pallas_topk.py).

``fused_knn_scan`` scores every corpus row against every query in one bf16
pass (q and the rows rounded to bf16, products and sums in f32), score
``2*dot - norms`` for L2 or ``dot - norms`` for IP (norms are 0 for real IP
rows, 1e38 for pad rows), and keeps the top-k per query with the smaller row
id winning among equal scores; a slot whose score is <= -1e38/2 gets id -1.
For CUDA tensors it runs ``fused_knn_blocks``: per block of at most
``cuda_flat.NQ_BLOCK`` queries, the single-pass instance of FLAT's
tensor-core group-max kernel, FLAT's group select at kg = min(k, groups) and
a rescore kernel over the winning groups' rows (csrc/flat_scan.cu; the
top-k rows lie in the top-k 16-row groups, ties included), and counts the
call in ``fused_knn_scan.launches``; for CPU tensors it runs
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
from . import cuda_flat
from .topk import topk_leftmost

NEG_INF = -1e38
ROW_TILE = 128  # corpus rows per kernel tile: the corpus is padded to it
FEAT_CHUNK = 128  # the kernels take features in chunks of 128
MAX_K = 1024
GMAX_BYTES = 256 << 20  # bound on a query block's (queries, nb/16) f32 group maxima
_PLAIN_ROWS = 65536  # corpus rows per step of the plain version


def fused_knn_scan_plain(q, base, norms, *, k: int, is_l2: bool):
    """Plain PyTorch version: bf16-rounded q and rows, f32 product, a running
    top-k over corpus tiles (the running list first, so the smaller id wins
    ties). Returns (scores (nq,k) f32, ids (nq,k) int32)."""
    nq = q.shape[0]
    a = 2.0 if is_l2 else 1.0
    qb = cuda_flat.bf16_round(q)
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for r0 in range(0, base.shape[0], _PLAIN_ROWS):
        tile = cuda_flat.bf16_round(base[r0 : r0 + _PLAIN_ROWS])
        s = a * (qb @ tile.T) - norms[r0 : r0 + _PLAIN_ROWS].float()[None, :]
        ids = torch.arange(r0, r0 + tile.shape[0], device=q.device)
        cat_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_s, sel = topk_leftmost(torch.cat([best_s, s], dim=1), k)
        best_i = torch.gather(cat_i, 1, sel)
    best_i = torch.where(best_s <= NEG_INF / 2, torch.full_like(best_i, -1), best_i)
    return best_s, best_i.int()


def query_block(nb_pad: int) -> int:
    """Queries a block of ``fused_knn_blocks`` over nb_pad corpus rows:
    ``cuda_flat.NQ_BLOCK``, or fewer (whole 128-query tiles of the kernel)
    so that its group maxima stay under GMAX_BYTES: 1,024 up to about 1M
    rows; one tile from about 8M rows, whose maxima then grow past it."""
    per_query = nb_pad // cuda_flat.GROUP * 4
    return min(cuda_flat.NQ_BLOCK, max(128, GMAX_BYTES // per_query // 128 * 128))


def fused_knn_blocks(q, base, norms, *, k: int, is_l2: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan as three launches per block of ``query_block(nb)`` queries:
    the single-pass group max, the select of the top kg = min(k, nb/16)
    groups, and the rescore of their rows. On CPU tensors each launch's
    plain version runs."""
    a = 2.0 if is_l2 else 1.0
    kg = min(k, base.shape[0] // cuda_flat.GROUP)
    nq = q.shape[0]
    if nq == 0:
        return torch.empty((0, k), dtype=torch.float32, device=q.device), torch.empty(
            (0, k), dtype=torch.int32, device=q.device
        )
    block = query_block(base.shape[0])
    s_parts, i_parts = [], []
    for s0 in range(0, nq, block):
        qb = q[s0 : s0 + block]
        _, gids = cuda_flat.fused_group_scan(base, norms, qb, kg, a)
        s, i = cuda_flat.fused_rescore(qb, base, norms, gids, k, a)
        s_parts.append(s)
        i_parts.append(i)
    return torch.cat(s_parts), torch.cat(i_parts)


def fused_knn_scan(
    q: torch.Tensor,  # (nq, d) f32
    base: torch.Tensor,  # (nb, d) f32, nb a multiple of ROW_TILE, d of FEAT_CHUNK (pad rows norm 1e38)
    norms: torch.Tensor,  # (nb,) f32: |b|^2 for L2, zeros for IP
    *,
    k: int,
    is_l2: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per query: (scores (nq,k) larger-is-better f32, ids (nq,k) int32)."""
    if not q.is_cuda:
        return fused_knn_scan_plain(q, base, norms, k=k, is_l2=is_l2)
    nb, d = base.shape
    if nb % ROW_TILE or d % FEAT_CHUNK or q.shape[1] != d or not 1 <= k <= MAX_K:
        raise ValueError(f"fused_knn_scan: bad shape nb={nb} d={d} k={k} (nb % {ROW_TILE}, d % {FEAT_CHUNK})")
    if base.dtype != torch.float32 or norms.dtype != torch.float32 or norms.shape != (nb,):
        raise TypeError("fused_knn_scan takes an f32 base (nb, d) and f32 norms (nb,)")
    if base.device != q.device or norms.device != q.device:
        raise ValueError("fused_knn_scan: base and norms must lie on the query's device")
    out = fused_knn_blocks(q.float().contiguous(), base.contiguous(), norms.contiguous(), k=k, is_l2=is_l2)
    fused_knn_scan.launches += 1
    return out


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
    qd = torch.nn.functional.pad(to_device(q), (0, base_p.shape[1] - d))
    s, i = fused_knn_scan(qd, base_p, norms_p, k=k, is_l2=is_l2)
    return host_result(s, i, q, nb, is_l2)
