"""Two-phase exact brute-force kNN (counterpart of
knowhere_tpu/ops/pallas_flat.py).

Phase 1 (``flat_group_scan``, CUDA kernel csrc/flat_scan.cu): scores
``a*<x,q> - |x|^2`` (a=2 L2, 1 IP) over the corpus with the reference's
three-pass hi/lo bf16 product, the max of each GROUP=16 consecutive rows, and
the top-k groups by that maximum per query. The kernel splits the f32 corpus
into hi/lo bf16 as it stages it, and reads the queries as a bf16 tile image
(``query_operand``) that the wrapper builds once a launch.

Phase 2 (torch): gather the k winning groups per query (16 contiguous rows
each), rescore them exactly in f32 and take the final top-k of the k*16
candidates.

Exactness: every true top-k row lies in a group whose max is >= the k-th
best score, and at most k groups hold such rows, so the top-k groups by
group max cover the true top-k (ties at the k-th value carry the same
latitude as the reference's heap).

The single-pass fused scan (ops/fused_topk.py) runs the same pieces at the
reference's single bf16 pass: ``fused_group_scan`` (the group-max kernel's
single-pass instance on the queries' hi-only image ``query_operand_hi``,
then ``flat_select``) and ``fused_rescore`` (a CUDA kernel: the winning
groups' rows rounded to bf16, scored and selected with the lower row id
winning ties). On CPU tensors both run their plain versions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import to_device
from . import cuda_build
from .topk import topk_leftmost

NEG_INF = -1e38
TILE = 2048  # corpus padding unit (kept from the reference layout)
GROUP = 16
NQ_BLOCK = 1024  # queries per phase-1 call; bounds the (NQ_BLOCK, nb/16) group maxima
_OP_ROWS = 128  # rows of one operand tile: the kernel's corpus and query tiles
_CHUNK = 128  # features per operand chunk (d is padded to it)
_PLAIN_ROWS = 65536  # corpus rows per chunk of the plain phase 1


def hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 hi part and bf16 lo residual of x, both returned as f32."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi, lo


def split_operand(x: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's operand image of x (R, d) f32, R % 128 == 0,
    d % 128 == 0: (R/128, d/128, 32, 128, 8) bf16. For each tile of 128
    rows and each 128-feature chunk, 32 slices of 8 features -- the chunk's
    16 hi slices, then its 16 lo slices (``hi_lo``) -- each slice holding
    the tile's rows one after another (wgmma's K-major core matrices without
    swizzle, csrc/wgmma_common.cuh)."""
    R, d = x.shape
    rows = _OP_ROWS
    if R % rows or d % _CHUNK:
        raise ValueError(f"split_operand: ({R}, {d}) is not a multiple of ({rows}, {_CHUNK})")
    hi, lo = hi_lo(x.float())
    kc = d // _CHUNK
    hl = torch.stack([hi.reshape(R, kc, _CHUNK), lo.reshape(R, kc, _CHUNK)], dim=2).to(torch.bfloat16)
    return hl.reshape(R // rows, rows, kc, 32, 8).permute(0, 2, 3, 1, 4).contiguous()


def query_operand(q: torch.Tensor) -> torch.Tensor:
    """The queries' operand image: q (nq, d_pad) padded with zero rows to a
    multiple of the kernel's 128-query tile, then ``split_operand``."""
    nq, d = q.shape
    pad = -nq % _OP_ROWS
    return split_operand(torch.nn.functional.pad(q.float(), (0, 0, 0, pad)))


def query_operand_hi(q: torch.Tensor) -> torch.Tensor:
    """The single pass's operand image of the queries: ``query_operand``'s
    hi slices alone, bf16(q) (round to nearest even), (nq_pad/128, d/128, 16,
    128, 8) bf16."""
    return query_operand(q)[:, :, : _CHUNK // 8].contiguous()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), as f32."""
    return x.float().to(torch.bfloat16).float()


def _group_topk(dots, base, nrm, k: int, a_coef: float):
    """Top-k 16-row groups by their best score a_coef * dots(rows) - nrm,
    the lower group id winning ties, -1 ids for empty slots; the corpus in
    _PLAIN_ROWS steps. Returns (values (nq,k) f32, group ids (nq,k) int32)."""
    gmax = []
    for r0 in range(0, base.shape[0], _PLAIN_ROWS):
        s = a_coef * dots(base[r0 : r0 + _PLAIN_ROWS].float()) - nrm[r0 : r0 + _PLAIN_ROWS][None, :]
        gmax.append(s.reshape(s.shape[0], -1, GROUP).amax(-1))
    vals, gids = topk_leftmost(torch.cat(gmax, dim=1), k)
    gids = torch.where(vals <= NEG_INF / 2, torch.full_like(gids, -1), gids)
    return vals, gids.int()


def flat_group_scan_plain(base, nrm, q, k: int, a_coef: float):
    """Plain PyTorch phase 1 with the reference's arithmetic: the 3-pass
    hi/lo bf16 product (bf16 values, f32 products and sums), group max, top-k
    groups with the lower group id winning ties, -1 ids for empty slots.
    Returns (values (nq,k) f32, group ids (nq,k) int32)."""
    qh, ql = hi_lo(q.float())

    def dots(rows):
        bh, bl = hi_lo(rows)
        return qh @ bh.T + ql @ bh.T + qh @ bl.T

    return _group_topk(dots, base, nrm, k, a_coef)


def fused_group_scan_plain(base, nrm, q, k: int, a_coef: float):
    """Plain PyTorch single-pass group scan: bf16-rounded queries and rows,
    f32 products and sums, group max, top-k groups with the lower group id
    winning ties, -1 ids for empty slots."""
    qb = bf16_round(q)
    return _group_topk(lambda rows: qb @ bf16_round(rows).T, base, nrm, k, a_coef)


def _group_max(fn: str, name: str, base, nrm, q_op, a_coef: float) -> torch.Tensor:
    nb_pad, d = base.shape
    nq_pad = q_op.shape[0] * _OP_ROWS
    gmax = torch.empty((nq_pad, nb_pad // GROUP), dtype=torch.float32, device=q_op.device)
    p = cuda_build.ptr
    cuda_build.check(
        getattr(cuda_build.lib(), fn)(
            p(base), p(nrm), p(q_op), p(gmax), nb_pad, nq_pad, d, a_coef, cuda_build.stream_of(q_op)
        ),
        name,
    )
    return gmax


def flat_group_max(base, nrm, q_op, a_coef: float) -> torch.Tensor:
    """The group-max launch alone: (nq_pad, nb_pad/16) f32 group maxima of
    base (nb_pad, d) f32 against the queries' ``query_operand`` image."""
    return _group_max("kw_flat_group_max", "flat_group_scan (group max)", base, nrm, q_op, a_coef)


def fused_group_max(base, nrm, q_op, a_coef: float) -> torch.Tensor:
    """The single-pass group-max launch alone, against the queries'
    ``query_operand_hi`` image; counted in ``fused_group_max.launches``."""
    gmax = _group_max("kw_fused_group_max", "fused_knn_scan (group max)", base, nrm, q_op, a_coef)
    fused_group_max.launches += 1
    return gmax


fused_group_max.launches = 0


def flat_select(gmax: torch.Tensor, nq: int, k: int):
    """The select launch alone: top-k (values, group ids) of gmax rows
    0..nq-1; counted in ``flat_select.launches`` (FLAT's and the fused
    scan's)."""
    out_v = torch.empty((nq, k), dtype=torch.float32, device=gmax.device)
    out_g = torch.empty((nq, k), dtype=torch.int32, device=gmax.device)
    p = cuda_build.ptr
    cuda_build.check(
        cuda_build.lib().kw_flat_select(
            p(gmax), gmax.shape[1], nq, k, p(out_v), p(out_g), cuda_build.stream_of(gmax)
        ),
        "flat_group_scan (select)",
    )
    flat_select.launches += 1
    return out_v, out_g


flat_select.launches = 0


def flat_group_scan(base: torch.Tensor, nrm: torch.Tensor, q: torch.Tensor, k: int, a_coef: float):
    """Phase 1: top-k 16-row groups per query. base (nb_pad, d_pad) f32 with
    nb_pad % 128 == 0 and d_pad % 128 == 0, nrm (nb_pad,) f32 (pad rows
    1e38), q (nq, d_pad) f32. On the card the kernel reads base as it is and
    the queries' ``query_operand`` image, built here.
    Returns (values (nq,k) f32, group ids (nq,k) int32, -1 for empty slots)."""
    if not q.is_cuda:
        return flat_group_scan_plain(base, nrm, q, k, a_coef)
    _check_corpus("flat_group_scan", base, nrm, q, k)
    gmax = flat_group_max(base, nrm, query_operand(q), a_coef)
    out_v, out_g = flat_select(gmax, q.shape[0], k)
    flat_group_scan.launches += 1
    return out_v, out_g


flat_group_scan.launches = 0


def _check_corpus(name: str, base, nrm, q, k: int) -> None:
    """What the group-max and rescore kernels take: base (nb_pad, d) f32
    contiguous and 16-byte aligned, nb_pad and d multiples of 128, norms
    (nb_pad,) f32, all on the queries' device, 1 <= k <= min(1024, groups)."""
    nb_pad, d = base.shape
    if nb_pad % _OP_ROWS or d % _CHUNK or not 1 <= k <= min(1024, nb_pad // GROUP) or q.shape[1] != d:
        raise ValueError(f"{name}: bad shape nb_pad={nb_pad} d={d} k={k}")
    if base.dtype != torch.float32 or nrm.dtype != torch.float32 or nrm.shape != (nb_pad,):
        raise TypeError(f"{name} takes f32 base (nb_pad, d) and f32 norms (nb_pad,)")
    if base.device != q.device or nrm.device != q.device:
        raise ValueError(f"{name}: base and norms must be on the query's device")
    if not base.is_contiguous() or not nrm.is_contiguous() or base.data_ptr() % 16:
        raise ValueError(f"{name}: base must be contiguous and 16-byte aligned, norms contiguous")


def fused_group_scan(base: torch.Tensor, nrm: torch.Tensor, q: torch.Tensor, k: int, a_coef: float):
    """The fused scan's first two launches: top-k 16-row groups per query by
    the single bf16 pass (as ``flat_group_scan``, on ``query_operand_hi``).
    Returns (values (nq,k) f32, group ids (nq,k) int32, -1 for empty slots)."""
    if not q.is_cuda:
        return fused_group_scan_plain(base, nrm, q, k, a_coef)
    _check_corpus("fused_group_scan", base, nrm, q, k)
    gmax = fused_group_max(base, nrm, query_operand_hi(q), a_coef)
    return flat_select(gmax, q.shape[0], k)


def fused_rescore_plain(q, base, nrm, gids, k: int, a_coef: float):
    """Plain PyTorch rescore of the winning groups: their rows and q rounded
    to bf16, a_coef * dot - nrm in f32, the top-k by score with the lower row
    id winning ties; -1 ids for slots <= -1e38/2, and (-1e38, -1) past the
    kg * 16 candidates. Returns (scores (nq,k) f32, ids (nq,k) int32)."""
    nq, kg = gids.shape
    d = base.shape[1]
    big = base.shape[0] // GROUP
    g, _ = torch.sort(torch.where(gids >= 0, gids.long(), big), dim=1)  # row-id order, empty last
    qb = bf16_round(q)
    step = max(1, (1 << 28) // (kg * GROUP * d * 4))  # queries a step: gathered rows near 256 MiB
    s_parts, i_parts = [], []
    for s0 in range(0, nq, step):
        gs = g[s0 : s0 + step]
        rows = (gs.clamp(max=big - 1)[:, :, None] * GROUP + torch.arange(GROUP, device=q.device)).reshape(len(gs), -1)
        dots = torch.einsum("qd,qcd->qc", qb[s0 : s0 + step], bf16_round(base[rows]))
        s = a_coef * dots - nrm[rows]
        s = torch.where((gs < big).repeat_interleave(GROUP, dim=1), s, torch.full_like(s, NEG_INF))
        top_s, sel = topk_leftmost(s, min(k, kg * GROUP))
        s_parts.append(top_s)
        i_parts.append(torch.gather(rows, 1, sel))
    top_s, top_i = torch.cat(s_parts), torch.cat(i_parts)
    top_i = torch.where(top_s <= NEG_INF / 2, torch.full_like(top_i, -1), top_i)
    if top_s.shape[1] < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - top_s.shape[1]), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - top_i.shape[1]), value=-1)
    return top_s, top_i.int()


def fused_rescore(q: torch.Tensor, base: torch.Tensor, nrm: torch.Tensor, gids: torch.Tensor, k: int, a_coef: float):
    """The fused scan's third launch (csrc/flat_scan.cu fused_rescore_kernel,
    one block a query): the top-k rows of the (nq, kg) groups ``gids`` as
    ``fused_rescore_plain`` defines them; counted in
    ``fused_rescore.launches``. Returns (scores (nq,k) f32, ids (nq,k)
    int32)."""
    if not q.is_cuda:
        return fused_rescore_plain(q, base, nrm, gids, k, a_coef)
    nq, kg = gids.shape
    _check_corpus("fused_rescore", base, nrm, q, kg)
    if not 1 <= k <= 1024 or q.shape[0] != nq or gids.dtype != torch.int32 or gids.device != q.device:
        raise ValueError(f"fused_rescore: bad k={k} or gids {tuple(gids.shape)} {gids.dtype} for {nq} queries")
    q, gids = q.float().contiguous(), gids.contiguous()
    out_s = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    p = cuda_build.ptr
    cuda_build.check(
        cuda_build.lib().kw_fused_rescore(
            p(q), p(base), p(nrm), p(gids), nq, kg, base.shape[1], k, a_coef, p(out_s), p(out_i),
            cuda_build.stream_of(q),
        ),
        "fused_knn_scan (rescore)",
    )
    fused_rescore.launches += 1
    return out_s, out_i


fused_rescore.launches = 0


def _phase2(q, base_g, nrm_g, gids, k_out: int, a_coef: float):
    """Exact rescore of the winning groups: (scores, ids) (nq, k_out)."""
    nq, k_sel = gids.shape
    safe = gids.clamp(min=0).long()
    cand = base_g[safe]  # (nq, k_sel, GROUP, d): contiguous 16-row slices
    cn = nrm_g[safe]
    dots = torch.einsum("qd,qkgd->qkg", q, cand)
    s = a_coef * dots - cn
    s = torch.where(gids[:, :, None] >= 0, s, torch.full_like(s, NEG_INF))
    ids = safe[:, :, None] * GROUP + torch.arange(GROUP, device=q.device)[None, None, :]
    top_s, sel = topk_leftmost(s.reshape(nq, k_sel * GROUP), min(k_out, k_sel * GROUP))
    top_i = torch.gather(ids.reshape(nq, k_sel * GROUP), 1, sel)
    top_i = torch.where(top_s <= NEG_INF / 2, torch.full_like(top_i, -1), top_i)
    return top_s, top_i


class FlatScanStore:
    """Device-resident corpus prepared for the two-phase scan: the f32 copy
    padded to TILE rows and 128 features (pad rows carry norm 1e38), its
    grouped view for phase 2, and the padded norms."""

    def __init__(self, base: torch.Tensor, norms, is_l2: bool):
        nb, d = base.shape
        self.nb, self.d = nb, d
        self.is_l2 = is_l2
        self.a_coef = 2.0 if is_l2 else 1.0
        self.d_pad = (d + 127) // 128 * 128
        self.nb_pad = (nb + TILE - 1) // TILE * TILE
        b = base.float()
        if norms is None:
            norms = (b * b).sum(1) if is_l2 else torch.zeros(nb, device=b.device)
        self.base = torch.nn.functional.pad(b, (0, self.d_pad - d, 0, self.nb_pad - nb)).contiguous()
        self.nrm = torch.nn.functional.pad(norms.float(), (0, self.nb_pad - nb), value=1e38).contiguous()
        self.base_g = self.base[:, :d].reshape(self.nb_pad // GROUP, GROUP, d)
        self.nrm_g = self.nrm.reshape(self.nb_pad // GROUP, GROUP)


def flat_topk(q: np.ndarray, store: FlatScanStore, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over the store: (dists native convention, ids int64)."""
    q = np.asarray(q, dtype=np.float32)
    nq, d = q.shape
    assert d == store.d
    kg = min(k, store.nb_pad // GROUP)
    q_dev = to_device(q)
    qp_dev = torch.nn.functional.pad(q_dev, (0, store.d_pad - d))
    # phase 2 gathers (block, kg, GROUP, d) f32 rows: keep that near 1 GiB
    block = min(NQ_BLOCK, max(64, (1 << 30) // (kg * GROUP * d * 4)))
    s_parts, i_parts = [], []
    for s0 in range(0, nq, block):
        _, gids = flat_group_scan(store.base, store.nrm, qp_dev[s0 : s0 + block], kg, store.a_coef)
        s, i = _phase2(
            q_dev[s0 : s0 + block], store.base_g, store.nrm_g, gids,
            min(k, kg * GROUP), store.a_coef,
        )
        s_parts.append(s)
        i_parts.append(i)
    s_all = torch.cat(s_parts).cpu().numpy()
    i_all = torch.cat(i_parts).cpu().numpy().astype(np.int64)
    i_all = np.where(i_all >= store.nb, -1, i_all)
    k_got = i_all.shape[1]
    if k_got < k:
        s_all = np.pad(s_all, ((0, 0), (0, k - k_got)), constant_values=NEG_INF)
        i_all = np.pad(i_all, ((0, 0), (0, k - k_got)), constant_values=-1)
    if store.is_l2:
        qsq = np.sum(q.astype(np.float64) ** 2, axis=1).astype(np.float32)
        dists = qsq[:, None] - s_all
    else:
        dists = s_all
    dists = np.where(i_all >= 0, dists, np.float32(np.inf if store.is_l2 else -np.inf))
    return dists, i_all
