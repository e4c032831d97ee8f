"""IVF task-scan kernels (counterpart of knowhere_tpu/ops/ivf_pallas.py).

A task is one aligned LIST_ALIGN-row list block scanned by one group of Qg
queries (ops/ivf_scan.py builds them). Four scans:

- ``int8_scan_tasks``: int8 queries . int8 codes -> int32 (tensor cores,
  exact), score ``2*sz*dot - nrm`` (L2) or ``sz*dot`` (IP); the FAST
  serving scan of IVF_FLAT (int8 sidecar) and IVF_SQ8 (its u8 codes), whose
  candidate pool is re-ranked exactly afterwards. Replaces ``_int8_kernel``.
- ``f32_scan_tasks``: f32 queries . f32 rows as the reference's single bf16
  pass or its three-pass hi/lo bf16 product (tensor cores), in-scan f32
  norms, score ``2*dot - |x|^2`` or ``dot``. Replaces ``_scan_kernel``.
- ``sq_scan_tasks``: the same scores over u8 SQ8/SQ6 codes decoded as
  ``vmin + (c + 0.5) * (1/levels) * vdiff``, one bf16 pass or three hi/lo
  passes (tensor cores). Replaces ``_sq_kernel``.
- ``rbq_scan_tasks``: the RaBitQ estimator over packed sign bits, score
  ``-(|qr|^2 + rn^2 - 2 est)`` (L2) or ``<q,c> + est`` (IP) with
  ``est = rn * <qr, s> / (max(t, 1e-6) sqrt(d))``, the dot as one bf16 pass
  or the hi/lo passes ``<qr_hi, s> + <qr_lo, s>`` (tensor cores). Replaces
  ``_rbq_kernel``.

Each returns the per-task top-kk as (scores (Tc,Qg,kk), positions (Tc,Qg,kk)
into the padded storage), with the reference's result contract: larger is
better, empty slots hold -1e38 with position -1, ties go to the leftmost
column. Each wrapper launches its CUDA kernel (csrc/ivf_scan.cu, ivf_sq.cu,
ivf_rbq.cu; the four scans share the tensor-core body of
csrc/ivf_task_scan.cuh) for CUDA tensors and counts the launch in
``<wrapper>.launches``; for CPU tensors it runs the plain PyTorch version
beside it. The plain versions are what the CPU
tests hold against the JAX kernels and what the chip check holds the kernels
against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_flat import hi_lo

NEG_INF = -1e38

# lists are padded to multiples of this many rows when built large enough
# (models/ivf.py); the kernels take one such block per task
LIST_ALIGN = 512

# tasks per plain-version chunk: bounds the gathered (chunk, B, d) rows
_PLAIN_CHUNK = 512


def task_kk(k: int, B: int) -> int:
    """Per-task top-k width, capped at 32 as in the reference: it decides the
    candidate pool, so it is kept for parity."""
    return min(k, 32)


def topk_rows(scores: torch.Tensor, payload: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) scores + int payload -> (..., k) best values + payloads, the
    leftmost column winning ties (the reference's ``_topk_rows``)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], torch.gather(payload, -1, idx[..., :k])


def _check_task_args(blk, nrows, q_task, rows, keep, d) -> None:
    """Shapes, types and devices a task-scan kernel reads through raw
    pointers (block indices themselves are the task builder's invariant:
    blk < rows // LIST_ALIGN)."""
    Tc = q_task.shape[0]
    tensors = [blk, nrows, rows] + ([keep] if keep is not None else [])
    if any(t.device != q_task.device for t in tensors):
        raise ValueError("task-scan inputs must share one CUDA device")
    if blk.shape != (Tc,) or nrows.shape != (Tc,):
        raise ValueError("blk and nrows must be (Tc,)")
    if rows.dim() != 2 or rows.shape[1] != d or rows.shape[0] % LIST_ALIGN:
        raise ValueError(f"rows must be (n * {LIST_ALIGN}, {d})")
    if keep is not None and (keep.dtype != torch.bool or keep.numel() < rows.shape[0]):
        raise ValueError("keep must be a bool mask covering every stored row")


def _block_rows(blk: torch.Tensor, B: int) -> torch.Tensor:
    return blk.long()[:, None] * B + torch.arange(B, device=blk.device)[None, :]


def _finish(score, blk, nrows, keep, B, kk):
    """Masks, top-kk and the empty-slot rule shared by both plain scans."""
    col = torch.arange(B, device=score.device)
    valid = (col[None, :] < nrows[:, None].long())[:, None, :]
    if keep is not None:
        valid = valid & keep[_block_rows(blk, B)].bool()[:, None, :]
    score = torch.where(valid, score, torch.full_like(score, NEG_INF))
    gpos = (col[None, :] + blk.long()[:, None] * B).int()[:, None, :].expand_as(score)
    s, p = topk_rows(score, gpos, kk)
    return s, torch.where(s <= NEG_INF / 2, torch.full_like(p, -1), p)


# ---------------------------------------------------------------------------
# int8 scan
# ---------------------------------------------------------------------------


def int8_scan_plain(blk, nrows, q_task, q_scale, codes, nrm, keep=None, *, B, kk, is_l2):
    """Plain PyTorch version of the int8 scan. The int8 dot runs as an f32
    matmul, which is exact here: every product is at most 127*128 and the sums
    stay below 2**24 for d <= 1040."""
    out_s, out_p = [], []
    sz = q_scale.reshape(q_scale.shape[0], q_scale.shape[1], 1).float()
    for c0 in range(0, blk.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        b = blk[sl]
        rows = _block_rows(b, B)
        ci = codes[rows]
        if ci.dtype == torch.uint8:  # SQ8 codes: c - 128 as an i8 bit pattern
            ci = (ci ^ 0x80).view(torch.int8)
        dots = torch.bmm(q_task[sl].float(), ci.float().transpose(1, 2))
        if is_l2:
            score = (2.0 * sz[sl]) * dots - nrm[rows].float()[:, None, :]
        else:
            score = sz[sl] * dots
        s, p = _finish(score, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def int8_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32 block index of each task
    nrows: torch.Tensor,  # (Tc,) int32 valid rows in the block
    q_task: torch.Tensor,  # (Tc, Qg, d) int8 pre-quantized query groups
    q_scale: torch.Tensor,  # (Tc, Qg, 1) f32 per-query scales
    codes: torch.Tensor,  # (nb_pad + slack, d) int8 sidecar or uint8 SQ8 codes
    nrm: torch.Tensor,  # (nb_pad,) f32 centred norms (zeros for IP)
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    B: int,
    kk: int,
    is_l2: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q_task.is_cuda:
        return int8_scan_plain(blk, nrows, q_task, q_scale, codes, nrm, keep, B=B, kk=kk, is_l2=is_l2)
    Tc, Qg, d = q_task.shape
    if B != LIST_ALIGN or d % 128 or not 1 <= kk <= 32:
        raise ValueError(f"int8 scan takes B={LIST_ALIGN}, d%128==0, kk<=32 (got {B}, {d}, {kk})")
    if codes.dtype not in (torch.int8, torch.uint8) or q_task.dtype != torch.int8:
        raise TypeError("int8 scan takes int8 queries and int8/uint8 codes")
    _check_task_args(blk, nrows, q_task, codes, keep, d)
    if q_scale.numel() != Tc * Qg or nrm.dtype != torch.float32 or nrm.device != q_task.device:
        raise ValueError("int8 scan: q_scale must be (Tc, Qg, 1) and nrm f32 on the same device")
    blk, nrows = blk.int().contiguous(), nrows.int().contiguous()
    q_task, codes = q_task.contiguous(), codes.contiguous()
    if q_task.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("int8 scan: the queries and codes must start on 16-byte boundaries (cp.async)")
    q_scale = q_scale.float().contiguous()
    nrm = nrm.float().contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q_task.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q_task.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_int8_scan(
        p(blk), p(nrows), p(q_task), p(q_scale), p(codes), p(nrm), p(keep_u8),
        p(out_s), p(out_p), Tc, Qg, d, kk, int(is_l2), int(codes.dtype == torch.uint8),
        cuda_build.stream_of(q_task),
    )
    cuda_build.check(code, "ivf_int8_scan")
    int8_scan_tasks.launches += 1
    return out_s, out_p


int8_scan_tasks.launches = 0


# ---------------------------------------------------------------------------
# f32 scan
# ---------------------------------------------------------------------------


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dots(q: torch.Tensor, rows: torch.Tensor, three_pass: bool) -> torch.Tensor:
    """(T, Qg, d) . (T, B, d) -> (T, Qg, B) as the reference's scan kernels
    compute it: the hi/lo split (hh + hl) + lh, each bf16 x bf16 product
    exact in f32 (three_pass), or bf16-rounded operands multiplied in f32
    (the TPU's single bf16 pass)."""
    if three_pass:
        qh, ql = hi_lo(q)
        rh, rl = hi_lo(rows)
        rh_t, rl_t = rh.transpose(1, 2), rl.transpose(1, 2)
        return (torch.bmm(qh, rh_t) + torch.bmm(qh, rl_t)) + torch.bmm(ql, rh_t)
    return torch.bmm(_bf16_round(q), _bf16_round(rows).transpose(1, 2))


def f32_scan_plain(blk, nrows, q_task, data, keep=None, *, B, kk, is_l2, three_pass):
    """Plain PyTorch version of the f32 scan, with the reference's arithmetic
    (ivf_pallas.py _scan_kernel, see _dots)."""
    out_s, out_p = [], []
    for c0 in range(0, blk.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        b = blk[sl]
        rows = data[_block_rows(b, B)].float()
        dots = _dots(q_task[sl].float(), rows, three_pass)
        if is_l2:
            score = 2.0 * dots - (rows * rows).sum(-1)[:, None, :]
        else:
            score = dots
        s, p = _finish(score, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def f32_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32
    nrows: torch.Tensor,  # (Tc,) int32
    q_task: torch.Tensor,  # (Tc, Qg, d) f32 pre-gathered query groups
    data: torch.Tensor,  # (nb_pad + slack, d) f32 sorted rows
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    B: int,
    kk: int,
    is_l2: bool,
    three_pass: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q_task.is_cuda:
        return f32_scan_plain(
            blk, nrows, q_task, data, keep, B=B, kk=kk, is_l2=is_l2, three_pass=three_pass
        )
    Tc, Qg, d = q_task.shape
    if B != LIST_ALIGN or d % 128 or not 1 <= kk <= 32:
        raise ValueError(f"f32 scan takes B={LIST_ALIGN}, d%128==0, kk<=32 (got {B}, {d}, {kk})")
    if data.dtype != torch.float32 or q_task.dtype != torch.float32:
        raise TypeError("f32 scan takes f32 queries and rows")
    _check_task_args(blk, nrows, q_task, data, keep, d)
    blk, nrows = blk.int().contiguous(), nrows.int().contiguous()
    q_task, data = q_task.contiguous(), data.contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q_task.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q_task.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_f32_scan(
        p(blk), p(nrows), p(q_task), p(data), p(keep_u8), p(out_s), p(out_p),
        Tc, Qg, d, kk, int(is_l2), int(three_pass), cuda_build.stream_of(q_task),
    )
    cuda_build.check(code, "ivf_f32_scan")
    f32_scan_tasks.launches += 1
    return out_s, out_p


f32_scan_tasks.launches = 0


# ---------------------------------------------------------------------------
# SQ scan (u8 SQ8/SQ6 codes decoded in the scan)
# ---------------------------------------------------------------------------


def _sq_rows(codes_blk, vmin, vdiff, levels):
    """The kernel's decode order: vmin + ((c + 0.5) * (1/levels)) * vdiff (the
    reference's plain decode divides by levels; for power-of-two levels the
    two give the same bits)."""
    return vmin + (codes_blk.float() + 0.5) * (1.0 / levels) * vdiff


def sq_scan_plain(blk, nrows, q_task, codes, vmin, vdiff, keep=None, *, B, kk, levels, is_l2, three_pass):
    """Plain PyTorch version of the SQ scan: decode the block to f32 rows,
    then the f32 scan's arithmetic (ivf_pallas.py _sq_kernel, see _dots); L2
    norms from the f32 rows."""
    out_s, out_p = [], []
    for c0 in range(0, blk.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        b = blk[sl]
        rows = _sq_rows(codes[_block_rows(b, B)], vmin, vdiff, levels)
        dots = _dots(q_task[sl].float(), rows, three_pass)
        score = 2.0 * dots - (rows * rows).sum(-1)[:, None, :] if is_l2 else dots
        s, p = _finish(score, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def sq_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32
    nrows: torch.Tensor,  # (Tc,) int32
    q_task: torch.Tensor,  # (Tc, Qg, d) f32 pre-gathered query groups
    codes: torch.Tensor,  # (nb_pad + slack, d) uint8 codes
    vmin: torch.Tensor,  # (d,) f32 (zeros in padded columns)
    vdiff: torch.Tensor,  # (d,) f32 (zeros in padded columns)
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    B: int,
    kk: int,
    levels: int,
    is_l2: bool,
    three_pass: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q_task.is_cuda:
        return sq_scan_plain(
            blk, nrows, q_task, codes, vmin, vdiff, keep,
            B=B, kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass,
        )
    Tc, Qg, d = q_task.shape
    if B != LIST_ALIGN or d % 128 or not 1 <= kk <= 32 or levels not in (64, 256):
        raise ValueError(f"sq scan takes B={LIST_ALIGN}, d%128==0, kk<=32, levels 64/256 (got {B}, {d}, {kk}, {levels})")
    if codes.dtype != torch.uint8 or q_task.dtype != torch.float32:
        raise TypeError("sq scan takes f32 queries and uint8 codes")
    _check_task_args(blk, nrows, q_task, codes, keep, d)
    if vmin.shape != (d,) or vdiff.shape != (d,) or vmin.device != q_task.device or vdiff.device != q_task.device:
        raise ValueError("sq scan: vmin and vdiff must be (d,) on the queries' device")
    blk, nrows = blk.int().contiguous(), nrows.int().contiguous()
    q_task, codes = q_task.contiguous(), codes.contiguous()
    vmin, vdiff = vmin.float().contiguous(), vdiff.float().contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q_task.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q_task.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_sq_scan(
        p(blk), p(nrows), p(q_task), p(codes), p(vmin), p(vdiff), p(keep_u8), p(out_s), p(out_p),
        Tc, Qg, d, kk, levels, int(is_l2), int(three_pass), cuda_build.stream_of(q_task),
    )
    cuda_build.check(code, "ivf_sq_scan")
    sq_scan_tasks.launches += 1
    return out_s, out_p


sq_scan_tasks.launches = 0


# ---------------------------------------------------------------------------
# RaBitQ scan (packed sign bits)
# ---------------------------------------------------------------------------


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d/8) little-endian sign bytes -> (..., d) f32 +/-1 (bit set = +1)."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :d].float() * 2.0 - 1.0


def rbq_scan_plain(blk, nrows, lids, q_task, cents_rot, signs, r_norm, t, keep=None, *, B, kk, is_l2, three_pass):
    """Plain PyTorch version of the RaBitQ scan (ivf_pallas.py _rbq_kernel).
    qr = q - c_rot[lid] in f32; the sign dot takes bf16(qr) (three_pass=False)
    or the hi/lo split qr_hi.s + qr_lo.s (three_pass=True; +/-1 is exact in
    bf16); |qr|^2 and <q, c> are f32; sqrt(d) is the scanned (device) width."""
    d = q_task.shape[2]
    sqrt_d = float(np.sqrt(d))
    out_s, out_p = [], []
    for c0 in range(0, blk.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        b = blk[sl]
        rows = _block_rows(b, B)
        q = q_task[sl].float()
        c = cents_rot[lids[sl].long()].float()[:, None, :]
        qr = q - c
        s_pm = unpack_signs(signs[rows], d)
        s_t = s_pm.transpose(1, 2)
        if three_pass:
            qh, ql = hi_lo(qr)
            dots = torch.bmm(qh, s_t) + torch.bmm(ql, s_t)
        else:
            dots = torch.bmm(_bf16_round(qr), s_t)
        rn, tt = r_norm[rows][:, None, :], t[rows][:, None, :]
        ip_est = rn * dots / (torch.clamp(tt, min=1e-6) * sqrt_d)
        if is_l2:
            score = -((qr * qr).sum(-1, keepdim=True) + rn * rn - 2.0 * ip_est)
        else:
            score = (q * c).sum(-1, keepdim=True) + ip_est
        s, p = _finish(score, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def rbq_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32
    nrows: torch.Tensor,  # (Tc,) int32
    lids: torch.Tensor,  # (Tc,) int32 list of each task (its rotated centroid row)
    q_task: torch.Tensor,  # (Tc, Qg, d) f32 pre-gathered rotated queries
    cents_rot: torch.Tensor,  # (nlist, d) f32 rotated centroids
    signs: torch.Tensor,  # (nb_pad + slack, d/8) uint8 packed sign bits
    r_norm: torch.Tensor,  # (>= nb_pad,) f32 residual norms
    t: torch.Tensor,  # (>= nb_pad,) f32 alignment corrections
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    B: int,
    kk: int,
    is_l2: bool,
    three_pass: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q_task.is_cuda:
        return rbq_scan_plain(
            blk, nrows, lids, q_task, cents_rot, signs, r_norm, t, keep,
            B=B, kk=kk, is_l2=is_l2, three_pass=three_pass,
        )
    Tc, Qg, d = q_task.shape
    if B != LIST_ALIGN or d % 128 or not 1 <= kk <= 32:
        raise ValueError(f"rbq scan takes B={LIST_ALIGN}, d%128==0, kk<=32 (got {B}, {d}, {kk})")
    if signs.dtype != torch.uint8 or q_task.dtype != torch.float32 or cents_rot.dtype != torch.float32:
        raise TypeError("rbq scan takes f32 queries and centroids and uint8 packed signs")
    if signs.dim() != 2 or signs.shape[1] != d // 8 or signs.shape[0] % LIST_ALIGN:
        raise ValueError(f"signs must be (n * {LIST_ALIGN}, {d // 8}) packed bytes")
    if keep is not None and (keep.dtype != torch.bool or keep.numel() < signs.shape[0]):
        raise ValueError("keep must be a bool mask covering every stored row")
    tensors = [blk, nrows, lids, cents_rot, signs, r_norm, t] + ([keep] if keep is not None else [])
    if any(x.device != q_task.device for x in tensors):
        raise ValueError("rbq scan inputs must share one CUDA device")
    if blk.shape != (Tc,) or nrows.shape != (Tc,) or lids.shape != (Tc,) or cents_rot.shape[1] != d:
        raise ValueError("blk, nrows and lids must be (Tc,) and cents_rot (nlist, d)")
    if r_norm.dtype != torch.float32 or t.dtype != torch.float32 or min(r_norm.numel(), t.numel()) < signs.shape[0]:
        raise ValueError("r_norm and t must be f32 and cover every stored row")
    blk, nrows, lids = blk.int().contiguous(), nrows.int().contiguous(), lids.int().contiguous()
    q_task, cents_rot, signs = q_task.contiguous(), cents_rot.contiguous(), signs.contiguous()
    r_norm, t = r_norm.contiguous(), t.contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q_task.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q_task.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_rbq_scan(
        p(blk), p(nrows), p(lids), p(q_task), p(cents_rot), p(signs), p(r_norm), p(t), p(keep_u8),
        p(out_s), p(out_p), Tc, Qg, d, kk, int(is_l2), int(three_pass), cuda_build.stream_of(q_task),
    )
    cuda_build.check(code, "ivf_rbq_scan")
    rbq_scan_tasks.launches += 1
    return out_s, out_p


rbq_scan_tasks.launches = 0
