"""IVF_PQ ADC task scan (counterpart of the two ADC kernels of
knowhere_tpu/ops/ivf_pallas.py: ``_adc_kernel`` and ``_adc_kernel_mc``).

A task is one aligned LIST_ALIGN-row block of one list scanned by one group
of Qg queries in the OPQ-rotated frame (ops/ivf_scan.py builds them). Per
task the scan builds the group's lookup table from the bf16 codebooks,

    lut[q, j, v] = bf16(f * (<hi_j, b_jv> + <lo_j, b_jv>) - clut[list, j, v])

(hi = bf16(q), lo = bf16(q - hi), f32 sums; f = 2 and the clut term for L2,
f = 1 and no clut for IP), scores each row as ``base + sum_j lut[q, j,
code_j]`` with ``base = 2<q, c> - |c|^2`` (L2) or ``<q, c>`` (IP) against the
list's scan-frame centroid, masks rows past ``nrows`` and rows the keep-mask
drops, and keeps the per-task top-kk with the reference's result contract
(larger is better, -1e38 / -1 for empty slots, leftmost column on ties).

``adc_scan_tasks`` launches the CUDA kernel (csrc/ivf_adc.cu: the LUT on the
tensor cores) for CUDA tensors and counts the launch; for CPU tensors it
runs ``adc_scan_plain``, the same math in torch ops, which the CPU tests hold
against the Pallas kernels and the chip check holds the kernel against (the
kernel's sums run in another order: an entry below 2 may round to the
neighbouring bf16 value).

Codes are row-major ``(nb_pad + slack, mb)`` uint8: mb = m, or m/2 with
``nib`` (ksub=16, byte j holds subspace j in its low nibble and j + m/2 in
its high nibble).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_build
from .ivf_cuda import LIST_ALIGN, _block_rows, _check_task_args, _finish

# bytes of gathered lookups per plain-version chunk
_PLAIN_BYTES = 256 << 20

# shared memory a block of the kernel can use (H100 / H200)
SMEM_LIMIT = 232448


def adc_smem_bytes(m: int, ksub: int, sub: int, nib: bool) -> int:
    """Dynamic shared memory of one kernel block (mirrors ``adc_smem_bytes``
    in csrc/ivf_adc.cu). The front holds one chunk's query operand image
    (64-row slabs of codewords, 64 / ksub subspaces a slab below ksub = 64;
    K = the slab's subspaces' features padded to 16; 2G rows, f * hi and
    f * lo of the G = 16 queries of a group, kAdcG), the group's LUT chunk in query pairs
    (32 KB of bf16 entries, each pair's row padded to 8 words past a
    multiple of 32) and the chunk's f32 rounding windows, one a subspace, or
    the selection's scratch (8 warps x 512 f32 scores and u16 columns, 24
    KB) where that is larger. Then come the code rows at an odd-word stride
    and the task's bf16 clut row."""
    G = 16
    kr = 1
    while kr < ksub and kr < 64:
        kr *= 2
    P = 64 // kr
    KS = -(-P * sub // 16) * 16
    mc = min(max(32 * 1024 // (G * ksub * 2) // P * P, P), -(-m // P) * P)
    ps = -(-mc * ksub // 32) * 32 + 8
    windows = -(-mc * 4 // 16) * 16
    front = max((mc // P) * KS * 2 * G * 2 + (G // 2) * ps * 4 + windows, 8 * LIST_ALIGN * 6)
    front = -(-front // 16) * 16
    words = (((m // 2) if nib else m) + 3) // 4
    words += 1 - words % 2
    clut = -(-m * ksub * 2 // 16) * 16
    return front + LIST_ALIGN * 4 * words + clut


def compute_qlut(q: torch.Tensor, books: torch.Tensor, *, is_l2: bool) -> torch.Tensor:
    """Per-query part of the ADC lookup table: (..., d') queries (d' >= m *
    sub; padded columns are ignored) and (m, ksub, sub) bf16-valued codebooks
    -> (..., m * ksub) f32 with QLUT[.., j * ksub + v] = f * (<hi_j, b_jv> +
    <lo_j, b_jv>), f = 2 for L2. The hi/lo split is the TPU kernels' (the
    reference's compute_qlut is the same product in full f32)."""
    m, ksub, sub = books.shape
    q = q[..., : m * sub].float()
    hi = q.to(torch.bfloat16).float()
    lo = (q - hi).to(torch.bfloat16).float()
    b = books.float()
    lead = q.shape[:-1]

    def dots(x):
        return torch.einsum("nms,mvs->nmv", x.reshape(-1, m, sub), b)

    lut = dots(hi) + dots(lo)
    if is_l2:
        lut = 2.0 * lut
    return lut.reshape(*lead, m * ksub)


def unpack_codes(codes: torch.Tensor, m: int, nib: bool) -> torch.Tensor:
    """(..., mb) stored uint8 codes -> (..., m) int64 codewords."""
    c = codes.long()
    if nib:
        c = torch.cat([c & 15, c >> 4], dim=-1)
    return c[..., :m]


def adc_scan_plain(blk, nrows, lids, q_task, books, clut, cents, codes, keep=None, *, B, kk, is_l2, nib):
    """Plain PyTorch version of the ADC scan: the hi/lo LUT rounded to bf16,
    lookups gathered and summed in f32, in task chunks that bound the
    gathered (chunk, Qg, B * m) lookups."""
    m, ksub, _ = books.shape
    Qg = q_task.shape[1]
    chunk = max(1, _PLAIN_BYTES // (Qg * B * m * 4))
    off = torch.arange(m, device=codes.device) * ksub
    out_s, out_p = [], []
    for c0 in range(0, blk.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        b, lid = blk[sl], lids[sl].long()
        q = q_task[sl].float()
        lut = compute_qlut(q, books, is_l2=is_l2)
        if is_l2:
            lut = lut - clut[lid].float()[:, None, :]
        lut = lut.to(torch.bfloat16).float()  # (tc, Qg, m * ksub)
        idx = (unpack_codes(codes[_block_rows(b, B)], m, nib) + off).reshape(b.shape[0], 1, B * m)
        acc = torch.gather(lut, 2, idx.expand(-1, Qg, -1)).view(b.shape[0], Qg, B, m).sum(-1)
        c = cents[lid].float()
        qc = (q * c[:, None, :]).sum(-1)
        base = 2.0 * qc - (c * c).sum(-1)[:, None] if is_l2 else qc
        s, p = _finish(base[..., None] + acc, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def adc_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32 block index of each task
    nrows: torch.Tensor,  # (Tc,) int32 valid rows in the block
    lids: torch.Tensor,  # (Tc,) int32 list of each task
    q_task: torch.Tensor,  # (Tc, Qg, d) f32 pre-gathered query groups (scan frame)
    books: torch.Tensor,  # (m, ksub, sub) bf16 codebooks
    clut: torch.Tensor,  # (nlist, m * ksub) bf16 (ignored for IP)
    cents: torch.Tensor,  # (nlist, d) f32 scan-frame centroids
    codes: torch.Tensor,  # (nb_pad + slack, mb) uint8
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    B: int,
    kk: int,
    is_l2: bool,
    nib: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q_task.is_cuda:
        return adc_scan_plain(
            blk, nrows, lids, q_task, books, clut, cents, codes, keep, B=B, kk=kk, is_l2=is_l2, nib=nib
        )
    Tc, Qg, d = q_task.shape
    m, ksub, sub = books.shape
    mb = m // 2 if nib else m
    if B != LIST_ALIGN or not 1 <= kk <= 32 or d % 4 or m * sub > d or ksub > 256:
        raise ValueError(f"ADC scan takes B={LIST_ALIGN}, kk<=32, d%4==0, m*sub<=d, ksub<=256")
    if nib and (ksub != 16 or m % 2):
        raise ValueError("nibble codes need ksub=16 and an even m")
    if q_task.dtype != torch.float32 or books.dtype != torch.bfloat16 or clut.dtype != torch.bfloat16:
        raise TypeError("ADC scan takes f32 queries, bf16 books and bf16 clut")
    if codes.dtype != torch.uint8 or cents.dtype != torch.float32:
        raise TypeError("ADC scan takes uint8 codes and f32 centroids")
    _check_task_args(blk, nrows, q_task, codes, keep, mb)
    if lids.shape != (Tc,) or cents.shape[1] != d or clut.shape != (cents.shape[0], m * ksub):
        raise ValueError("ADC scan: lids (Tc,), cents (nlist, d), clut (nlist, m*ksub)")
    if any(t.device != q_task.device for t in (lids, books, clut, cents)):
        raise ValueError("ADC scan inputs must share one CUDA device")
    if adc_smem_bytes(m, ksub, sub, nib) > SMEM_LIMIT:
        raise ValueError(f"ADC scan: m={m}, ksub={ksub}, sub={sub} needs more shared memory than a block has")
    blk, nrows, lids = blk.int().contiguous(), nrows.int().contiguous(), lids.int().contiguous()
    q_task, books, clut = q_task.contiguous(), books.contiguous(), clut.contiguous()
    if books.data_ptr() % 16:  # the kernel reads codewords 16 bytes at a time
        books = books.clone()
    cents, codes = cents.contiguous(), codes.contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q_task.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q_task.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_adc_scan(
        p(blk), p(nrows), p(lids), p(q_task), p(books), p(clut), p(cents), p(codes), p(keep_u8),
        p(out_s), p(out_p), Tc, Qg, d, m, ksub, sub, kk, int(is_l2), int(nib),
        cuda_build.stream_of(q_task),
    )
    cuda_build.check(code, "ivf_adc_scan")
    adc_scan_tasks.launches += 1
    return out_s, out_p


adc_scan_tasks.launches = 0
