"""IVF_PQ ADC task scan (counterpart of the two ADC kernels of
knowhere_tpu/ops/ivf_pallas.py: ``_adc_kernel`` and ``_adc_kernel_mc``).

A task is one aligned LIST_ALIGN-row block of one list scanned by one group
of Qg queries in the OPQ-rotated frame (ops/ivf_scan.py builds them, each
query named by its row in the batch). The lookup table splits as Faiss's
precomputed one does: its query part,

    P[q, j * ksub + v] = f * (<hi_j, b_jv> + <lo_j, b_jv>)

(hi = bf16(q), lo = bf16(q - hi), bf16 codebooks b, f32 sums; f = 2 for L2,
1 for IP), does not depend on the list, so ``adc_qtable`` builds it once a
search. Per task the scan rounds its group's table

    lut[q, j, v] = bf16(P[q, j * ksub + v] - clut[list, j, v])

(no clut term for IP), scores each row as ``base + sum_j lut[q, j, code_j]``
with ``base = 2<q, c> - |c|^2`` (L2) or ``<q, c>`` (IP) against the list's
scan-frame centroid, masks rows past ``nrows`` and rows the keep-mask drops,
and keeps the per-task top-kk with the reference's result contract (larger
is better, -1e38 / -1 for empty slots, leftmost column on ties).

``adc_qtable`` and ``adc_scan_tasks`` launch the CUDA kernels
(csrc/ivf_adc.cu) for CUDA tensors and count their launches; for CPU tensors
they run ``compute_qlut`` and ``adc_scan_plain``, the same math in torch ops,
which the CPU tests hold against the Pallas kernels and the chip check holds
the kernels against. Each entry of P is two sequential sums in ascending
feature in both, so the tables agree bit for bit; the scan's sums over the
subspaces may run in another order in the plain version.

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


def adc_smem_bytes(m: int, ksub: int, nib: bool) -> int:
    """Dynamic shared memory of one kernel block (mirrors ``adc_smem_bytes``
    in csrc/ivf_adc.cu): each of the 8 warps' two buffers of a 512-entry
    chunk of its query pair's table rows (2 x 2 x 512 f32; the selection's
    scratch lies over them), then the code rows at an odd-word stride and the
    task's bf16 clut row."""
    words = (((m // 2) if nib else m) + 3) // 4
    words += 1 - words % 2
    clut = -(-m * ksub * 2 // 16) * 16
    return 8 * 2 * 2 * 512 * 4 + LIST_ALIGN * 4 * words + clut


def compute_qlut(q: torch.Tensor, books: torch.Tensor, *, is_l2: bool) -> torch.Tensor:
    """Per-query part of the ADC lookup table: (..., d') queries (d' >= m *
    sub; padded columns are ignored) and (m, ksub, sub) bf16-valued codebooks
    -> (..., m * ksub) f32 with QLUT[.., j * ksub + v] = f * (<hi_j, b_jv> +
    <lo_j, b_jv>), f = 2 for L2. The hi/lo split is the TPU kernels' (the
    reference's compute_qlut is the same product in full f32). Each product
    is summed in ascending feature, as the kernel's FMA chains are: a
    product of two bf16 values is exact in f32, so the two agree bit for
    bit."""
    m, ksub, sub = books.shape
    q = q[..., : m * sub].float()
    lead = q.shape[:-1]
    q = q.reshape(-1, m, 1, sub)
    hi = q.to(torch.bfloat16).float()
    lo = (q - hi).to(torch.bfloat16).float()
    b = books.float()

    def dots(x):
        acc = x[..., 0] * b[..., 0]
        for s in range(1, sub):
            acc = acc + x[..., s] * b[..., s]
        return acc

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


def adc_qtable(q: torch.Tensor, books: torch.Tensor, *, is_l2: bool) -> torch.Tensor:
    """The table's query part once a search: (nq, d) f32 queries (scan
    frame) and (m, ksub, sub) bf16 codebooks -> (nq, m * ksub) f32 P
    (compute_qlut's entries). CUDA tensors launch the table kernel
    (``ivf_adc_scan_kernel_qtable``); CPU tensors run ``compute_qlut``."""
    if not q.is_cuda:
        return compute_qlut(q, books, is_l2=is_l2)
    nq, d = q.shape
    m, ksub, sub = books.shape
    if m * sub > d or ksub > 256:
        raise ValueError("ADC table takes m*sub<=d, ksub<=256")
    if q.dtype != torch.float32 or books.dtype != torch.bfloat16 or books.device != q.device:
        raise TypeError("ADC table takes f32 queries and bf16 books on one CUDA device")
    q, books = q.contiguous(), books.contiguous()
    out = torch.empty((nq, m * ksub), dtype=torch.float32, device=q.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_adc_qtable(
        p(q), p(books), p(out), nq, d, m, ksub, sub, int(is_l2), cuda_build.stream_of(q),
    )
    cuda_build.check(code, "ivf_adc_qtable")
    adc_qtable.launches += 1
    return out


adc_qtable.launches = 0


def adc_scan_plain(blk, nrows, lids, qids, q, qtab, clut, cents, codes, keep=None, *, m, B, kk, is_l2, nib):
    """Plain PyTorch version of the ADC scan: each task's rows of the table
    ``qtab`` less its list's clut row, rounded to bf16, lookups gathered and
    summed in f32, in task chunks that bound the gathered (chunk, Qg, B * m)
    lookups."""
    ksub = qtab.shape[1] // m
    Qg = qids.shape[1]
    chunk = max(1, _PLAIN_BYTES // (Qg * B * m * 4))
    off = torch.arange(m, device=codes.device) * ksub
    out_s, out_p = [], []
    for c0 in range(0, blk.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        b, lid, qi = blk[sl], lids[sl].long(), qids[sl].long()
        lut = qtab[qi]  # (tc, Qg, m * ksub)
        if is_l2:
            lut = lut - clut[lid].float()[:, None, :]
        lut = lut.to(torch.bfloat16).float()
        idx = (unpack_codes(codes[_block_rows(b, B)], m, nib) + off).reshape(b.shape[0], 1, B * m)
        acc = torch.gather(lut, 2, idx.expand(-1, Qg, -1)).view(b.shape[0], Qg, B, m).sum(-1)
        c = cents[lid].float()
        qc = (q[qi].float() * c[:, None, :]).sum(-1)
        base = 2.0 * qc - (c * c).sum(-1)[:, None] if is_l2 else qc
        s, p = _finish(base[..., None] + acc, b, nrows[sl], keep, B, kk)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def adc_scan_tasks(
    blk: torch.Tensor,  # (Tc,) int32 block index of each task
    nrows: torch.Tensor,  # (Tc,) int32 valid rows in the block
    lids: torch.Tensor,  # (Tc,) int32 list of each task
    qids: torch.Tensor,  # (Tc, Qg) int rows of q of each task's queries, each in [0, nq)
    q: torch.Tensor,  # (nq, d) f32 queries (scan frame)
    qtab: torch.Tensor,  # (nq, m * ksub) f32 the table's query part (adc_qtable)
    clut: torch.Tensor,  # (nlist, m * ksub) bf16 (ignored for IP)
    cents: torch.Tensor,  # (nlist, d) f32 scan-frame centroids
    codes: torch.Tensor,  # (nb_pad + slack, mb) uint8
    keep: Optional[torch.Tensor] = None,  # (>= nb_pad,) bool keep-mask
    *,
    m: int,
    B: int,
    kk: int,
    is_l2: bool,
    nib: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not q.is_cuda:
        return adc_scan_plain(
            blk, nrows, lids, qids, q, qtab, clut, cents, codes, keep, m=m, B=B, kk=kk, is_l2=is_l2, nib=nib
        )
    Tc, Qg = qids.shape
    nq, d = q.shape
    ksub = qtab.shape[1] // m
    mb = m // 2 if nib else m
    if B != LIST_ALIGN or not 1 <= kk <= 32 or d % 4 or ksub > 256 or ksub & (ksub - 1):
        raise ValueError(f"ADC scan takes B={LIST_ALIGN}, kk<=32, d%4==0, ksub<=256 a power of two")
    if nib and (ksub != 16 or m % 2):
        raise ValueError("nibble codes need ksub=16 and an even m")
    if q.dtype != torch.float32 or qtab.dtype != torch.float32 or clut.dtype != torch.bfloat16:
        raise TypeError("ADC scan takes f32 queries and table and a bf16 clut")
    if codes.dtype != torch.uint8 or cents.dtype != torch.float32:
        raise TypeError("ADC scan takes uint8 codes and f32 centroids")
    _check_task_args(blk, nrows, qids, codes, keep, mb)
    if qtab.shape != (nq, m * ksub) or lids.shape != (Tc,) or cents.shape[1] != d:
        raise ValueError("ADC scan: qtab (nq, m*ksub), lids (Tc,), cents (nlist, d)")
    if clut.shape != (cents.shape[0], m * ksub):
        raise ValueError("ADC scan: clut (nlist, m*ksub)")
    if any(t.device != q.device for t in (qids, qtab, lids, clut, cents)):
        raise ValueError("ADC scan inputs must share one CUDA device")
    if adc_smem_bytes(m, ksub, nib) > SMEM_LIMIT:
        raise ValueError(f"ADC scan: m={m}, ksub={ksub} needs more shared memory than a block has")
    blk, nrows, lids = blk.int().contiguous(), nrows.int().contiguous(), lids.int().contiguous()
    qids, q, qtab, clut = qids.int().contiguous(), q.contiguous(), qtab.contiguous(), clut.contiguous()
    if qtab.data_ptr() % 16:  # the kernel copies the table 16 bytes at a time
        qtab = qtab.clone()
    cents, codes = cents.contiguous(), codes.contiguous()
    keep_u8 = keep.contiguous().view(torch.uint8) if keep is not None else None
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q.device)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_ivf_adc_scan(
        p(blk), p(nrows), p(lids), p(qids), p(q), p(qtab), p(clut), p(cents), p(codes), p(keep_u8),
        p(out_s), p(out_p), Tc, Qg, d, m, ksub, kk, int(is_l2), int(nib), cuda_build.stream_of(q),
    )
    cuda_build.check(code, "ivf_adc_scan")
    adc_scan_tasks.launches += 1
    return out_s, out_p


adc_scan_tasks.launches = 0
