"""Pairwise distances in PyTorch (counterpart of knowhere_tpu/ops/distances.py).

- IP:      Q @ B^T                                  (one matmul)
- L2^2:    |q|^2 - 2 Q@B^T + |b|^2                  (same matmul + rank-1 adds)
- COSINE:  (Q@B^T) / (|q| |b|)                      (similarity, larger=better)

Every f32 product here is full f32 (TF32 is off, see ``device.py``). The
precision mode does not change these products: it only selects which IVF
scan serves a search (EXACT keeps the f32 task scan; FAST and BF16 route to
the int8 or f32 scan kernels), exactly as the reference dispatches. Binary
metrics come with a later slice of the port.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..index_param import metric as M


class DistancePrecision(enum.Enum):
    EXACT = "exact"  # full f32 scan (the default, as in the reference)
    FAST = "fast"  # scan kernels (int8 candidates + exact rerank, or 3-pass f32)
    BF16 = "bf16"  # single-pass bf16 scan kernel


_PRECISION = DistancePrecision.EXACT


def set_distance_precision(p: DistancePrecision) -> None:
    global _PRECISION
    _PRECISION = DistancePrecision(p)


def get_distance_precision() -> DistancePrecision:
    return _PRECISION


def matmul_precision_name() -> str:
    return _PRECISION.value


def pad_rows_ladder(a: np.ndarray, minimum: int = 16) -> np.ndarray:
    """Pad a (n, ...) batch to the reference's row ladder: pow2 up to 8192,
    then multiples of 2048. The ladder does not change results; it is kept so
    the per-search shapes (and the task pools built from them) match the
    reference one to one."""
    n = a.shape[0]
    if n <= 8192:
        p = minimum
        while p < n:
            p *= 2
    else:
        p = (n + 2047) // 2048 * 2048
    if p == n:
        return a
    pad_shape = (p - n,) + a.shape[1:]
    return np.concatenate([a, np.zeros(pad_shape, a.dtype)])


def _dot(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(nq,d) x (nb,d) -> (nq,nb) f32."""
    return q.float() @ b.float().T


def ip_distance(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _dot(q, b)


def l2_sqr_distance(q: torch.Tensor, b: torch.Tensor, b_norms_sqr=None) -> torch.Tensor:
    dot = _dot(q, b)
    qn = (q.float() ** 2).sum(1, keepdim=True)
    if b_norms_sqr is None:
        b_norms_sqr = (b.float() ** 2).sum(1)
    return torch.clamp(qn - 2.0 * dot + b_norms_sqr[None, :], min=0.0)


def cosine_distance(q: torch.Tensor, b: torch.Tensor, b_norms=None) -> torch.Tensor:
    dot = _dot(q, b)
    qn = torch.sqrt((q.float() ** 2).sum(1, keepdim=True))
    if b_norms is None:
        b_norms = torch.sqrt((b.float() ** 2).sum(1))
    one = torch.ones((), device=q.device)
    denom = torch.where(qn == 0.0, one, qn) * torch.where(b_norms == 0.0, one, b_norms)[None, :]
    return dot / denom


_DENSE = {M.L2: False, M.IP: True, M.COSINE: True}


def larger_is_better(metric_name: str) -> bool:
    m = metric_name.upper()
    if m not in _DENSE:
        raise ValueError(f"unknown metric {metric_name}")
    return _DENSE[m]


def pairwise_distance(metric_name: str, q, b, aux=None) -> torch.Tensor:
    """(nq,d) x (nb,d) -> (nq,nb) distances/similarities."""
    m = metric_name.upper()
    if m == M.IP:
        return ip_distance(q, b)
    if m == M.L2:
        return l2_sqr_distance(q, b, aux)
    if m == M.COSINE:
        return cosine_distance(q, b, aux)
    raise ValueError(f"unknown metric {metric_name}")


def unpack_bits_host(packed: np.ndarray, dim_bits: int) -> np.ndarray:
    """(rows, dim_bits/8) uint8 -> (rows, dim_bits) int8 in {0,1}, LSB first
    (the reference's and faiss's bit order)."""
    packed = np.asarray(packed, dtype=np.uint8)
    rows = packed.shape[0]
    bits = np.unpackbits(packed.reshape(rows, -1), axis=1, bitorder="little")
    return bits[:, :dim_bits].astype(np.int8)


def base_aux(metric_name: str, b: torch.Tensor):
    """|b|^2 for L2, |b| for COSINE, None for IP."""
    m = metric_name.upper()
    if m == M.L2:
        return (b.float() ** 2).sum(1)
    if m == M.COSINE:
        return torch.sqrt((b.float() ** 2).sum(1))
    return None
