"""Pairwise distances in PyTorch (counterpart of knowhere_tpu/ops/distances.py).

- IP:      Q @ B^T                                  (one matmul)
- L2^2:    |q|^2 - 2 Q@B^T + |b|^2                  (same matmul + rank-1 adds)
- COSINE:  (Q@B^T) / (|q| |b|)                      (similarity, larger=better)

Every f32 product here is full f32 (TF32 is off, see ``device.py``). The
precision mode does not change these products: it only selects which IVF
scan serves a search (EXACT keeps the f32 task scan; FAST and BF16 route to
the int8 or f32 scan kernels), exactly as the reference dispatches.

The binary metrics score bit-unpacked {0,1} planes (unpack_bits_host):
the intersection popcount(q & b) is one f32 product of the planes, exact
for counts below 2^24 (the reference takes it as an int8 product into
int32), and the popcounts are row sums:

- HAMMING:        |q| + |b| - 2 inter
- JACCARD:        1 - inter / (|q| + |b| - inter), 0 where the union is empty
- SUBSTRUCTURE:   |q| - inter      (0 iff q is a subset of b)
- SUPERSTRUCTURE: |b| - inter      (0 iff q is a superset of b)
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


def _popcount(bits: torch.Tensor) -> torch.Tensor:
    return bits.float().sum(1)


def hamming_distance(q: torch.Tensor, b: torch.Tensor, b_pop=None) -> torch.Tensor:
    inter = _dot(q, b)
    if b_pop is None:
        b_pop = _popcount(b)
    return _popcount(q)[:, None] + b_pop.float()[None, :] - 2.0 * inter


def jaccard_distance(q: torch.Tensor, b: torch.Tensor, b_pop=None) -> torch.Tensor:
    inter = _dot(q, b)
    if b_pop is None:
        b_pop = _popcount(b)
    union = _popcount(q)[:, None] + b_pop.float()[None, :] - inter
    return torch.where(union == 0.0, torch.zeros_like(union), 1.0 - inter / union)


def substructure_distance(q: torch.Tensor, b: torch.Tensor, b_pop=None) -> torch.Tensor:
    return _popcount(q)[:, None] - _dot(q, b)


def superstructure_distance(q: torch.Tensor, b: torch.Tensor, b_pop=None) -> torch.Tensor:
    if b_pop is None:
        b_pop = _popcount(b)
    return b_pop.float()[None, :] - _dot(q, b)


# metric name -> (distance(q, b, aux), larger is better)
_METRICS = {
    M.L2: (l2_sqr_distance, False),
    M.IP: (lambda q, b, aux=None: ip_distance(q, b), True),
    M.COSINE: (cosine_distance, True),
    M.HAMMING: (hamming_distance, False),
    M.JACCARD: (jaccard_distance, False),
    M.SUBSTRUCTURE: (substructure_distance, False),
    M.SUPERSTRUCTURE: (superstructure_distance, False),
}
_BINARY = (M.HAMMING, M.JACCARD, M.SUBSTRUCTURE, M.SUPERSTRUCTURE)


def is_binary_metric(metric_name: str) -> bool:
    return metric_name.upper() in _BINARY


def larger_is_better(metric_name: str) -> bool:
    m = metric_name.upper()
    if m not in _METRICS:
        raise ValueError(f"unknown metric {metric_name}")
    return _METRICS[m][1]


def pairwise_distance(metric_name: str, q, b, aux=None) -> torch.Tensor:
    """(nq,d) x (nb,d) -> (nq,nb) distances/similarities; binary metrics
    take bit-unpacked {0,1} planes."""
    m = metric_name.upper()
    if m not in _METRICS:
        raise ValueError(f"unknown metric {metric_name}")
    return _METRICS[m][0](q, b, aux)


def unpack_bits_host(packed: np.ndarray, dim_bits: int) -> np.ndarray:
    """(rows, dim_bits/8) uint8 -> (rows, dim_bits) int8 in {0,1}, LSB first
    (the reference's and faiss's bit order)."""
    packed = np.asarray(packed, dtype=np.uint8)
    rows = packed.shape[0]
    bits = np.unpackbits(packed.reshape(rows, -1), axis=1, bitorder="little")
    return bits[:, :dim_bits].astype(np.int8)


def base_aux(metric_name: str, b: torch.Tensor):
    """|b|^2 for L2, |b| for COSINE, the popcount for HAMMING, JACCARD and
    SUPERSTRUCTURE, None for IP and SUBSTRUCTURE."""
    m = metric_name.upper()
    if m == M.L2:
        return (b.float() ** 2).sum(1)
    if m == M.COSINE:
        return torch.sqrt((b.float() ** 2).sum(1))
    if m in (M.HAMMING, M.JACCARD, M.SUPERSTRUCTURE):
        return _popcount(b)
    return None
