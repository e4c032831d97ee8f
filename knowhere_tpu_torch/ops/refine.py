"""Refine pass — exact re-scoring of gathered candidates (counterpart of
knowhere_tpu/ops/refine.py).

The scan returns a widened candidate pool; this pass gathers the candidates'
refine rows (raw f32/fp16/bf16 rows, or SQ8 codes decoded with per-dim
affine parameters) and recomputes their distances in a batched full-f32
product over a step of queries, then re-selects the top-k (ties to the
earlier candidate, as ``jax.lax.top_k``). The reference leaves this to
XLA; here it is plain torch ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from .topk import topk_leftmost

SQ8_LEVELS = 256


def sq8_encode(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SQ8 refine rows (the reference's sq_train + sq_encode, SQ8): per-dim
    vmin / vdiff from the rows, codes floor((x - vmin) / vdiff * 256) clipped
    to [0, 255]. Returns (codes (n, d) uint8, vmin (d,) f32, vdiff (d,) f32)."""
    vmin = x.min(axis=0).astype(np.float32)
    vdiff = np.maximum(x.max(axis=0).astype(np.float32) - vmin, 1e-20).astype(np.float32)
    codes = np.clip(np.floor((x - vmin[None, :]) / vdiff[None, :] * SQ8_LEVELS), 0, SQ8_LEVELS - 1)
    return codes.astype(np.uint8), vmin, vdiff


@dataclass
class RefineStore:
    """Device rows the refine pass scores: kind 'raw' (f32, fp16 or bf16 rows)
    or 'sq8' (uint8 codes with per-dim vmin / vdiff)."""

    kind: str
    data: torch.Tensor  # (nb_pad [+ slack], d) rows in sorted storage order
    vmin: Optional[torch.Tensor] = None
    vdiff: Optional[torch.Tensor] = None

    def row_bytes(self) -> int:
        """Device bytes one gathered candidate row holds during the pass: its
        f32 row and one f32 temporary of the same size (the L2 norms'
        product, or a decode step), plus the gathered source row where the
        store is not f32."""
        src = self.data.element_size() if self.data.dtype != torch.float32 else 0
        return self.data.shape[1] * (8 + src)

    def rows(self, pos: torch.Tensor) -> torch.Tensor:
        """f32 rows at storage positions ``pos`` (any shape, all >= 0)."""
        vecs = self.data[pos.long()]
        if self.kind == "sq8":
            return self.vmin + (vecs.float() + 0.5) / SQ8_LEVELS * self.vdiff
        return vecs.float()


def refine_topk_device(
    q: torch.Tensor,  # (nq, d) f32
    store: RefineStore,
    cand: torch.Tensor,  # (nq, R) int32 positions into store.data, -1 padded
    k: int,
    is_l2: bool,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dists (nq,k) native convention, positions (nq,k), -1 pad).
    ``chunk`` queries are re-scored a step (all of them by default). A
    batched product's sums may change with its batch, so a query's bits
    depend on the step it is in: a caller that splits a batch splits it at
    multiples of ``chunk`` to get the same bits."""
    nq = cand.shape[0]
    step = nq if chunk is None else max(1, chunk)
    if step >= nq:
        return _refine_step(q[:nq], store, cand, k, is_l2)
    parts = [_refine_step(q[c : c + step], store, cand[c : c + step], k, is_l2) for c in range(0, nq, step)]
    return torch.cat([d for d, _ in parts]), torch.cat([p for _, p in parts])


def _refine_step(q, store: RefineStore, cand, k: int, is_l2: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    vecs = store.rows(cand.clamp(min=0))  # (nq, R, d)
    dots = torch.einsum("qd,qrd->qr", q, vecs)
    if is_l2:
        dist = (q * q).sum(1, keepdim=True) - 2.0 * dots + (vecs * vecs).sum(2)
        score = -dist
    else:
        score = dots
    score = torch.where(cand >= 0, score, torch.full_like(score, -float("inf")))
    best_s, sel = topk_leftmost(score, k)
    best_i = torch.gather(cand, 1, sel)
    best_i = torch.where(best_s == -float("inf"), torch.full_like(best_i, -1), best_i)
    return (-best_s if is_l2 else best_s), best_i


def refine_topk(
    q,  # (nq, d) f32: a device tensor or a numpy array
    store: RefineStore,
    cand_ids: np.ndarray,  # (nq, R) positions into store.data, -1 padded
    k: int,
    is_l2: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper of refine_topk_device: numpy candidates in, numpy
    (dists (nq,k) native convention, positions (nq,k) into the store, -1 pad)
    out."""
    dists, pos = refine_topk_device(
        to_device(q), store, to_device(np.asarray(cand_ids, dtype=np.int32)), k, is_l2
    )
    return dists.cpu().numpy(), pos.cpu().numpy()
