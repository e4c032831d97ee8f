"""Refine pass — exact re-scoring of gathered candidates (counterpart of
knowhere_tpu/ops/refine.py, raw kind).

The scan returns a widened candidate pool; this pass gathers the candidates'
raw rows and recomputes exact distances in one batched full-f32 product, then
re-selects the top-k (ties to the earlier candidate, as ``jax.lax.top_k``).
The reference leaves this to XLA; here it is plain torch ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk import topk_leftmost


def refine_topk_device(
    q: torch.Tensor,  # (nq, d) f32
    data: torch.Tensor,  # (nb_pad + slack, d) raw rows in sorted storage order
    cand: torch.Tensor,  # (nq, R) int32 positions into data, -1 padded
    k: int,
    is_l2: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dists (nq,k) native convention, positions (nq,k), -1 pad)."""
    vecs = data[cand.clamp(min=0).long()].float()  # (nq, R, d)
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
