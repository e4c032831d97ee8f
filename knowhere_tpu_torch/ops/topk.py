"""Streaming tiled k-NN in plain PyTorch (counterpart of
knowhere_tpu/ops/topk.py).

FLAT's filtered and small-corpus path. The base is scanned in tiles; each
tile's (nq, tile) score block is merged into a running (nq, k) best, so the
full (nq, nb) matrix is never materialized. Scores are sign-normalized to
"larger is better" internally; the wrappers return the metric's native
convention. Ties go to the lower id, as ``jax.lax.top_k`` resolves them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from . import distances as D

_NEG_INF = -float("inf")

DEFAULT_TILE = 65536
DEFAULT_QUERY_CHUNK = 1024


def topk_leftmost(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k, larger first; among equal values the lower column
    wins (``torch.topk`` does not promise an order for ties)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def knn_device(
    q: torch.Tensor,
    base: torch.Tensor,
    k: int,
    metric_name: str,
    aux: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    tile: int = DEFAULT_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists (nq,k) native convention, ids (nq,k) int64, -1 pad)."""
    metric_name = metric_name.upper()
    sign = 1.0 if D.larger_is_better(metric_name) else -1.0
    nq, nb = q.shape[0], base.shape[0]
    best_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for s0 in range(0, nb, tile):
        e0 = min(s0 + tile, nb)
        a = aux[s0:e0] if aux is not None else None
        score = D.pairwise_distance(metric_name, q, base[s0:e0], a) * sign
        if mask is not None:
            score = score.masked_fill(~mask[s0:e0][None, :], _NEG_INF)
        ids = torch.arange(s0, e0, device=q.device, dtype=torch.int64)
        cat_s = torch.cat([best_s, score], dim=1)
        top_s, sel = topk_leftmost(cat_s, k)
        cat_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_s, best_i = top_s, torch.gather(cat_i, 1, sel)
    best_i = torch.where(best_s == _NEG_INF, torch.full_like(best_i, -1), best_i)
    return best_s * sign, best_i


def knn_search(
    queries: np.ndarray,
    base: torch.Tensor,
    k: int,
    metric_name: str,
    bitset_mask: Optional[torch.Tensor] = None,
    aux: Optional[torch.Tensor] = None,
    tile: int = DEFAULT_TILE,
    query_chunk: int = DEFAULT_QUERY_CHUNK,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-level brute-force kNN over a device-resident base: numpy (ids
    (nq,k) int64 with -1 padding, dists (nq,k) f32)."""
    from .. import comp as _comp

    q_all = np.asarray(queries, dtype=np.float32)
    nq = q_all.shape[0]
    out_ids = np.empty((nq, k), dtype=np.int64)
    out_dist = np.empty((nq, k), dtype=np.float32)
    for s in range(0, nq, query_chunk):
        _comp.check_current_cancellation()
        e = min(s + query_chunk, nq)
        dists, ids = knn_device(
            to_device(q_all[s:e]), base, k, metric_name, aux=aux, mask=bitset_mask, tile=tile
        )
        out_dist[s:e] = dists.cpu().numpy()
        out_ids[s:e] = ids.cpu().numpy()
    return out_ids, out_dist
