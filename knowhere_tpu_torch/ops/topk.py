"""Streaming tiled k-NN in plain PyTorch (counterpart of
knowhere_tpu/ops/topk.py).

FLAT's filtered and small-corpus path, BruteForce's and the IVF pending
rows'. The base is scanned in tiles; each tile's (nq, tile) score block is
reduced to its candidates and merged into a running (nq, k) best, so the
full (nq, nb) matrix is never materialized. Scores are sign-normalized to
"larger is better" internally; the wrappers return the metric's native
convention.

The selection is the reference's, step for step, so that ties (the binary
metrics' small integer distances hold many) resolve as they do there: a
tile whose width is a GROUP multiple, with at least two groups and k of
them at most, keeps the rows of its k groups of largest maximum (exact:
every top-k row lies in such a group), in the order of their groups'
maxima; other tiles keep their top k. The merge takes the top k of the
running best followed by the tile's candidates. Every top k takes the
leftmost among equal scores, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from . import distances as D

_NEG_INF = -float("inf")

DEFAULT_TILE = 131072
DEFAULT_QUERY_CHUNK = 1024
GROUP = 64  # rows a group of the group-max selection
# f32 rows this wide take topk_leftmost's packed key: on an H100 the stable
# sort is faster up to 4,096 columns and slower from 8,192 (topk_ab.py)
PACKED_MIN_COLS = 8192


def topk_leftmost(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k, larger first; among equal values the lower column
    wins (``torch.topk`` does not promise an order for ties). f32 rows of
    at least PACKED_MIN_COLS columns take the packed-key selection, others
    the stable sort; both give the same values and columns."""
    if scores.dtype == torch.float32 and scores.shape[1] >= PACKED_MIN_COLS:
        return _topk_packed(scores, k)
    return _topk_sorted(scores, k)


def _topk_sorted(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _topk_packed(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each f32 value and its column packed into one int64 key: the value's
    bits made order-preserving in the high word (-0.0 as +0.0, every NaN as
    the positive NaN the sort puts first), the column reversed in the low
    word. The keys are distinct, so torch.topk's k largest are the sort's
    first k, in its order, without sorting whole rows."""
    s = torch.where(torch.isnan(scores), float("nan"), scores + 0.0)
    bits = s.view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    col = torch.arange(scores.shape[1], device=scores.device, dtype=torch.int64)
    key = (ordered.long() << 32) | (0xFFFFFFFF - col)[None, :]
    idx = torch.topk(key, min(k, scores.shape[1]), dim=1).indices
    return torch.gather(scores, 1, idx), idx


def _tile_candidates(score: torch.Tensor, kk: int, groups: bool, off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, ids) a tile contributes to the merge: the rows of its kk
    groups of largest maximum (``groups``; the width a GROUP multiple), or
    its top kk."""
    nq = score.shape[0]
    if not groups:
        s_t, i_t = topk_leftmost(score, kk)
        return s_t, i_t + off
    sg = score.reshape(nq, -1, GROUP)
    _, g_i = topk_leftmost(sg.amax(dim=2), kk)  # (nq, kk) winning groups
    cand = torch.gather(sg, 1, g_i[:, :, None].expand(-1, -1, GROUP))
    ids = g_i[:, :, None] * GROUP + torch.arange(GROUP, device=score.device)[None, None, :] + off
    return cand.reshape(nq, kk * GROUP), ids.reshape(nq, kk * GROUP)


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
    tile = min(tile, max(nb, 1))
    n_full = nb // tile
    best_s = torch.full((nq, k), _NEG_INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for s0 in range(0, nb, tile):
        e0 = min(s0 + tile, nb)
        a = aux[s0:e0] if aux is not None else None
        score = D.pairwise_distance(metric_name, q, base[s0:e0], a) * sign
        if mask is not None:
            score = score.masked_fill(~mask[s0:e0][None, :], _NEG_INF)
        width = e0 - s0
        kk = min(k, width)
        if s0 < n_full * tile:  # a full tile: groups only when its width is a GROUP multiple
            n_groups = width // GROUP
            groups = width % GROUP == 0 and kk <= n_groups and n_groups >= 2
        else:  # the remainder: padded with -inf to a GROUP multiple
            n_groups = -(-width // GROUP)
            groups = kk <= n_groups and n_groups >= 2
            if groups and width % GROUP:
                score = torch.nn.functional.pad(score, (0, n_groups * GROUP - width), value=_NEG_INF)
        s_t, i_t = _tile_candidates(score, kk, groups, s0)
        top_s, sel = topk_leftmost(torch.cat([best_s, s_t], dim=1), k)
        best_s, best_i = top_s, torch.gather(torch.cat([best_i, i_t], dim=1), 1, sel)
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
