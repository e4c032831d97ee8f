"""Range search — all neighbours within a radius, in CSR form (counterpart
of knowhere_tpu/ops/range.py).

The window is the reference's (include/knowhere/range_util.h:22-25):
- distance metrics (L2):          keep if  range_filter <= dist < radius
- similarity metrics (IP/COSINE): keep if  radius < dist <= range_filter
where range_filter = +inf (the default) means "radius bound only".

Each (query chunk, base tile) block computes its distances, evaluates the
keep predicate and compacts the survivors with one ``nonzero``, all on the
device. The CSR is then built there too, by two stable sorts: by distance
(best first), then by query. Hits arrive in ascending id within a query, so
equal distances keep ascending id, as the reference's per-query stable
argsort of id-ordered hits gives. Only the final (ids, dists, lims) cross to
the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_RANGE_FILTER
from ..device import to_device
from . import distances as D


def in_window(dist, radius: float, range_filter: float, larger: bool, two_sided: bool):
    """The window's keep mask of ``dist`` (a tensor or a numpy array)."""
    if larger:
        keep = dist > radius
        if two_sided:
            keep &= dist <= range_filter
    else:
        keep = dist < radius
        if two_sided:
            keep &= dist >= range_filter
    return keep


def range_search(
    queries: np.ndarray,
    base: torch.Tensor,
    radius: float,
    range_filter: float,
    metric_name: str,
    bitset_mask: Optional[torch.Tensor] = None,
    aux: Optional[torch.Tensor] = None,
    tile: int = 65536,
    query_chunk: int = 1024,
    id_map: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (ids int64, dists f32, lims int64[nq+1]) in CSR form, each
    query's hits best first."""
    metric_name = metric_name.upper()
    larger = D.larger_is_better(metric_name)
    q_all = np.asarray(queries, dtype=np.float32)
    nq, nb = q_all.shape[0], base.shape[0]
    two_sided = not (range_filter == DEFAULT_RANGE_FILTER or np.isinf(range_filter))
    # the predicate compares f32 distances with the f32-rounded bounds, as
    # the reference does
    radius, range_filter = float(np.float32(radius)), float(np.float32(range_filter))

    rows, cols, vals = [], [], []
    for qs in range(0, nq, query_chunk):
        q_dev = to_device(q_all[qs : qs + query_chunk])
        for bs in range(0, nb, tile):
            be = min(bs + tile, nb)
            a = aux[bs:be] if aux is not None else None
            dist = D.pairwise_distance(metric_name, q_dev, base[bs:be], a)
            keep = in_window(dist, radius, range_filter, larger, two_sided)
            if bitset_mask is not None:
                keep &= bitset_mask[bs:be][None, :]
            r, c = torch.nonzero(keep, as_tuple=True)
            rows.append(r + qs)
            cols.append(c + bs)
            vals.append(dist[r, c])
    if not rows:
        return np.empty(0, np.int64), np.empty(0, np.float32), np.zeros(nq + 1, np.int64)
    row, col, val = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    by_dist = torch.sort(-val if larger else val, stable=True).indices
    row, col, val = row[by_dist], col[by_dist], val[by_dist]
    by_query = torch.sort(row, stable=True).indices
    col, val = col[by_query], val[by_query]
    counts = torch.bincount(row, minlength=nq)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=lims[1:])
    ids = col.cpu().numpy().astype(np.int64)
    if id_map is not None:
        ids = np.asarray(id_map)[ids].astype(np.int64)
    return ids, val.cpu().numpy().astype(np.float32), lims


def apply_range_search_k(
    ids: np.ndarray,
    dists: np.ndarray,
    lims: np.ndarray,
    range_search_k: int,
    larger_is_closer: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cap each query's range hits to its best ``range_search_k`` (the
    reference's BaseConfig range_search_k; -1 = unlimited). Hits arrive best
    first, so the cap is a slice of each query's run."""
    del larger_is_closer  # hits arrive best first; kept for the signature
    if range_search_k is None or range_search_k < 0:
        return ids, dists, lims
    lims = np.asarray(lims, np.int64)
    counts = np.minimum(np.diff(lims), range_search_k)
    new_lims = np.zeros_like(lims)
    np.cumsum(counts, out=new_lims[1:])
    # position of each kept hit: its query's start plus its rank there
    take = np.repeat(lims[:-1], counts) + (np.arange(int(new_lims[-1])) - np.repeat(new_lims[:-1], counts))
    return ids[take], dists[take], new_lims
