"""The arithmetic of the end-to-end metrics and the comparison that decides
`correct`.

Every request answered in the window is judged against the plain reference
(`reference.py`) once the window has closed:
- `bad_answers`: entries that break Knowhere's result contract: an id out of
  range, -1 while enough kept rows exist, an id filtered out by the
  request's bitset, an id twice in a row, a distance not finite or out of
  ascending order. Limit 0.
- `recall_at_10`: the share of each query's exact 10 nearest kept rows that
  its answer holds, over every query answered; the cell states its minimum.
- `dist_rel_err`: the widest gap between a returned distance and the exact
  squared L2 of the returned id (float64 by differences), relative to the
  latter, over a seeded sample of queries of every request. The limit lies
  between the program's readings and its control's (PERF.md).
- `failed`: requests that returned an error. Limit 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import reference

SAMPLE_PER_REQUEST = 256  # queries of each request whose distances are recomputed


def p95(values: Sequence[float]) -> float:
    """95th percentile by nearest rank: the smallest value with at least 95%
    of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def recall_hits(ids: torch.Tensor, truth: torch.Tensor) -> int:
    """How many of truth's valid ids each row of ids holds, summed."""
    hit = (ids[:, :, None] == truth[:, None, :]) & (truth[:, None, :] >= 0)
    return int(hit.any(dim=1).sum())


def bad_entries(ids: torch.Tensor, dists: torch.Tensor, nb: int, keep: Optional[torch.Tensor], want: int) -> int:
    """Entries of (n, k) answers that break the result contract; `want` is
    how many valid ids a row must hold (min(k, kept rows))."""
    valid = ids >= 0
    bad = (ids >= nb) | (ids < -1)
    bad |= (~valid) & (torch.arange(ids.shape[1], device=ids.device)[None, :] < want)
    safe = ids.clamp(0, nb - 1)
    if keep is not None:
        bad |= valid & ~keep[safe]
    srt, _ = torch.sort(torch.where(valid, ids, torch.full_like(ids, -1)), dim=1)
    bad[:, 1:] |= (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    bad |= valid & ~torch.isfinite(dists)
    fin = torch.where(valid, dists, torch.full_like(dists, float("inf")))
    bad[:, 1:] |= fin[:, 1:] < fin[:, :-1]
    return int(bad.sum())


def judge(
    answers: List[Tuple[int, np.ndarray, np.ndarray]],
    pool: torch.Tensor,
    nq: int,
    xb: torch.Tensor,
    keep: Optional[torch.Tensor],
    truth: Dict[int, torch.Tensor],
    k: int,
    seed: int,
) -> Dict[str, float]:
    """The compared numbers of a run's answers: (block, ids (nq, k),
    distances (nq, k)) per answered request, judged against the reference's
    `truth` ids of each pool block."""
    dev = xb.device
    nb = xb.shape[0]
    want = min(k, nb if keep is None else int(keep.sum()))
    g = np.random.default_rng(int(seed) % (1 << 63) + 1)
    bad = hits = total = 0
    err = 0.0
    for block, ids_np, dists_np in answers:
        ids = torch.from_numpy(np.ascontiguousarray(ids_np)).to(dev).long()
        dists = torch.from_numpy(np.ascontiguousarray(dists_np)).to(dev).float()
        bad += bad_entries(ids, dists, nb, keep, want)
        t = truth[block]
        hits += recall_hits(ids[:, :k], t[:, :k])
        total += int((t[:, :k] >= 0).sum())
        rows = torch.from_numpy(g.choice(nq, size=min(SAMPLE_PER_REQUEST, nq), replace=False)).to(dev)
        sid, sd = ids[rows], dists[rows]
        ok = (sid >= 0) & (sid < nb)
        q = pool[block * nq + rows]
        exact = reference.exact_dist(q, xb[sid.clamp(0, nb - 1)])
        gap = (sd.double() - exact).abs() / exact.clamp(min=1e-30)
        if bool(ok.any()):
            err = max(err, float(gap[ok].max()))
    return {
        "bad_answers": float(bad),
        "recall_at_10": hits / total if total else 0.0,
        "dist_rel_err": err,
    }


def verdict(numbers: Dict[str, float], failed: int, limits: Dict[str, float]) -> Tuple[bool, Dict[str, list]]:
    """(correct, {check name: [number, limit]}). A `_max` check holds where
    the number is at most its limit, a `_min` check where it is at least."""
    checks = {
        "failed_max": [float(failed), 0.0],
        "bad_answers_max": [numbers["bad_answers"], 0.0],
        "recall_at_10_min": [numbers["recall_at_10"], float(limits["recall_at_10_min"])],
        "dist_rel_err_max": [numbers["dist_rel_err"], float(limits["dist_rel_err_max"])],
    }
    ok = all(v <= lim if name.endswith("_max") else v >= lim for name, (v, lim) in checks.items())
    return ok, checks
