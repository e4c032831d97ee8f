"""The port's IVF_PQ search held to the plain reference (ann_bench/ivf_pq_plain.py),
shared by tests/test_torch_gist_ivf_pq.py (CPU, small) and
tests/test_torch_gist_ivf_pq_card.py (the card, 1M x 960). It imports no JAX.

`port_search` runs `Index.Search` and keeps the pool its scan handed the
refine pass: storage positions and ADC scores, the normal path's own.
`compare` holds the port's answers and pool to the reference's, in float64:

- The ADC pool. For a candidate both pools hold, the port's ADC distance
  (|q|^2 less its scan score) differs from the reference's exact one only by
  the port's bf16 table (ops/adc_cuda.py), a subspace j at a time: the entry
  2 <q'_j, b> - clut lands on either bf16 neighbour of its f32 sum (one unit:
  the kernel's tensor-core order may round the other way), the clut term
  2 <c'_j, b> + |b|^2 is rounded to bf16 (half a unit) and the codewords b of
  the query product are bf16 (half a unit each, times 2 |q'_s|). Their sum
  over the m subspaces, plus the f32 arithmetic around it, is the candidate's
  `bound`: every common candidate lies within it (`adc_over_bound` 0).
- Their size. The roundings are independent and uniform, so their mean
  square is sum_j (ulp_entry^2 + ulp_clut^2 + 4 sum_s q'_s^2 ulp_b^2) / 12:
  `adc_mse_ratio`, the measured mean square over that, is about 1 and at
  most ADC_MSE_RATIO_MAX (a table of a coarser type reads many times more).
- The lo part. The table takes the query as bf16 hi plus bf16 lo
  (hi = bf16(q'), lo = bf16(q' - hi)); without lo each distance would be off
  by e_lo = sum_j 2 <lo_j, b>. `adc_lo_coef`, the least-squares coefficient
  of the errors on e_lo, is about 0 with it and about 1 without it; it must
  stay under ADC_LO_COEF_MAX. (e_lo is a third of the rounding's size, so
  the bound and the mean square alone would not see it.)
- Ids. A reference answer may be missing from the port's only where the
  table can reorder it: its ADC distance within 2 x the query's largest
  bound of the pool's cut (it and a row past the cut may each move by one
  bound); or at least KK - 1 rows of its 512-row block in the pool within
  that margin below it, since a task keeps its KK best rows a query
  (ops/ivf_cuda.task_kk, as the reference's kernels); or its refined
  distance within TIE_RTOL of the k-th. `id_share_min` is one less the
  share of such answers, `id_share` the share of the reference's ids the
  port returns.
- Distances. For every id both return, the port's refined distance
  (|q|^2 - 2 <q, x> + |x|^2 in f32) and the reference's (differences in
  f32) agree within `tol` = 4 sqrt(d) units of f32 roundoff of
  (|q| + |x|)^2 + dist: the probabilistic bound of f32 sums of d terms
  (`dist_over_tol` 0). BF16 refine rows (3 mantissa bits fewer than FP16)
  move a distance by about 1e-4 of itself, many times `tol`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.models import ivf as ivf_model

ADC_MSE_RATIO_MAX = 1.25
ADC_LO_COEF_MAX = 0.5
KK = 32  # a task's per-query width at k x refine_k >= 32 (ops/ivf_cuda.task_kk)
BLOCK = 512  # a task's rows (ops/ivf_cuda.LIST_ALIGN)
U32 = 2.0 ** -24  # f32 unit roundoff
TIE_RTOL = 1e-4  # refined distances this near the k-th may swap: ten times `tol` over a distance


def port_search(idx, xq: np.ndarray, cfg: dict):
    """(dists (nq, k), ids (nq, k), pool positions (nq, R), pool scores
    (nq, R)) of idx.Search; the pool as the scan handed it to the refine."""
    pool = {}
    real = ivf_model.ivf_scan_search

    def keep(*args, **kw):
        pool["s"], pool["p"] = real(*args, **kw)
        return pool["s"], pool["p"]

    ivf_model.ivf_scan_search = keep
    try:
        res = idx.Search(ktt.GenDataSetFromArray(xq), cfg, ktt.BitsetView())
    finally:
        ivf_model.ivf_scan_search = real
    assert res.has_value(), res.what()
    nq, k = xq.shape[0], int(cfg["k"])
    width = min(k * int(cfg["refine_k"]), pool["p"].shape[1])
    return (torch.from_numpy(res.value().distance.reshape(nq, k)).double(),
            torch.from_numpy(res.value().ids.reshape(nq, k)).long(),
            pool["p"][:nq, :width].long().cpu(), pool["s"][:nq, :width].double().cpu())


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 unit at |x| (8 significant bits), in f64."""
    _, e = torch.frexp(x.abs().clamp(min=1e-30))
    return torch.ldexp(torch.ones_like(x), (e - 8).to(torch.int32))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).double()


def adc_terms(plain, xq: torch.Tensor, pos: torch.Tensor):
    """(bound, rounding variance, e_lo), each (nq, R) f64, of the port's ADC
    distance at storage positions pos (>= 0) of each query's pool."""
    books = plain.codebooks.double().cpu()
    m, _, sub = books.shape
    rot = plain.rotation.double().cpu()
    lists = torch.searchsorted(torch.from_numpy(plain.offsets[:-1]), pos, right=True) - 1
    cents = plain.centroids.double().cpu()[lists]
    q = xq.double()
    qr = q @ rot.T
    hi = _bf16(qr)
    lo = _bf16(qr.float().double() - hi).reshape(len(q), 1, m, sub)
    qr = qr.reshape(len(q), 1, m, sub)
    cr = (cents @ rot.T).reshape(*pos.shape, m, sub)
    codes = plain.codes[pos.to(plain.codes.device)].long().cpu()
    b = books[torch.arange(m)[None, None, :], codes]  # (nq, R, m, sub)
    clut = 2.0 * (cr * b).sum(-1) + (b * b).sum(-1)
    entry = 2.0 * (qr * b).sum(-1) - clut
    u_b, u_clut = _ulp(b), _ulp(clut)
    books_err = (qr.abs() * u_b).sum(-1)  # 2 |q'| x half a unit
    u_entry = _ulp(entry.abs() + u_clut / 2 + books_err + 1e-3)  # the unit of the f32 sum it rounds
    slack = 1e-5 * ((q * q).sum(-1)[:, None] + (cents * cents).sum(-1)) + 2.0 ** -15 * (qr.abs() * b.abs()).sum((-1, -2))
    bound = (u_entry + u_clut / 2 + books_err).sum(-1) + slack
    var = (u_entry ** 2 + u_clut ** 2 + 4.0 * (qr ** 2 * u_b ** 2).sum(-1)).sum(-1) / 12.0
    e_lo = 2.0 * (lo * b).sum((-1, -2))
    return bound, var, e_lo


def compare(plain, xq: np.ndarray, port, ref, stages, k: int) -> dict:
    """The numbers the module's checks read (its docstring): the pool's
    `adc_common`, `adc_pool_share`, `adc_over_bound`, `adc_max_err`,
    `adc_max_bound`, `adc_mse_ratio`, `adc_lo_coef`; `id_share`,
    `id_share_min`; `dist_max_rel`, `dist_over_tol`."""
    p_dist, p_ids, p_pos, p_score = port
    r_dist, r_ids = ref[0].double().cpu(), ref[1].long().cpu()
    a_pos, a_dist = stages["adc_pos"].cpu(), stages["adc_dist"].double().cpu()
    q = torch.from_numpy(xq).double()
    live = a_pos >= 0
    out = {}
    # the ADC pool: the candidates both hold, against their bound
    same = (p_pos[:, :, None] == a_pos[:, None, :]) & live[:, None, :]  # (nq, port R, reference R)
    common = same.any(1)
    p_d = (q * q).sum(1, keepdim=True) - p_score
    err = ((same.double() * p_d[:, :, None]).sum(1) - a_dist)[common]
    bound, var, e_lo = adc_terms(plain, q, a_pos.clamp(min=0))
    out["adc_common"] = int(common.sum())
    out["adc_pool_share"] = out["adc_common"] / int(live.sum())
    out["adc_over_bound"] = int((err.abs() > bound[common]).sum())
    out["adc_max_err"] = float(err.abs().max())
    out["adc_max_bound"] = float(bound[common].max())
    out["adc_mse_ratio"] = float((err ** 2).sum() / var[common].sum())
    out["adc_lo_coef"] = float((err * e_lo[common]).sum() / (e_lo[common] ** 2).sum())
    # ids: the reference's answers the table or the task width may move
    margin = 2.0 * torch.where(live, bound, torch.zeros_like(bound)).max(1, keepdim=True).values
    cut = torch.where(live, a_dist, torch.full_like(a_dist, -math.inf)).max(1, keepdim=True).values
    blk = a_pos // BLOCK
    crowd = ((blk[:, :, None] == blk[:, None, :]) & live[:, None, :]
             & (a_dist[:, None, :] < a_dist[:, :, None] + margin[:, :, None])).sum(2) - 1
    movable = live & ((a_dist >= cut - margin) | (crowd >= KK - 1))
    row_ids = plain.row_ids[a_pos.clamp(min=0).to(plain.row_ids.device)].cpu()
    a_ids = torch.where(live, row_ids, torch.full_like(a_pos, -1))
    tie = r_dist >= r_dist[:, k - 1 : k] * (1.0 - TIE_RTOL)
    risky = tie | ((r_ids[:, :, None] == a_ids[:, None, :]) & movable[:, None, :]).any(2)
    hit = (r_ids[:, :, None] == p_ids[:, None, :]).any(2) & (r_ids >= 0)
    out["id_share"] = float(hit.double().mean())
    out["id_share_min"] = 1.0 - float(risky.double().mean())
    # distances of the ids both return
    qi, ri, pi = torch.nonzero((r_ids[:, :, None] == p_ids[:, None, :]) & (r_ids >= 0)[:, :, None], as_tuple=True)
    rd, pd = r_dist[qi, ri], p_dist[qi, pi]
    x_pos = a_pos[qi][a_ids[qi] == r_ids[qi, ri][:, None]]  # each answer's row in the reference's pool
    x_row = plain.refine[x_pos.to(plain.refine.device)].double().cpu()
    tol = 4.0 * math.sqrt(xq.shape[1]) * U32 * ((q[qi].norm(dim=1) + x_row.norm(dim=1)) ** 2 + rd)
    out["dist_max_rel"] = float(((pd - rd).abs() / rd).max())
    out["dist_over_tol"] = int(((pd - rd).abs() > tol).sum())
    return out


def failed(numbers: dict) -> list:
    """The names of the checks `numbers` (compare's) fail."""
    checks = {
        "adc_bound": numbers["adc_over_bound"] == 0,
        "adc_mse_ratio": numbers["adc_mse_ratio"] <= ADC_MSE_RATIO_MAX,
        "adc_lo": numbers["adc_lo_coef"] <= ADC_LO_COEF_MAX,
        "id_share": numbers["id_share"] >= numbers["id_share_min"],
        "distances": numbers["dist_over_tol"] == 0,
    }
    return [name for name, ok in checks.items() if not ok]
