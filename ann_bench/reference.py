"""The plain reference: exact k nearest neighbours under squared L2.

Plain PyTorch, with TF32 off, in tiles of queries and rows. It imports
nothing of the program and takes nothing the program made: it reads the
corpus and the queries the benchmark drew itself.

`precision` selects the control's lower precision, which puts the reference
in the program's place to show that the comparison fails it:
- "f32": the reference itself;
- "tf32": the products' operands rounded to TF32's 10 mantissa bits (the
  step below float32 with TF32 off), the norms in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

PRECISIONS = ("f32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest (ties to even) at 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _operands(xq: torch.Tensor, xb: torch.Tensor, precision: str):
    """(queries and rows for the product, queries and rows for the norms)."""
    if precision == "f32":
        return xq, xb, xq, xb
    if precision == "tf32":
        return round_tf32(xq), round_tf32(xb), xq, xb
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


def knn(
    xq: torch.Tensor,
    xb: torch.Tensor,
    k: int,
    keep: Optional[torch.Tensor] = None,
    precision: str = "f32",
    q_tile: int = 1024,
    b_tile: int = 1 << 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared L2 distances (nq, k) ascending, ids (nq, k) int64) of each
    query's k nearest kept rows; -1 and +inf past the kept rows' count."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qp, bp, qn, bn = _operands(xq.float(), xb.float(), precision)
        b_sq = (bn * bn).sum(1)
        out_d, out_i = [], []
        for q0 in range(0, len(xq), q_tile):
            q, q_n = qp[q0 : q0 + q_tile], qn[q0 : q0 + q_tile]
            q_sq = (q_n * q_n).sum(1, keepdim=True)
            best_d = torch.full((len(q), k), float("inf"), device=xq.device)
            best_i = torch.full((len(q), k), -1, dtype=torch.int64, device=xq.device)
            for b0 in range(0, len(xb), b_tile):
                b1 = min(b0 + b_tile, len(xb))
                d = q_sq - 2.0 * (q @ bp[b0:b1].T) + b_sq[None, b0:b1]
                if keep is not None:
                    d = d.masked_fill(~keep[None, b0:b1], float("inf"))
                kk = min(k, b1 - b0)
                td, ti = torch.topk(d, kk, dim=1, largest=False)
                cat_d = torch.cat([best_d, td], 1)
                cat_i = torch.cat([best_i, ti + b0], 1)
                best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
                best_i = torch.gather(cat_i, 1, sel)
            best_i = torch.where(torch.isinf(best_d), torch.full_like(best_i, -1), best_i)
            out_d.append(best_d)
            out_i.append(best_i)
        return torch.cat(out_d), torch.cat(out_i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def exact_dist(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 between q[i] and rows[i, j] by differences in float64:
    q (n, d), rows (n, k, d) -> (n, k)."""
    diff = rows.double() - q.double()[:, None, :]
    return (diff * diff).sum(2)
