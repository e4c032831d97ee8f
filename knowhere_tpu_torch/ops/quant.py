"""Product quantizer in PyTorch (counterpart of knowhere_tpu/ops/quant.py, PQ
part): per-subspace codebooks trained on IVF residuals (faiss
by_residual=true), nearest-codeword encode, decode, and OPQ.

The host RNG is numpy ``default_rng(seed)`` drawn in the reference's order,
so the training subsample and the initial codebooks are the reference's;
Lloyd runs on the port's device in full f32 with the same first-index argmin,
so codebooks match the JAX ones up to the order of f32 sums. OPQ solves its
Procrustes step with the same numpy SVD on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import to_device


@dataclass
class PQCodec:
    codebooks: np.ndarray  # (m, ksub, sub_dim) f32
    m: int
    nbits: int

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.codebooks.shape[2]


def _pq_lloyd_batched(xs: torch.Tensor, c0: torch.Tensor, *, ksub: int, n_iters: int, nc: int) -> torch.Tensor:
    """All m subspaces' Lloyd iterations at once: xs (m, n, s), c0 (m, ksub, s)
    -> codebooks (m, ksub, s). Each iteration assigns the rows in chunks of
    nc (a batched (m, nc, s) x (m, ksub, s) product), sums them per codeword
    and keeps a codeword that got no row."""
    m, n, s = xs.shape
    c = c0.float()
    off = (torch.arange(m, device=xs.device) * ksub)[:, None]
    for _ in range(n_iters):
        c_sq = (c * c).sum(2)  # (m, ksub)
        sums = torch.zeros((m * ksub, s), dtype=torch.float32, device=xs.device)
        counts = torch.zeros(m * ksub, dtype=torch.float32, device=xs.device)
        for i0 in range(0, n, nc):
            xc = xs[:, i0 : i0 + nc].float()
            dots = torch.bmm(xc, c.transpose(1, 2))  # (m, nc, ksub)
            # torch.argmin returns the first of equal minima, as jnp.argmin
            a = (torch.argmin(c_sq[:, None, :] - 2.0 * dots, 2) + off).reshape(-1)
            sums.index_add_(0, a, xc.reshape(-1, s))
            counts += torch.bincount(a, minlength=m * ksub).float()
        sums, counts = sums.view(m, ksub, s), counts.view(m, ksub)
        new_c = sums / torch.clamp(counts, min=1.0)[..., None]
        c = torch.where((counts == 0)[..., None], c, new_c)
    return c


def pq_train(
    x: np.ndarray,
    m: int,
    nbits: int,
    seed: int = 1234,
    n_iters: int = 12,
    max_points_per_centroid: int = 256,
) -> PQCodec:
    """Train per-subspace codebooks with k-means (faiss
    ProductQuantizer::train), on ksub * max_points_per_centroid shared rows."""
    n, d = x.shape
    assert d % m == 0, f"dim {d} not divisible by m {m}"
    sub_dim = d // m
    ksub = 1 << nbits
    rng = np.random.default_rng(seed)
    cap = ksub * max_points_per_centroid
    xt = x[rng.choice(n, size=cap, replace=False)] if n > cap else x
    nt = xt.shape[0]
    xs = np.ascontiguousarray(xt.reshape(nt, m, sub_dim).transpose(1, 0, 2), dtype=np.float32)
    if nt >= ksub:
        init = rng.choice(nt, size=ksub, replace=False)
        c0 = xs[:, init, :]
    else:  # tiny corpora: repeat rows to fill the codebook
        init = rng.choice(nt, size=ksub, replace=True)
        c0 = xs[:, init, :] + rng.standard_normal((m, ksub, sub_dim)).astype(np.float32) * 1e-4
    books = _pq_lloyd_batched(to_device(xs), to_device(c0), ksub=ksub, n_iters=n_iters, nc=2048)
    return PQCodec(books.cpu().numpy(), m, nbits)


def pq_encode(codec: PQCodec, x: np.ndarray, chunk: int = 131072) -> np.ndarray:
    """(n, d) -> (n, m) uint8 codes: the nearest codeword per subspace."""
    n = x.shape[0]
    m, sub_dim = codec.m, codec.sub_dim
    books = to_device(np.asarray(codec.codebooks, np.float32))  # (m, ksub, s)
    c_sq = (books * books).sum(2)  # (m, ksub)
    out = np.empty((n, m), dtype=np.uint8)
    for s0 in range(0, n, chunk):
        xs = to_device(np.asarray(x[s0 : s0 + chunk], np.float32)).reshape(-1, m, sub_dim)
        dots = torch.einsum("nms,mks->nmk", xs, books)
        out[s0 : s0 + chunk] = torch.argmin(c_sq[None] - 2.0 * dots, 2).to(torch.uint8).cpu().numpy()
    return out


def pq_decode(codec: PQCodec, codes: np.ndarray) -> np.ndarray:
    """(n, m) codes -> (n, m * sub_dim) f32 codewords, on the host."""
    m, ksub = codec.m, codec.ksub
    flat = np.asarray(codec.codebooks, np.float32).reshape(m * ksub, codec.sub_dim)
    idx = np.asarray(codes).astype(np.int64) + (np.arange(m) * ksub)[None, :]
    return flat[idx].reshape(len(codes), m * codec.sub_dim)


def opq_train(
    x: np.ndarray,
    m: int,
    nbits: int,
    seed: int = 1234,
    n_iter: int = 6,
    sample: int = 131072,
) -> Tuple[np.ndarray, PQCodec]:
    """OPQ (OPQ-NP, Ge et al.): alternate PQ training on x @ R.T with the
    orthogonal Procrustes solution min_R ||x R^T - decode(encode(x R^T))||
    on a subsample, then train the final codebooks on the fully rotated
    rows. Returns (R (d, d) f32, PQCodec trained on x @ R.T)."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    xs = x[rng.choice(n, size=sample, replace=False)] if n > sample else x
    xs = np.ascontiguousarray(xs, dtype=np.float32)
    R = np.eye(d, dtype=np.float32)
    for _ in range(n_iter):
        xr = xs @ R.T
        codec = pq_train(xr, m, nbits, seed=seed, n_iters=6)
        dec = pq_decode(codec, pq_encode(codec, xr))
        u, _, vt = np.linalg.svd(xs.T @ dec)
        R = (u @ vt).T.astype(np.float32)
    return R, pq_train(x @ R.T, m, nbits, seed=seed)
