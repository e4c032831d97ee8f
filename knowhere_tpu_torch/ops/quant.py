"""Quantizers in PyTorch (counterpart of knowhere_tpu/ops/quant.py): the
product quantizer (per-subspace codebooks trained on IVF residuals, faiss
by_residual=true, nearest-codeword encode, decode, and OPQ), the scalar
quantizers (SQ8/SQ6/SQ4 affine grids, FP16/BF16 rows) and RaBitQ (1-bit
signs of the rotated residual plus two per-row corrections).

The host RNG is numpy ``default_rng(seed)`` drawn in the reference's order,
so the training subsample and the initial codebooks are the reference's;
Lloyd runs on the port's device in full f32 with the same first-index argmin,
so codebooks match the JAX ones up to the order of f32 sums. OPQ solves its
Procrustes step with the same numpy SVD on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from .kmeans import cluster_sums


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
    of each subspace in row order (kmeans.cluster_sums over the m * ksub
    codewords: the same bits from run to run on the card too), and keeps a
    codeword that got no row."""
    m, n, s = xs.shape
    c = c0.float()
    off = (torch.arange(m, device=xs.device) * ksub)[:, None]
    rows = xs.reshape(m * n, s)
    for _ in range(n_iters):
        c_sq = (c * c).sum(2)  # (m, ksub)
        # torch.argmin returns the first of equal minima, as jnp.argmin
        a = torch.cat([torch.argmin(c_sq[:, None, :] - 2.0 * torch.bmm(xs[:, i0 : i0 + nc].float(), c.transpose(1, 2)), 2)
                       for i0 in range(0, n, nc)], 1)  # (m, n)
        key = (a + off).reshape(-1)
        sums = cluster_sums(rows, key, m * ksub).view(m, ksub, s)
        counts = torch.bincount(key, minlength=m * ksub).float().view(m, ksub)
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


# ---------------------------------------------------------------------------
# Scalar quantizers (host numpy, byte-identical to the reference's codes)
# ---------------------------------------------------------------------------


@dataclass
class SQCodec:
    sq_type: str  # SQ8 | SQ6 | SQ4 | FP16 | BF16
    vmin: Optional[np.ndarray] = None  # (d,) f32
    vdiff: Optional[np.ndarray] = None  # (d,) f32
    dim: int = 0

    @property
    def levels(self) -> int:
        return {"SQ8": 256, "SQ6": 64, "SQ4": 16}[self.sq_type]


def sq_train(x: np.ndarray, sq_type: str) -> SQCodec:
    """Per-dim vmin / vdiff over the rows (FP16/BF16 store rows directly)."""
    sq_type = sq_type.upper()
    d = x.shape[1]
    if sq_type in ("FP16", "BF16"):
        return SQCodec(sq_type, dim=d)
    vmin = x.min(axis=0).astype(np.float32)
    vmax = x.max(axis=0).astype(np.float32)
    vdiff = np.maximum(vmax - vmin, 1e-20).astype(np.float32)
    return SQCodec(sq_type, vmin, vdiff, dim=d)


def sq_encode(codec: SQCodec, x: np.ndarray) -> np.ndarray:
    """(n, d) rows -> codes: uint8 floor((x - vmin) / vdiff * levels) clipped
    to the grid (SQ4 packs two codes a byte, low nibble first), or the rows
    as float16 / bfloat16."""
    t = codec.sq_type
    if t == "FP16":
        return x.astype(np.float16)
    if t == "BF16":
        import ml_dtypes  # the reference's host bf16 type

        return x.astype(ml_dtypes.bfloat16)
    levels = codec.levels
    q = np.clip(
        np.floor((x - codec.vmin[None, :]) / codec.vdiff[None, :] * levels), 0, levels - 1
    ).astype(np.uint8)
    if t == "SQ4":
        if q.shape[1] % 2:
            q = np.concatenate([q, np.zeros((q.shape[0], 1), np.uint8)], axis=1)
        return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)
    return q


def unpack_sq4(codes: torch.Tensor, d: int) -> torch.Tensor:
    """(..., ceil(d/2)) packed SQ4 bytes -> (..., d) codes as f32."""
    lo, hi = (codes & 0xF).float(), (codes >> 4).float()
    return torch.stack([lo, hi], dim=-1).reshape(*codes.shape[:-1], -1)[..., :d]


def sq_decode(codes: torch.Tensor, vmin: Optional[torch.Tensor], vdiff: Optional[torch.Tensor],
              levels: int, packed4: bool = False, d: int = 0) -> torch.Tensor:
    """Codes -> f32 rows, vmin + (code + 0.5) / levels * vdiff (faiss's bin
    centres); levels=0 means FP16/BF16 rows, which only widen."""
    if levels <= 0:
        return codes.float()
    c = unpack_sq4(codes, d) if packed4 else codes.float()
    return vmin + (c + 0.5) / levels * vdiff


# ---------------------------------------------------------------------------
# RaBitQ (1-bit binary quantization of the rotated residual + corrections)
# ---------------------------------------------------------------------------


@dataclass
class RaBitQCodec:
    rotation: np.ndarray  # (d, d) orthonormal
    dim: int


def rabitq_make(dim: int, seed: int = 1234) -> RaBitQCodec:
    """The random orthonormal rotation: numpy QR of a seeded gaussian, as the
    reference draws it (bit-identical rotation)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)).astype(np.float64)
    q, _ = np.linalg.qr(a)
    return RaBitQCodec(q.astype(np.float32), dim)


def rabitq_encode(
    codec: RaBitQCodec, x: np.ndarray, centroids: np.ndarray, assign: np.ndarray, chunk: int = 131072
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (bits_packed (n, ceil(d/8)) uint8, r_norm (n,) f32, t (n,) f32):
    the signs of the rotated residual rr = (x - c) @ P^T packed little-endian
    (bit set where rr >= 0), |rr|, and t = <rr, sign(rr)> / (|rr| sqrt(d)),
    the RaBitQ correction (d the true dim). Computed on the port's device."""
    n, d = x.shape
    P = to_device(np.asarray(codec.rotation, np.float32))
    bits = np.empty((n, d), dtype=bool)
    r_norm = np.empty(n, dtype=np.float32)
    t_out = np.empty(n, dtype=np.float32)
    for s0 in range(0, n, chunk):
        e = min(s0 + chunk, n)
        xc = to_device(np.asarray(x[s0:e], np.float32))
        cc = to_device(np.asarray(centroids[assign[s0:e]], np.float32))
        rr = (xc - cc) @ P.T
        norm = torch.linalg.norm(rr, dim=1)
        s = torch.where(rr >= 0, 1.0, -1.0)
        t = (rr * s).sum(1) / (torch.clamp(norm, min=1e-20) * np.sqrt(d))
        bits[s0:e] = (rr >= 0).cpu().numpy()
        r_norm[s0:e] = norm.cpu().numpy()
        t_out[s0:e] = t.cpu().numpy()
    return np.packbits(bits, axis=1, bitorder="little"), r_norm, t_out


def rabitq_estimate(
    q_rot_res: torch.Tensor,  # (nq, d) rotated query residual P(q - c_list)
    sign_planes: torch.Tensor,  # (nb, d) +/-1
    r_norm: torch.Tensor,  # (nb,)
    t: torch.Tensor,  # (nb,)
    q_res_norm_sqr: torch.Tensor,  # (nq,) |q - c|^2
) -> torch.Tensor:
    """Estimated squared L2 distance (the RaBitQ estimator, plain f32):
    |q-c|^2 + |r|^2 - 2 |r| <q_rot_res, s> / (sqrt(d) t)."""
    d = q_rot_res.shape[1]
    dots = q_rot_res.float() @ sign_planes.float().T
    ip_est = r_norm[None, :] * dots / (torch.clamp(t, min=1e-6)[None, :] * np.sqrt(d))
    return q_res_norm_sqr[:, None] + (r_norm**2)[None, :] - 2.0 * ip_est
