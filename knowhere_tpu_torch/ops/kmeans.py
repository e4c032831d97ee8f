"""k-means (Lloyd) in PyTorch — the IVF coarse-quantizer trainer
(counterpart of knowhere_tpu/ops/kmeans.py).

Random-sample init, Lloyd iterations with empty-cluster reseeding and
training-set subsampling (max_points_per_centroid, faiss default 256). The
host RNG is numpy seeded with ``seed=1234`` as in the reference, so the
subsample and the initial centroids match it; assignments are exact argmin
over full-f32 products. The Lloyd sums add each cluster's rows in row
order on every device (see :func:`cluster_sums`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import to_device

ASSIGN_CHUNK = 131072
# f32 scores of one assignment block of the device Lloyd step: a block's
# (rows, k) scores, their compare and index temporaries stay near 5x this
ASSIGN_BLOCK_BYTES = 1 << 31


def _assign_block(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_c |x - c|^2 for one block — one matmul + argmin (first index
    on ties, as jnp.argmin)."""
    c = centroids.float()
    dot = x.float() @ c.T
    c_sq = (c * c).sum(1)
    score = c_sq[None, :] - 2.0 * dot
    # torch.argmin does not promise the first index on ties; take the
    # smallest index among the minima explicitly
    m = score.min(dim=1, keepdim=True).values
    idx = torch.arange(c.shape[0], device=x.device).expand_as(score)
    return torch.where(score == m, idx, c.shape[0]).min(dim=1).values.int()


def assign_device(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """_assign_block over blocks of rows whose (rows, k) f32 scores stay under
    ASSIGN_BLOCK_BYTES (one block when they fit): at k = 4096 a training set
    of 1M rows would otherwise hold 16 GB of scores and 32 GB of indices at
    once. A row's assignment does not depend on its block."""
    step = max(1, ASSIGN_BLOCK_BYTES // (4 * centroids.shape[0]))
    if x.shape[0] <= step:
        return _assign_block(x, centroids)
    return torch.cat([_assign_block(x[s : s + step], centroids) for s in range(0, x.shape[0], step)])


def cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) f32 sums of the rows of x (n, d) by cluster (assign (n,) in
    [0, k)): the rows in a stable sort by cluster, then each cluster's run
    added in row order (segment_reduce). That order is fixed, so the same
    inputs give the same bits from run to run on the card too, where
    index_add_ adds by atomics in no fixed order; on the CPU it is
    index_add_'s own order. O(n d) whatever k. The reference sums with
    jax.ops.segment_sum (knowhere_tpu/ops/kmeans.py)."""
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign, minlength=k)
    return torch.segment_reduce(x[order].float(), "sum", lengths=counts, unsafe=True)


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, *, k: int):
    """One Lloyd iteration: returns (new_centroids, counts)."""
    assign = assign_device(x, centroids).long()
    sums = cluster_sums(x, assign, k)
    counts = torch.bincount(assign, minlength=k).float()
    new_c = sums / torch.clamp(counts, min=1.0)[:, None]
    new_c = torch.where((counts == 0)[:, None], centroids.float(), new_c)
    return new_c, counts


def kmeans(
    x: np.ndarray,
    k: int,
    n_iters: int = 12,
    seed: int = 1234,
    max_points_per_centroid: int = 256,
    chunk: int = ASSIGN_CHUNK,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full k-means: returns (centroids (k,d) f32, assignments (n,) i32)."""
    x = np.asarray(x)
    n, d = x.shape
    if k <= 0:
        raise ValueError("k must be positive")
    rng = np.random.default_rng(seed)

    cap = k * max_points_per_centroid
    if n > cap:
        train_idx = rng.choice(n, size=cap, replace=False)
        x_train = np.ascontiguousarray(x[train_idx], dtype=np.float32)
    else:
        x_train = np.asarray(x, dtype=np.float32)

    if x_train.shape[0] >= k:
        init_idx = rng.choice(x_train.shape[0], size=k, replace=False)
    else:
        init_idx = rng.choice(x_train.shape[0], size=k, replace=True)
    cents = to_device(np.asarray(x_train[init_idx], dtype=np.float32))
    x_dev = to_device(x_train)

    for _ in range(n_iters):
        cents, counts = _lloyd_step(x_dev, cents, k=k)
        empty = (counts == 0).cpu().numpy()
        if empty.any():
            # reseed dead centroids from random training points
            fresh = x_train[rng.integers(0, x_train.shape[0], int(empty.sum()))]
            cents[torch.from_numpy(np.nonzero(empty)[0]).to(cents.device)] = to_device(fresh)

    centroids_np = cents.cpu().numpy().astype(np.float32)
    assign_all = assign_rows(x, centroids_np, chunk=chunk)
    return centroids_np, assign_all


def assign_rows(x: np.ndarray, centroids: np.ndarray, chunk: int = ASSIGN_CHUNK) -> np.ndarray:
    """Assign every row of (host) x to its nearest centroid."""
    x = np.asarray(x)
    n = x.shape[0]
    c_dev = to_device(np.asarray(centroids, dtype=np.float32))
    out = np.empty(n, dtype=np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        block = to_device(np.asarray(x[s:e], dtype=np.float32))
        out[s:e] = _assign_block(block, c_dev).cpu().numpy()
    return out
