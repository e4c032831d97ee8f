"""The corpus, the query pool and the filter of a run.

The mixture is a copy of `bench.py:516-543`'s `gen_corpus` (also
`chip_smoke.gen_corpus`): a SIFT-like gaussian mixture of low intrinsic
dimension. Each cluster draws its center scale from U(center_scale); a row
is its cluster's center plus intrinsic noise lifted by a fixed (intrinsic x
dim) map. Queries are fresh draws from the same mixture, never perturbed
corpus rows.

The corpus is the configuration's data set, as SIFT1M is one file: it is
drawn with the configuration's `corpus.seed` (0, `bench.py`'s), in
`gen_corpus`'s order, so it is the corpus every `chip_smoke.py` number was
measured on. The run's seed draws the query pool from the same mixture and
the order in which requests cycle through it. A corpus drawn from the run's
seed would change the index the build makes, and with it the recall and the
work of every request (PERF.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _shape(corpus: dict, rng: np.random.Generator):
    """(centers (n_clusters, dim), lift (intrinsic, dim)), drawn as gen_corpus draws them."""
    dim, n_clusters, intrinsic = int(corpus["dim"]), int(corpus["n_clusters"]), int(corpus["intrinsic_dim"])
    scales = rng.uniform(*corpus["center_scale"], size=n_clusters).astype(np.float32)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * scales[:, None]
    w = rng.standard_normal((intrinsic, dim)).astype(np.float32)
    w *= np.sqrt(dim / intrinsic) / np.sqrt(intrinsic)
    return centers, w


def _draw(rng: np.random.Generator, centers: np.ndarray, w: np.ndarray, n: int) -> np.ndarray:
    labels = rng.integers(0, len(centers), size=n)
    return centers[labels] + rng.standard_normal((n, w.shape[0])).astype(np.float32) @ w


def mixture(corpus: dict, nb: int, n_pool: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(corpus rows (nb, dim), query pool (n_pool, dim)), f32: the corpus from
    the configuration's data seed, the pool from the run's seed."""
    rng = np.random.default_rng(int(corpus["seed"]))
    centers, w = _shape(corpus, rng)
    xb = _draw(rng, centers, w, nb)
    pool = _draw(np.random.default_rng(int(seed) % (1 << 63)), centers, w, n_pool)
    return xb, pool


def keep_mask(nb: int, spec: Optional[dict]) -> Optional[np.ndarray]:
    """The rows a request may return (True = kept), or None without a filter.
    `{"drop_id_below_share": s}` filters out every id below round(s * nb),
    VectorDBBench's `id >= x` filter."""
    if not spec:
        return None
    cut = int(round(float(spec["drop_id_below_share"]) * nb))
    keep = np.ones(nb, dtype=bool)
    keep[:cut] = False
    return keep


def request_order(n_blocks: int, seed: int) -> np.ndarray:
    """The pool blocks in the order requests cycle through them: a seeded
    permutation, so no two requests in a row carry the same queries."""
    return np.random.default_rng(int(seed) % (1 << 63) + 1).permutation(n_blocks)
