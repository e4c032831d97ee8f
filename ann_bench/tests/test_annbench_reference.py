"""The plain reference against a NumPy brute force, and its lower precision."""

import numpy as np
import pytest
import torch

from ann_bench import data, reference


def numpy_knn(q, b, k, keep=None):
    d = ((q[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(2)
    if keep is not None:
        d[:, ~keep] = np.inf
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("keep_share", [None, 0.9])
@pytest.mark.parametrize("tiles", [(1024, 1 << 18), (7, 50)])  # one tile; many, not dividing the sizes
def test_knn_equals_numpy(keep_share, tiles):
    rng = np.random.default_rng(3)
    b = rng.standard_normal((1000, 24)).astype(np.float32)
    q = rng.standard_normal((37, 24)).astype(np.float32)
    keep = None if keep_share is None else data.keep_mask(1000, {"drop_id_below_share": keep_share})
    d, i = reference.knn(torch.from_numpy(q), torch.from_numpy(b), 10,
                         None if keep is None else torch.from_numpy(keep), q_tile=tiles[0], b_tile=tiles[1])
    nd, ni = numpy_knn(q, b, 10, keep)
    assert np.array_equal(i.numpy(), ni)
    np.testing.assert_allclose(d.numpy(), nd, rtol=1e-5, atol=1e-4)


def test_knn_pads_past_the_kept_rows():
    b = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    keep = torch.zeros(10, dtype=torch.bool)
    keep[[2, 7]] = True
    d, i = reference.knn(b[:1], b, 4, keep)
    assert i.tolist() == [[2, 7, -1, -1]] and torch.isinf(d[0, 2:]).all()


def test_exact_dist_by_differences():
    q = torch.tensor([[1.0, 2.0]])
    rows = torch.tensor([[[1.0, 2.0], [4.0, 6.0]]])
    assert reference.exact_dist(q, rows).tolist() == [[0.0, 25.0]]


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12])
    # 10 mantissa bits: 1 + 2^-10 stays; 1 + 2^-11 is a tie to even (1); 1 + 3 * 2^-11 rounds up; 2^-12 drops
    assert reference.round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, 1.0]


def test_lower_precision_moves_the_distances():
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.standard_normal((500, 32)).astype(np.float32) * 3)
    q = torch.from_numpy(rng.standard_normal((20, 32)).astype(np.float32) * 3)
    d, i = reference.knn(q, b, 5, precision="tf32")
    exact = reference.exact_dist(q, b[i])
    err = float(((d.double() - exact).abs() / exact).max())
    d32, i32 = reference.knn(q, b, 5)
    err32 = float(((d32.double() - reference.exact_dist(q, b[i32])).abs() / reference.exact_dist(q, b[i32])).max())
    assert err > 10 * err32


def test_mixture_is_gen_corpus_at_seed_0():
    """The corpus is bench.py's gen_corpus at the configuration's seed, drawn in its order."""
    corpus = {"dim": 16, "n_clusters": 5, "intrinsic_dim": 4, "center_scale": [0.9, 1.6], "seed": 0}
    xb, pool = data.mixture(corpus, 50, 8, seed=12)
    rng = np.random.default_rng(0)
    scales = rng.uniform(0.9, 1.6, size=5).astype(np.float32)
    centers = rng.standard_normal((5, 16)).astype(np.float32) * scales[:, None]
    w = rng.standard_normal((4, 16)).astype(np.float32)
    w *= np.sqrt(16 / 4) / np.sqrt(4)
    want = centers[rng.integers(0, 5, size=50)] + rng.standard_normal((50, 4)).astype(np.float32) @ w
    assert np.array_equal(xb, want)
    xb2, pool2 = data.mixture(corpus, 50, 8, seed=12)
    assert np.array_equal(pool, pool2) and not np.array_equal(pool, data.mixture(corpus, 50, 8, seed=13)[1])


def test_request_order_never_repeats_in_a_row():
    for seed in (0, 2**31 + 7, 3 * 10**9):
        order = data.request_order(8, seed)
        blocks = [order[i % 8] for i in range(40)]
        assert sorted(order) == list(range(8)) and all(a != b for a, b in zip(blocks, blocks[1:]))
