"""The single-pass fused kNN scan: the port against the JAX package.

``knowhere_tpu_torch.ops.fused_topk`` on the CPU runs the plain PyTorch
version of the CUDA kernel; the JAX side is ``pallas_knn`` with
``interpret=True`` (as tests/test_pallas.py runs it). The corpus and queries
are snapped to a 1/8 grid in [-8, 8], so every value is bf16-exact and every
dot and norm is exact in f32: the port's bf16 pass and the interpret-mode
f32 dot give the same bits, and ids and distances must be identical (equal
scores included: both give the smaller id). The CUDA kernel is held against
the same plain version on the GPU by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import knowhere_tpu_torch as ktt
from knowhere_tpu.ops.pallas_topk import fused_knn_scan as jfused_knn_scan
from knowhere_tpu.ops.pallas_topk import pallas_knn
from knowhere_tpu_torch.ops import fused_topk

torch.set_num_threads(2)
ktt.set_device("cpu")


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xb = _grid(rng.standard_normal((4096 + 100, 64)))  # ragged against both packages' tiles
    xq = _grid(rng.standard_normal((10, 64)))
    return xb, xq


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("k", [10, 64])
def test_fused_knn_matches_pallas_knn(data, metric, k):
    xb, xq = data
    d_j, i_j = pallas_knn(xq, jax.device_put(xb), k, metric, tile=1024, interpret=True)
    d_t, i_t = fused_topk.fused_knn(xq, torch.from_numpy(xb), k, metric)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert i_t.dtype == np.int64


def test_k_larger_than_real_results(data):
    """k > nb: the empty slots are id -1 with distance inf, as in the reference."""
    xb, xq = data
    d_j, i_j = pallas_knn(xq[:2], jax.device_put(xb[:5]), 10, "L2", tile=1024, interpret=True)
    d_t, i_t = fused_topk.fused_knn(xq[:2], torch.from_numpy(xb[:5]), 10, "L2")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert (i_t[:, 5:] == -1).all() and np.isinf(d_t[:, 5:]).all()


@pytest.mark.parametrize("is_l2", [True, False])
def test_scan_matches_pallas_kernel(data, is_l2):
    """The kernel-level function on a padded corpus: (scores, ids) equal to
    the Pallas kernel's, pad rows (norm 1e38) never winning."""
    xb, xq = data
    nb_pad = -(-len(xb) // 1024) * 1024
    base = np.zeros((nb_pad, xb.shape[1]), np.float32)
    base[: len(xb)] = xb
    norms = np.full(nb_pad, 1e38, np.float32)
    norms[: len(xb)] = (xb.astype(np.float64) ** 2).sum(1) if is_l2 else 0.0
    q = np.concatenate([xq, np.zeros((6, xq.shape[1]), np.float32)])  # 16 rows
    s_j, i_j = jfused_knn_scan(jnp.asarray(q), jnp.asarray(base), jnp.asarray(norms), k=16, is_l2=is_l2,
                               tile=1024, interpret=True)
    s_t, i_t = fused_topk.fused_knn_scan(torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(norms),
                                         k=16, is_l2=is_l2)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_pad_base_rows_never_win(data):
    xb, xq = data
    b = torch.from_numpy(xb[:70])
    base, norms = fused_topk.pad_base(b, (b * b).sum(1))
    assert base.shape == (128, 64) and (norms[70:] == 1e38).all()
    _, ids = fused_topk.fused_knn_scan(torch.from_numpy(xq), base, norms, k=80, is_l2=True)
    assert ((ids[:, :70] >= 0) & (ids[:, :70] < 70)).all() and (ids[:, 70:] == -1).all()
