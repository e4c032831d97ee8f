"""The int8 task scan's plain version against the JAX kernel (interpret mode)
beyond tests/test_torch_kernels.py's kk=8, Qg=32, d=128 cases.

``ivf_cuda.int8_scan_tasks`` on CPU tensors runs its plain PyTorch version,
which chip_smoke.py holds the CUDA kernel to with every position equal. Here
the same numpy inputs go through ``pallas_int8_tasks(..., interpret=True)``
and the port: kk 16 and 32, query groups of 64 and 128, d=256 (two feature
chunks of the kernel), tasks with no valid rows, and a heavy-tie corpus
(codes and queries in {-1, 0, 1}, norms and scales from a few values) where
the leftmost-column rule decides most slots. The dots are exact in both, so
scores agree to 1e-6 relative and positions exactly (see _pow2_scales).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu_torch as ktt
from knowhere_tpu.ops.ivf_pallas import LIST_ALIGN, pallas_int8_tasks
from knowhere_tpu_torch.ops import ivf_cuda

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
B = LIST_ALIGN


def _geometry(rng, n_blocks, n_tasks):
    """Tasks over n_blocks blocks: one full, one empty, the rest ragged."""
    blk = rng.integers(0, n_blocks, n_tasks).astype(np.int32)
    nrows = rng.integers(1, B + 1, n_tasks).astype(np.int32)
    nrows[0], nrows[1] = B, 0
    return blk, nrows


def _both(blk, nrows, zi, sz, codes, nrm, keep, kk, is_l2):
    """(JAX interpret scores, positions), (port scores, positions)."""
    n_blocks = codes.shape[0] // B
    s_j, p_j = pallas_int8_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(zi), jnp.asarray(sz), jnp.asarray(codes),
        jnp.asarray(nrm.reshape(n_blocks, 1, B)),
        None if keep is None else jnp.asarray(keep.astype(np.int32).reshape(n_blocks, 1, B)),
        B=B, Qg=zi.shape[1], kk=kk, is_l2=is_l2, interpret=True,
    )
    s_t, p_t = ivf_cuda.int8_scan_tasks(
        T(blk), T(nrows), T(zi), T(sz), T(codes), T(nrm), None if keep is None else T(keep),
        B=B, kk=kk, is_l2=is_l2,
    )
    return (np.asarray(s_j), np.asarray(p_j)), (s_t.numpy(), p_t.numpy())


def _pow2_scales(rng, shape):
    """Query scales 2**-7 .. 2**-10. XLA on the CPU contracts the interpret
    kernel's 2*sz*dot - nrm into one FMA, where the TPU kernel, the port's
    plain version and its CUDA kernel round the product first; with these
    scales the product is exact, so the two orders give the same bits."""
    return (2.0 ** -rng.integers(7, 11, shape)).astype(np.float32)


def _assert_same(jax_out, port_out, nrows):
    (s_j, p_j), (s_t, p_t) = jax_out, port_out
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
    np.testing.assert_array_equal(p_t, p_j)
    empty = nrows == 0
    assert (p_t[empty] == -1).all() and (s_t[empty] <= -1e37).all()


# (kk, Qg, d, is_l2, masked, u8 codes)
SHAPES = [
    (16, 64, 128, True, False, False),
    (32, 128, 128, True, True, False),
    (32, 64, 128, False, True, True),
    (16, 128, 256, True, True, True),
    (32, 64, 256, False, False, False),
]


@pytest.mark.parametrize("kk,Qg,d,is_l2,masked,u8", SHAPES)
def test_int8_scan_shapes_match_jax(kk, Qg, d, is_l2, masked, u8):
    rng = np.random.default_rng(kk * 1000 + Qg + d)
    n_blocks, n_tasks = 3, 6
    nb = n_blocks * B
    codes = rng.integers(0, 256, (nb, d)).astype(np.uint8)
    if not u8:
        codes = rng.integers(-127, 128, (nb, d)).astype(np.int8)
    nrm = rng.uniform(0, 100, nb).astype(np.float32)
    zi = rng.integers(-127, 128, (n_tasks, Qg, d)).astype(np.int8)
    sz = _pow2_scales(rng, (n_tasks, Qg, 1))
    blk, nrows = _geometry(rng, n_blocks, n_tasks)
    keep = rng.random(nb) < 0.5 if masked else None
    _assert_same(*_both(blk, nrows, zi, sz, codes, nrm, keep, kk, is_l2), nrows)


def _ties(rng, n_blocks, n_tasks, Qg, d, u8):
    """Codes and queries in {-1, 0, 1} (u8 codes 127..129, recentred to the
    same i8 values), norms the count of non-zero codes, scales in {1/4, 1/2,
    3/4}: every score is an exact small multiple of 1/4."""
    c = rng.integers(-1, 2, (n_blocks * B, d)).astype(np.int8)
    nrm = (c != 0).sum(1).astype(np.float32)
    codes = (c.view(np.uint8) ^ 0x80) if u8 else c
    zi = rng.integers(-1, 2, (n_tasks, Qg, d)).astype(np.int8)
    sz = (rng.integers(1, 4, (n_tasks, Qg, 1)) * 0.25).astype(np.float32)
    return codes, nrm, zi, sz


@pytest.mark.parametrize("is_l2", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("u8", [False, True])
def test_int8_scan_heavy_ties_match_jax(u8, masked, is_l2):
    rng = np.random.default_rng(7 + 4 * u8 + 2 * masked + is_l2)
    n_blocks, n_tasks, Qg, d = 3, 6, 64, 128
    kk = 32 if masked else 16
    codes, nrm, zi, sz = _ties(rng, n_blocks, n_tasks, Qg, d, u8)
    blk, nrows = _geometry(rng, n_blocks, n_tasks)
    keep = rng.random(n_blocks * B) < 0.5 if masked else None
    jax_out, port_out = _both(blk, nrows, zi, sz, codes, nrm, keep, kk, is_l2)
    _assert_same(jax_out, port_out, nrows)
    # the corpus ties: in most full rows the last two of the kk scores are equal
    s = port_out[0][nrows == B]
    assert (s[..., kk - 1] == s[..., kk - 2]).mean() > 0.5


def test_int8_scan_all_tasks_empty():
    """No task has a valid row: every slot is the empty sentinel, in both."""
    rng = np.random.default_rng(5)
    n_tasks, Qg, d, kk = 4, 32, 128, 16
    codes = rng.integers(-127, 128, (B, d)).astype(np.int8)
    nrm = rng.uniform(0, 10, B).astype(np.float32)
    zi = rng.integers(-127, 128, (n_tasks, Qg, d)).astype(np.int8)
    sz = _pow2_scales(rng, (n_tasks, Qg, 1))
    blk = np.zeros(n_tasks, np.int32)
    nrows = np.zeros(n_tasks, np.int32)
    jax_out, port_out = _both(blk, nrows, zi, sz, codes, nrm, None, kk, True)
    _assert_same(jax_out, port_out, nrows)
    assert (port_out[1] == -1).all()
