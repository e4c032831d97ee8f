"""Port kernels' plain PyTorch versions vs the JAX kernels (interpret mode).

Each CUDA kernel of knowhere_tpu_torch has a plain PyTorch version beside it;
on CPU tensors the kernel wrapper runs that version. Here the same numpy
inputs go through the JAX Pallas kernel (interpret=True) and through the
port's wrapper on the CPU, and the results are held to the stated
tolerances. The kernels themselves are held against these plain versions on
the GPU by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import ivf_scan as jscan
from knowhere_tpu.ops.ivf_pallas import LIST_ALIGN, pallas_int8_tasks, pallas_scan_tasks
from knowhere_tpu.ops.pallas_flat import FlatScanStore as JFlatScanStore
from knowhere_tpu.ops.pallas_flat import GROUP
from knowhere_tpu.ops.pallas_flat import flat_topk as jflat_topk
from knowhere_tpu_torch.ops import cuda_flat, ivf_cuda
from knowhere_tpu_torch.ops import ivf_scan as tscan

from .torch_parity import assert_same_topk

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy


def _quantize(x, is_l2):
    mu = x.mean(0).astype(np.float32) if is_l2 else np.zeros(x.shape[1], np.float32)
    xc = x - mu
    s = np.maximum(np.abs(xc).max(0) / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.rint(xc / s), -127, 127).astype(np.int8)
    nrm = np.sum(xc.astype(np.float64) ** 2, 1).astype(np.float32)
    return mu, s, codes, nrm


def _tasks(rng, n_blocks, Qg, nq):
    """Task geometry with ragged blocks: some tasks see fewer valid rows."""
    Tc = 2 * n_blocks
    blk = np.tile(np.arange(n_blocks, dtype=np.int32), 2)
    nrows = rng.integers(LIST_ALIGN // 2, LIST_ALIGN + 1, Tc).astype(np.int32)
    nrows[0] = LIST_ALIGN
    qids = rng.integers(0, nq, (Tc, Qg)).astype(np.int32)
    return blk, nrows, qids


@pytest.mark.parametrize("is_l2", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_scan_matches_jax(is_l2, masked):
    rng = np.random.default_rng(0)
    d, B, nlist, Qg, kk, nq = 128, LIST_ALIGN, 4, 32, 8, 48
    nb = nlist * B
    x = rng.standard_normal((nb, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mu, s, codes, nrm = _quantize(x, is_l2)
    zi, sz = jscan.quantize_queries_int8(jnp.asarray(q), jnp.asarray(mu), jnp.asarray(s))
    zi, sz = np.asarray(zi), np.asarray(sz)
    blk, nrows, qids = _tasks(rng, nlist, Qg, nq)
    keep = rng.random(nb) < 0.5 if masked else None

    s_j, p_j = pallas_int8_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(zi[qids]), jnp.asarray(sz[qids][..., None]),
        jnp.asarray(codes), jnp.asarray(nrm.reshape(nb // B, 1, B)),
        None if keep is None else jnp.asarray(keep.astype(np.int32).reshape(nb // B, 1, B)),
        B=B, Qg=Qg, kk=kk, is_l2=is_l2, interpret=True,
    )
    s_t, p_t = ivf_cuda.int8_scan_tasks(
        T(blk), T(nrows), T(zi[qids]), T(sz[qids][..., None]), T(codes), T(nrm),
        None if keep is None else T(keep), B=B, kk=kk, is_l2=is_l2,
    )
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_int8_scan_u8_codes_matches_jax():
    rng = np.random.default_rng(9)
    d, B, Qg, kk = 128, LIST_ALIGN, 32, 8
    nb = 2 * B
    codes_u8 = rng.integers(0, 256, (nb, d)).astype(np.uint8)
    nrm = rng.uniform(1, 2, nb).astype(np.float32)
    zi = rng.integers(-127, 128, (Qg, d)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, Qg).astype(np.float32)
    Tc = nb // B
    blk = np.arange(Tc, dtype=np.int32)
    nrows = np.full(Tc, B, np.int32)
    qt = np.broadcast_to(zi, (Tc, Qg, d)).copy()
    st = np.broadcast_to(sz[:, None], (Tc, Qg, 1)).copy()
    s_j, p_j = pallas_int8_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(qt), jnp.asarray(st),
        jnp.asarray(codes_u8), jnp.asarray(nrm.reshape(Tc, 1, B)),
        B=B, Qg=Qg, kk=kk, is_l2=True, interpret=True,
    )
    s_t, p_t = ivf_cuda.int8_scan_tasks(
        T(blk), T(nrows), T(qt), T(st), T(codes_u8), T(nrm), B=B, kk=kk, is_l2=True
    )
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("is_l2", [True, False])
def test_quantize_queries_int8_bit_equal(is_l2):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2048, 128)).astype(np.float32) * 3 + 1
    q = rng.standard_normal((64, 128)).astype(np.float32) * 3 + 1
    mu, s, _, _ = _quantize(x, is_l2)
    zi_j, sz_j = jscan.quantize_queries_int8(jnp.asarray(q), jnp.asarray(mu), jnp.asarray(s))
    zi_t, sz_t = tscan.quantize_queries_int8(T(q), T(mu), T(s))
    np.testing.assert_array_equal(zi_t.numpy(), np.asarray(zi_j))
    np.testing.assert_array_equal(sz_t.numpy().view(np.uint32), np.asarray(sz_j).view(np.uint32))


@pytest.mark.parametrize("three_pass", [True, False])
@pytest.mark.parametrize("is_l2", [True, False])
def test_f32_scan_matches_jax(three_pass, is_l2):
    rng = np.random.default_rng(1)
    d, B, nlist, Qg, kk, nq = 128, LIST_ALIGN, 3, 16, 32, 40
    nb = nlist * B
    x = rng.standard_normal((nb, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if not three_pass:
        # the interpret-mode CPU dot is full f32, not the TPU's bf16 pass:
        # bf16-exact inputs make the two arithmetics the same
        x = T(x).to(torch.bfloat16).float().numpy()
        q = T(q).to(torch.bfloat16).float().numpy()
    blk, nrows, qids = _tasks(rng, nlist, Qg, nq)
    keep = rng.random(nb) < 0.7
    s_j, p_j = pallas_scan_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(q[qids]), jnp.asarray(x),
        jnp.asarray(keep.astype(np.int32).reshape(nb // B, 1, B)),
        B=B, Qg=Qg, kk=kk, is_l2=is_l2, three_pass=three_pass, interpret=True,
    )
    s_t, p_t = ivf_cuda.f32_scan_tasks(
        T(blk), T(nrows), T(q[qids]), T(x), T(keep), B=B, kk=kk, is_l2=is_l2, three_pass=three_pass
    )
    # three passes: both sides sum the same exact bf16 products in f32, only
    # in other orders (measured: 4.9e-7 relative, 3.1e-5 absolute at |s| <=
    # 104); the single pass keeps the earlier tolerance
    rtol, atol = (1e-6, 1e-4) if three_pass else (1e-5, 1e-3)
    assert_same_topk(np.asarray(s_j), np.asarray(p_j), s_t.numpy(), p_t.numpy(), rtol, atol)


@pytest.mark.parametrize(
    "nb,nq,k,metric",
    [
        (6000, 37, 10, "L2"),
        (6000, 300, 100, "L2"),
        (4096, 8, 10, "IP"),
        (2048, 5, 150, "L2"),
        (2048 + GROUP + 3, 4, 33, "IP"),
    ],
)
def test_flat_topk_matches_jax(nb, nq, k, metric):
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((nb, 96), dtype=np.float32)
    xq = rng.standard_normal((nq, 96), dtype=np.float32)
    is_l2 = metric == "L2"
    _, ids_j = jflat_topk(xq, JFlatScanStore(jax.device_put(xb), None, is_l2), k, interpret=True)
    dists_t, ids_t = cuda_flat.flat_topk(xq, cuda_flat.FlatScanStore(T(xb), None, is_l2), k)
    for r in range(nq):
        assert set(ids_t[r].tolist()) == set(ids_j[r].tolist())
    assert ids_t.shape == (nq, k)


def test_hi_lo_residual_nonzero():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 32)).astype(np.float32))
    hi, lo = cuda_flat.hi_lo(x)
    assert (lo != 0).any()
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    # hi + lo is closer to x than hi alone
    assert (x - hi - lo).abs().max() < (x - hi).abs().max()


def _probes(rng, nq, nprobe, nlist):
    probes = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(nq)]).astype(np.int32)
    probes[-3:] = -1  # padded query rows
    return probes


@pytest.mark.parametrize("Qg", [32, 64])
def test_build_scan_tasks_torch_matches_jax(Qg):
    rng = np.random.default_rng(4)
    nlist, nq, nprobe, B = 24, 96, 6, LIST_ALIGN
    lens = rng.integers(0, 3 * B, nlist).astype(np.int64)
    lens[5] = 0  # an empty list
    offsets = np.concatenate([[0], np.cumsum((lens + B - 1) // B * B)]).astype(np.int32)
    probes = _probes(rng, nq, nprobe, nlist)
    T_max, G_max, _ = jscan.device_task_bounds(nq, nprobe, lens, B, Qg)
    kw = dict(B=B, Qg=Qg, T_max=T_max, G_max=G_max, nlist=nlist)
    out_j = jscan.build_scan_tasks_jax(
        jnp.asarray(probes), jnp.asarray(offsets), jnp.asarray(lens.astype(np.int32)), **kw
    )
    out_t = tscan.build_scan_tasks_torch(T(probes), T(offsets), T(lens.astype(np.int32)), **kw)
    for a_j, a_t in zip(out_j, out_t):
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_merge_tasks_matches_jax():
    rng = np.random.default_rng(5)
    nlist, nq, nprobe, B, Qg, kk, k = 16, 64, 5, LIST_ALIGN, 32, 8, 10
    lens = rng.integers(1, 2 * B, nlist).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum((lens + B - 1) // B * B)]).astype(np.int32)
    probes = _probes(rng, nq, nprobe, nlist)
    T_max, G_max, S_max = jscan.device_task_bounds(nq, nprobe, lens, B, Qg)
    rs, nr, li, qids, slots = (
        np.array(a)
        for a in jscan.build_scan_tasks_jax(
            jnp.asarray(probes), jnp.asarray(offsets), jnp.asarray(lens.astype(np.int32)),
            B=B, Qg=Qg, T_max=T_max, G_max=G_max, nlist=nlist,
        )
    )
    Tn = rs.shape[0]
    scores = rng.standard_normal((Tn, Qg, kk)).astype(np.float32)
    scores[:, :, -2:] = -1e38  # the kernels' empty-slot sentinel
    pos = rng.integers(0, int(offsets[-1]), (Tn, Qg, kk)).astype(np.int32)
    pos[:, :, -2:] = -1
    S = jscan._pad16(S_max, minimum=1)
    s_j, p_j = jscan._merge_tasks(
        jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(qids), jnp.asarray(slots),
        nq=nq, S=S, kk=kk, k=k,
    )
    s_t, p_t = tscan._merge_tasks(T(scores), T(pos), T(qids), T(slots), nq=nq, S=S, kk=kk, k=k)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
