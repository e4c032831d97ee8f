"""The tensor-core scans' arithmetic and operand layouts against the JAX package.

flat_group_scan and ivf_f32_scan compute the reference's three-pass hi/lo
bf16 product (knowhere_tpu/ops/pallas_flat.py:85, ivf_pallas.py:140-152),
ivf_sq_scan the same over decoded SQ codes (ivf_pallas.py:263-272) and
ivf_rbq_scan the two passes qr_hi.s + qr_lo.s over +/-1 sign planes
(ivf_pallas.py:990-1003). On the CPU their wrappers run the plain PyTorch
versions, which are held here against the JAX package: the hi/lo split bit
for bit, the IVF_FLAT FAST search without the int8 sidecar (the f32 scan,
the JAX side in interpret mode) id for id, and the operands the kernels
read: FLAT's queries' bf16 image element by element, the store's padded f32
corpus, the SQ rows decoded and split as the SQ kernel stages them, and the
+/-1 image of the RaBitQ store's packed sign bits. The kernels themselves
are held against the plain versions on the GPU by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops.pallas_flat import _hi_lo as jax_hi_lo
from knowhere_tpu_torch.ops import cuda_flat, ivf_cuda
from knowhere_tpu_torch.ops import ivf_scan as tscan

from .torch_parity import build, cross_load, interpret_env, ivf_corpus, recall, search, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


def _bits(a) -> np.ndarray:
    """bf16 bit patterns of a JAX bf16 array or a torch f32 tensor of bf16 values."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _scan_kernel_split(x):
    """The split as ivf_pallas._scan_kernel writes it (lines 143-146)."""
    hi = x.astype(jnp.bfloat16)
    return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)


def _edge_values() -> np.ndarray:
    """Random magnitudes, signed zeros, +/-3.0e38, and values exactly halfway
    between two bf16 neighbours (round half to even decides hi)."""
    rng = np.random.default_rng(11)
    rand = (rng.standard_normal(4096) * np.exp(rng.uniform(-60, 60, 4096))).astype(np.float32)
    # bf16 patterns whose half-ulp residual is still a normal f32 (the
    # subnormal cases are recorded below, not asserted)
    bf = rng.integers(0x0800, 0x7F00, 512).astype(np.uint32)
    lo_n = (bf << 16).view(np.float32)
    hi_n = ((bf + 1) << 16).view(np.float32)
    half = ((lo_n.astype(np.float64) + hi_n.astype(np.float64)) / 2).astype(np.float32)
    special = np.array([0.0, -0.0, 3.0e38, -3.0e38, 1.0, -1.0], np.float32)
    return np.concatenate([rand, half, -half, special])


@pytest.mark.parametrize("jax_split", ["pallas_flat._hi_lo", "_scan_kernel", "_scan_kernel jit"])
def test_hi_lo_bit_equal_to_jax(jax_split):
    x = _edge_values()
    hi_t, lo_t = cuda_flat.hi_lo(T(x))
    fn = {"pallas_flat._hi_lo": jax.jit(jax_hi_lo), "_scan_kernel": _scan_kernel_split,
          "_scan_kernel jit": jax.jit(_scan_kernel_split)}[jax_split]
    hi_j, lo_j = fn(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(hi_t), _bits(hi_j))
    np.testing.assert_array_equal(_bits(lo_t), _bits(lo_j))
    assert (lo_t != 0).any()  # the lo residual survives (pallas_flat.py:172-175)
    # the split is exact enough: hi + lo within 2^-16 of x, relative
    big = np.abs(x) > 1e-30
    err = np.abs((hi_t + lo_t).numpy()[big].astype(np.float64) - x[big]) / np.abs(x[big])
    assert err.max() <= 2.0**-16


def test_hi_lo_subnormals_recorded(record_property):
    """f32 subnormals, and tiny normals whose lo residual is subnormal: XLA
    on the CPU flushes subnormal results to zero where torch keeps them, so
    what each side gives is recorded, not asserted."""
    sub = (np.arange(1, 65, dtype=np.uint32) * 0x1357).view(np.float32)  # positive subnormals
    tiny = ((np.arange(0x0081, 0x0481, 16, dtype=np.uint32) << 16) | 0x8000).view(np.float32)
    x = np.concatenate([sub, -sub, tiny, -tiny])
    hi_t, lo_t = cuda_flat.hi_lo(T(x))
    hi_j, lo_j = jax.jit(jax_hi_lo)(jnp.asarray(x))
    hi_k, lo_k = _scan_kernel_split(jnp.asarray(x))
    share = {
        "hi_equal_hi_lo": float(np.mean(_bits(hi_t) == _bits(hi_j))),
        "lo_equal_hi_lo": float(np.mean(_bits(lo_t) == _bits(lo_j))),
        "hi_equal_scan_kernel": float(np.mean(_bits(hi_t) == _bits(hi_k))),
        "lo_equal_scan_kernel": float(np.mean(_bits(lo_t) == _bits(lo_k))),
        "torch_hi_nonzero": float(np.mean(hi_t.numpy() != 0)),
    }
    for key, v in share.items():
        record_property(key, v)
    print("f32 subnormals, share of equal bf16 bits:", share)
    assert np.isfinite(hi_t.numpy()).all() and np.isfinite(lo_t.numpy()).all()


# ---------------------------------------------------------------------------
# the kernels' operand images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(256, 128), (128, 384)])
def test_split_operand_layout(rows, d):
    """Element (r, f) of x lands at [r // 128, f // 128, s, r % 128, f % 8]
    with s = (f % 128) // 8 for hi and 16 + that for lo."""
    x = torch.randn((rows, d), generator=torch.Generator().manual_seed(3)) * 10
    op = cuda_flat.split_operand(x)
    assert op.dtype == torch.bfloat16 and op.is_contiguous()
    assert tuple(op.shape) == (rows // 128, d // 128, 32, 128, 8)
    hi, lo = cuda_flat.hi_lo(x)
    r = torch.arange(rows)[:, None].expand(rows, d)
    f = torch.arange(d)[None, :].expand(rows, d)
    s = (f % 128) // 8
    np.testing.assert_array_equal(op[r // 128, f // 128, s, r % 128, f % 8].float().numpy(), hi.numpy())
    np.testing.assert_array_equal(op[r // 128, f // 128, 16 + s, r % 128, f % 8].float().numpy(), lo.numpy())
    # each 8 x 8 core matrix is 128 contiguous bytes: rows step by 16 bytes
    assert op.stride()[3] * 2 == 16 and op.stride()[4] * 2 == 2


def test_split_operand_refuses_unpadded():
    with pytest.raises(ValueError):
        cuda_flat.split_operand(torch.zeros((100, 128)))
    with pytest.raises(ValueError):
        cuda_flat.split_operand(torch.zeros((128, 96)))


def test_query_operand_pads_to_the_tile():
    q = torch.randn((130, 256), generator=torch.Generator().manual_seed(4))
    op = cuda_flat.query_operand(q)
    assert tuple(op.shape) == (2, 2, 32, 128, 8)
    np.testing.assert_array_equal(op.float().numpy()[1, :, :, 2:, :], 0.0)  # rows 130..255
    torch.testing.assert_close(op[:1], cuda_flat.split_operand(q[:128]), rtol=0, atol=0)


@pytest.mark.parametrize("nb,d", [(3000, 96), (2048, 200)])
def test_flat_store_operand_image(nb, d):
    """The group-max kernel reads FlatScanStore's padded f32 copy as its
    corpus operand (it splits it to hi/lo while staging): contiguous rows
    of a multiple of 128 features, a multiple of the 128-row corpus tile,
    pad rows and pad features zero, pad norms 1e38; phase 2's grouped view
    shares its storage. No bf16 copy is kept."""
    x = torch.randn((nb, d), generator=torch.Generator().manual_seed(5))
    store = cuda_flat.FlatScanStore(x, None, True)
    assert store.base.shape == (store.nb_pad, store.d_pad) and store.base.dtype == torch.float32
    assert store.nb_pad % 128 == 0 and store.d_pad % 128 == 0 and store.base.is_contiguous()
    assert store.base.data_ptr() % 16 == 0
    np.testing.assert_array_equal(store.base[:nb, :d].numpy(), x.numpy())
    assert (store.base[nb:] == 0).all() and (store.base[:, d:] == 0).all()
    torch.testing.assert_close(store.nrm[:nb], (x * x).sum(1))
    assert (store.nrm[nb:] == 1e38).all()
    assert store.base_g.data_ptr() == store.base.data_ptr()
    assert not any(t.dtype == torch.bfloat16 for t in vars(store).values() if isinstance(t, torch.Tensor))


def _sq_kernel_split(codes, vmin, vdiff, levels):
    """The decode and split as ivf_pallas._sq_kernel writes them (lines
    263-271)."""
    c = codes.astype(jnp.int32).astype(jnp.float32)
    rows = vmin[None] + (c + 0.5) * (1.0 / levels) * vdiff[None]
    return _scan_kernel_split(rows)


@pytest.mark.parametrize("levels", [256, 64])
def test_sq_decode_split_image_bit_equal(levels, record_property):
    """ivf_sq_scan decodes each staged code as vmin + ((c + 0.5) / levels)
    vdiff (two roundings, no contraction) and splits it to hi/lo bf16; the
    plain version's decode (ivf_cuda._sq_rows) and split (hi_lo) give the
    JAX kernel's r_hi and r_lo bit for bit on a random, non-grid grid. XLA's
    CPU jit may fuse the decode's multiply and add into one rounding; the
    share of values that then differ is recorded, not asserted."""
    rng = np.random.default_rng(12)
    codes = rng.integers(0, levels, (512, 128)).astype(np.uint8)
    vmin = (rng.standard_normal(128) * 3).astype(np.float32)
    vdiff = (rng.random(128) * 5 + 0.1).astype(np.float32)
    hi_t, lo_t = cuda_flat.hi_lo(ivf_cuda._sq_rows(T(codes), T(vmin), T(vdiff), levels))
    args = (jnp.asarray(codes), jnp.asarray(vmin), jnp.asarray(vdiff), levels)
    hi_j, lo_j = _sq_kernel_split(*args)
    np.testing.assert_array_equal(_bits(hi_t), _bits(hi_j))
    np.testing.assert_array_equal(_bits(lo_t), _bits(lo_j))
    assert (lo_t != 0).float().mean() > 0.9  # the lo pass carries information here
    hi_jit, lo_jit = jax.jit(_sq_kernel_split, static_argnums=3)(*args)
    record_property("jit_lo_differing_share", float(np.mean(_bits(lo_t) != _bits(lo_jit))))
    record_property("jit_hi_differing_share", float(np.mean(_bits(hi_t) != _bits(hi_jit))))


@pytest.mark.parametrize("dim", [128, 100])
def test_rbq_sign_image_equals_jax_planes(dim):
    """ivf_rbq_scan expands the store's packed sign bits (little-endian, a
    set bit is +1) into a +/-1 bf16 operand; unpack_signs, which the plain
    version uses, gives the JAX package's int8 sign planes of the same
    (cross-loaded) index element by element over the true columns. At
    dim=100 the JAX planes hold 0 in the padded columns and the port -1;
    both meet zero query residuals there (zero-extended rotation and
    rotated centroids)."""
    xb = ivf_corpus(4096, 8, dim, K)[0]
    jidx = build(kt, "IVF_RABITQ", xb, {"metric_type": "L2", "nlist": 8})
    tidx = cross_load(jidx, ktt)
    jst, tst, node = jidx.node._store, tidx.node._store, tidx.node
    n = node._sorted_payload["signs_packed"].shape[0]
    planes = np.asarray(jst["signs"])[:n]
    image = ivf_cuda.unpack_signs(tst["signs"][:n], node._d_dev).numpy()
    assert image.shape == planes.shape == (n, 128)
    np.testing.assert_array_equal(image[:, :dim], planes[:, :dim].astype(np.float32))
    assert set(np.unique(image).tolist()) == {-1.0, 1.0}  # exact in bf16
    assert not planes[:, dim:].any() and not tst["rot_t"][:, dim:].any()
    assert not tst["centroids_rot"][:, dim:].any()


# ---------------------------------------------------------------------------
# IVF_FLAT FAST through the f32 scan, against the JAX package
# ---------------------------------------------------------------------------


def test_ivf_flat_fast_f32_scan_matches_jax(monkeypatch, record_property):
    """A JAX-built IVF_FLAT index, loaded into both packages with the int8
    sidecar disabled, searched at FAST: the port's three-pass f32 scan (spied)
    against the JAX _scan_kernel in interpret mode, on random non-grid data.
    Ids agree except where two candidates' scores are a near-tie."""
    xb, xq, gt = ivf_corpus(NB, NQ, DIM, K)
    jax_built = build(kt, "IVF_FLAT", xb, {"metric_type": "L2", "nlist": NLIST})
    monkeypatch.setenv("KNOWHERE_DISABLE_INT8_SCAN", "1")
    jidx = cross_load(jax_built, kt)
    tidx = cross_load(jax_built, ktt)
    assert "data_i8" not in jidx.node._store and "i8_nrm" not in tidx.node._store
    calls = []
    orig = tscan.f32_scan_tasks
    monkeypatch.setattr(tscan, "f32_scan_tasks", lambda *a, **kw: calls.append(kw["three_pass"]) or orig(*a, **kw))
    set_precision(True)
    ids_t, d_t = search(tidx, ktt, xq, SEARCH)
    ids_j, d_j = search(jidx, kt, xq, SEARCH)
    set_precision(False)
    assert calls and set(calls) == {True}
    differ = ids_t != ids_j
    record_property("ids_differing_share", float(differ.mean()))
    print(f"IVF_FLAT FAST f32 scan: {differ.mean():.4%} of ids differ from the JAX package's")
    # distances agree rank by rank; where an id differs its distance is a near-tie
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    assert differ.mean() <= 0.01
    assert recall(ids_t, gt) >= 0.9
