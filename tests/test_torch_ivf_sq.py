"""IVF_SQ8: the port against the JAX package, codec, kernel and end to end.

The same numpy inputs go through the JAX functions and their counterparts in
the port (on the CPU, so the SQ and int8 scan wrappers run their plain
PyTorch versions). The Pallas SQ kernel runs in interpret mode, as
tests/test_pallas.py runs the Pallas kernels. End to end, the JAX package
builds the index under KNOWHERE_PALLAS_INTERPRET=1 and the port loads it
through the KWTPU bytes (and the other way); both search the same queries
through the public API.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import quant as jquant
from knowhere_tpu.ops.ivf_pallas import LIST_ALIGN, pallas_sq_tasks
from knowhere_tpu_torch.ops import ivf_cuda
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.ops import quant as tquant

from .torch_parity import (
    assert_same_topk, build, cross_load, exact_topk, interpret_env, ivf_corpus, recall, search, set_precision,
)

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE}
SQ_TYPES = ["SQ8", "SQ6", "SQ4", "FP16", "BF16"]


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


def grid_corpus(seed=0):
    """ivf_corpus snapped to multiples of 1/8 in [-8, 8], with one row at
    each end so every dim's grid is vmin = -8, vdiff = 16. Then every
    SQ8/SQ6/SQ4 decoded value and every query is bf16-exact and every dot and
    norm is exact in f32: the port's single bf16 pass and the interpret-mode
    f32 dot give the same bits, and ids can be compared exactly at FAST too."""
    xb, xq, _ = ivf_corpus(NB, NQ, DIM, K, seed)
    xb, xq = (np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32) for a in (xb, xq))
    xb[0], xb[1] = -8.0, 8.0
    return xb, xq, exact_topk(xb, xq, K)


@pytest.fixture(scope="module")
def corpus():
    return grid_corpus()


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq_type", SQ_TYPES)
def test_sq_encode_byte_identical(corpus, sq_type):
    x = corpus[0][:3000]
    codec_j = jquant.sq_train(x, sq_type)
    codec_t = tquant.sq_train(x, sq_type)
    if codec_j.vmin is not None:
        np.testing.assert_array_equal(codec_t.vmin, codec_j.vmin)
        np.testing.assert_array_equal(codec_t.vdiff, codec_j.vdiff)
    codes_j = jquant.sq_encode(codec_j, x)
    codes_t = tquant.sq_encode(codec_t, x)
    # the port holds BF16 rows as their uint16 bit patterns (utils/bf16.py)
    assert codes_t.dtype == (np.uint16 if sq_type == "BF16" else codes_j.dtype)
    assert codes_t.shape == codes_j.shape
    np.testing.assert_array_equal(codes_t.view(np.uint8), codes_j.view(np.uint8))
    if codec_j.vmin is not None:  # the decode is the reference's, bit for bit
        dec_j = np.asarray(jquant.sq_decode_dev(codec_j, jnp.asarray(codes_j), jnp.asarray(codec_j.vmin),
                                                jnp.asarray(codec_j.vdiff)))
        dec_t = tquant.sq_decode(T(codes_t), T(codec_t.vmin), T(codec_t.vdiff), codec_t.levels,
                                 sq_type == "SQ4", DIM).numpy()
        np.testing.assert_array_equal(dec_t, dec_j)


# ---------------------------------------------------------------------------
# the SQ scan's plain version vs the Pallas SQ kernel
# ---------------------------------------------------------------------------


def _sq_inputs(rng, levels, nlist=3, Qg=16, nq=40):
    """Codes, a grid and queries whose decoded values are bf16-exact: with
    vdiff a power of two and vmin = -vdiff/2, x = vdiff * (2c + 1 - levels) /
    (2 levels) has at most 8 significant bits. The interpret-mode CPU dot is
    full f32, not the TPU's bf16 pass; bf16-exact operands make the two
    arithmetics the same."""
    nb = nlist * LIST_ALIGN
    codes = rng.integers(0, levels, (nb, DIM)).astype(np.uint8)
    vdiff = (2.0 ** rng.integers(-2, 3, DIM)).astype(np.float32)
    vmin = (-vdiff / 2).astype(np.float32)
    q = T(rng.standard_normal((nq, DIM)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    Tc = 2 * nlist
    blk = np.tile(np.arange(nlist, dtype=np.int32), 2)
    nrows = rng.integers(LIST_ALIGN // 2, LIST_ALIGN + 1, Tc).astype(np.int32)
    nrows[0] = LIST_ALIGN
    q_task = q[rng.integers(0, nq, (Tc, Qg))]
    return codes, vmin, vdiff, blk, nrows, q_task


@pytest.mark.parametrize(
    "is_l2,masked,three_pass,levels,kk",
    [
        (True, False, False, 256, 8),
        (True, True, False, 64, 32),
        (False, False, False, 64, 8),
        (False, True, False, 256, 32),
        (True, False, True, 256, 32),
        (False, True, True, 64, 8),
    ],
)
def test_sq_scan_plain_matches_pallas_sq(is_l2, masked, three_pass, levels, kk):
    """Scores within 1e-5 relative + 1e-3 (the products agree; sums run in
    another order), positions equal except near-ties; three_pass runs the
    reference's hi/lo split on both sides."""
    rng = np.random.default_rng(21)
    codes, vmin, vdiff, blk, nrows, q_task = _sq_inputs(rng, levels)
    keep = rng.random(codes.shape[0]) < 0.5 if masked else None
    s_j, p_j = _pallas_sq(blk, nrows, q_task, codes, vmin, vdiff, keep, kk, levels, is_l2, three_pass)
    s_t, p_t = ivf_cuda.sq_scan_tasks(
        T(blk), T(nrows), T(q_task), T(codes), T(vmin), T(vdiff), None if keep is None else T(keep),
        B=LIST_ALIGN, kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass,
    )
    assert_same_topk(s_j, p_j, s_t.numpy(), p_t.numpy(), 1e-5, 1e-3)
    if keep is not None:
        p = p_t.numpy()
        assert not (~keep[p[p >= 0]]).any()


def _pallas_sq(blk, nrows, q_task, codes, vmin, vdiff, keep, kk, levels, is_l2, three_pass):
    s, p = pallas_sq_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(q_task), jnp.asarray(vmin[None]), jnp.asarray(vdiff[None]),
        jnp.asarray(codes), None if keep is None else jnp.asarray(keep.astype(np.int32).reshape(-1, 1, LIST_ALIGN)),
        B=LIST_ALIGN, Qg=q_task.shape[1], kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass, interpret=True,
    )
    return np.asarray(s), np.asarray(p)


def _split_sensitive_sq_inputs(rng, s=16.0, nlist=2, Qg=8):
    """Codes, a grid and queries on which full f32 and the hi/lo split
    disagree far beyond 1e-5 at IP: every query value is s (1 + 0.9 2^-8)
    plus noise, so its lo residual is +0.9 2^-8 s; half the decoded values
    lie just above s (lo > 0), half just above -s (1 + 2^-7) (hi rounds away
    from zero, lo > 0 again). Each dropped lo.lo product is then ~+1.2e-5
    s^2, all of one sign, while the dot itself nearly cancels."""
    half = DIM // 2
    vmin = np.concatenate([np.full(half, s * (1 + 0.9 / 256)), np.full(half, -s * (1 + 2 / 256))]).astype(np.float32)
    vmin[half:] += np.float32(0.9 / 256 * s)
    vdiff = np.full(DIM, s * 2.0**-14, np.float32)
    nb = nlist * LIST_ALIGN
    codes = rng.integers(0, 256, (nb, DIM)).astype(np.uint8)
    q = (s * (1 + 0.9 / 256) + rng.random((Qg * 2, DIM)) * s * 2.0**-14).astype(np.float32)
    Tc = 2 * nlist
    blk = np.tile(np.arange(nlist, dtype=np.int32), 2)
    nrows = np.full(Tc, LIST_ALIGN, np.int32)
    nrows[1] = 300
    q_task = q[rng.integers(0, len(q), (Tc, Qg))]
    return codes, vmin, vdiff, blk, nrows, q_task


@pytest.mark.parametrize("masked,kk", [(False, 8), (True, 32)])
def test_sq_three_pass_is_the_split_not_f32(masked, kk):
    """On data where full f32 and the reference's hi/lo split disagree by
    far more than 1e-5 relative + 1e-3, the plain version's three_pass
    agrees with the JAX kernel's within that."""
    rng = np.random.default_rng(23)
    codes, vmin, vdiff, blk, nrows, q_task = _split_sensitive_sq_inputs(rng)
    keep = rng.random(codes.shape[0]) < 0.5 if masked else None
    s_j, p_j = _pallas_sq(blk, nrows, q_task, codes, vmin, vdiff, keep, kk, 256, False, True)
    s_t, p_t = ivf_cuda.sq_scan_tasks(
        T(blk), T(nrows), T(q_task), T(codes), T(vmin), T(vdiff), None if keep is None else T(keep),
        B=LIST_ALIGN, kk=kk, levels=256, is_l2=False, three_pass=True,
    )
    assert_same_topk(s_j, p_j, s_t.numpy(), p_t.numpy(), 1e-5, 1e-3)
    # full f32 misses the JAX kernel here
    rows = ivf_cuda._sq_rows(T(codes), T(vmin), T(vdiff), 256)
    full = torch.einsum("tqd,trd->tqr", T(q_task), rows[ivf_cuda._block_rows(T(blk), LIST_ALIGN)])
    s_f = ivf_cuda._finish(full, T(blk), T(nrows), None if keep is None else T(keep), LIST_ALIGN, kk)[0].numpy()
    assert (np.abs(s_f - s_j) / (1e-3 + 1e-5 * np.abs(s_j))).max() > 100


def test_sq_available_gate():
    """The SQ kernel takes one-byte SQ8/SQ6 codes at FAST/BF16 over aligned
    stores, as the reference's pallas_sq_available."""
    aligned = np.arange(0, 5 * LIST_ALIGN, LIST_ALIGN)
    assert tscan.sq_available(128, 128, 10, aligned, 256, False, "bf16")
    assert tscan.sq_available(128, 128, 10, aligned, 64, False, "fast")
    assert not tscan.sq_available(128, 128, 10, aligned, 256, False, "exact")
    assert not tscan.sq_available(128, 64, 10, aligned, 16, True, "bf16")  # SQ4
    assert not tscan.sq_available(128, 128, 10, aligned, 0, False, "bf16")  # FP16/BF16
    assert not tscan.sq_available(128, 128, 10, aligned + 1, 256, False, "bf16")
    assert not tscan.sq_available(96, 96, 10, aligned, 256, False, "bf16")


# ---------------------------------------------------------------------------
# end to end through the public API
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sq(corpus):
    return {t: build(kt, "IVF_SQ8", corpus[0], {"metric_type": "L2", "nlist": NLIST, "sq_type": t}) for t in SQ_TYPES}


@pytest.fixture(scope="module")
def port_sq8(corpus):
    return build(ktt, "IVF_SQ8", corpus[0], {"metric_type": "L2", "nlist": NLIST})


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("sq_type", SQ_TYPES)
def test_jax_built_index_cross_loads(corpus, jax_sq, sq_type, fast, monkeypatch):
    """Identical ids at FAST and EXACT. FAST serves SQ8 from the int8 scan +
    SQ8-decode rerank (exact under the stored values), SQ6 from the SQ scan
    (its single bf16 pass is exact on the grid corpus), the rest from the
    plain decode scan."""
    _, xq, gt = corpus
    jidx = jax_sq[sq_type]
    tidx = cross_load(jidx, ktt)
    hits = {"int8": 0, "sq": 0}
    for name, key in (("_int8_search", "int8"), ("_sq_search", "sq")):
        orig = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _o=orig, _k=key, **kw: hits.__setitem__(_k, hits[_k] + 1) or _o(*a, **kw))
    set_precision(fast)
    ids_j, d_j = search(jidx, kt, xq, SEARCH)
    ids_t, d_t = search(tidx, ktt, xq, SEARCH)
    assert hits == {"int8": int(fast and sq_type == "SQ8"), "sq": int(fast and sq_type == "SQ6")}
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    assert recall(ids_t, gt) >= (0.7 if sq_type == "SQ4" else 0.85)


def test_sq8_sidecar_bit_identical(jax_sq):
    """The derived int8 sidecar of SQ8 (exact f64 norms of the decoded rows,
    scale vdiff / levels, mu 0) is rebuilt at load bit for bit."""
    jidx = jax_sq["SQ8"]
    tidx = cross_load(jidx, ktt)
    js, ts = jidx.node._store, tidx.node._store
    np.testing.assert_array_equal(ts["i8_nrm"].numpy().view(np.uint32), np.asarray(js["i8_nrm_blk"]).reshape(-1).view(np.uint32))
    np.testing.assert_array_equal(ts["i8_scale"].numpy().view(np.uint32), np.asarray(js["i8_scale"]).view(np.uint32))
    assert not ts["i8_mu"].any()
    assert "data_i8" not in ts  # the u8 codes are scanned in place


def test_port_build_recall_and_jax_loads_it(corpus, jax_sq, port_sq8):
    xb, xq, gt = corpus
    set_precision(True)
    ids_t, d_t = search(port_sq8, ktt, xq, SEARCH)
    ids_jb, _ = search(jax_sq["SQ8"], kt, xq, SEARCH)
    assert recall(ids_t, gt) >= recall(ids_jb, gt) - 0.01
    ids_j, d_j = search(cross_load(port_sq8, kt), kt, xq, SEARCH)
    np.testing.assert_array_equal(ids_j, ids_t)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)


def test_serialize_round_trip_identical(corpus, port_sq8):
    set_precision(True)
    xq = corpus[1]
    np.testing.assert_array_equal(search(cross_load(port_sq8, ktt), ktt, xq, SEARCH)[0], search(port_sq8, ktt, xq, SEARCH)[0])


@pytest.mark.parametrize("fast", [True, False])
def test_filtered_search_matches_jax(corpus, jax_sq, fast):
    _, xq, _ = corpus
    jidx = jax_sq["SQ8"]
    tidx = cross_load(jidx, ktt)
    drop = np.random.default_rng(1).random(NB) < 0.5
    set_precision(fast)
    ids_j, d_j = search(jidx, kt, xq, SEARCH, bitset=kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = search(tidx, ktt, xq, SEARCH, bitset=ktt.BitsetView.from_bool_array(drop))
    assert (ids_t >= 0).all() and not drop[ids_t].any()
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)


def test_ensure_topk_full_widens(corpus, jax_sq):
    """A 95% bitset at nprobe=1 leaves each probed list ~25 valid rows for
    k=40: the widening retry fills every row with the JAX package's ids."""
    _, xq, _ = corpus
    jidx = jax_sq["SQ8"]
    tidx = cross_load(jidx, ktt)
    drop = np.random.default_rng(2).random(NB) < 0.95
    cfg = {"metric_type": "L2", "k": 40, "nprobe": 1}
    set_precision(True)
    short, _ = search(tidx, ktt, xq, dict(cfg, ensure_topk_full=False), ktt.BitsetView.from_bool_array(drop))
    assert (short < 0).any()
    ids_j, d_j = search(jidx, kt, xq, cfg, kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = search(tidx, ktt, xq, cfg, ktt.BitsetView.from_bool_array(drop))
    assert (ids_t >= 0).all() and not drop[ids_t].any()
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)


def test_disable_int8_scan_dispatches_the_sq_scan(corpus, jax_sq, monkeypatch):
    """Loaded under KNOWHERE_DISABLE_INT8_SCAN=1, SQ8 has no sidecar and FAST
    goes through the SQ scan wrapper (spied), with the JAX package's ids."""
    _, xq, gt = corpus
    calls = []
    orig = tscan.sq_scan_tasks
    monkeypatch.setattr(tscan, "sq_scan_tasks", lambda *a, **kw: calls.append(kw["levels"]) or orig(*a, **kw))
    monkeypatch.setenv("KNOWHERE_DISABLE_INT8_SCAN", "1")
    jidx = cross_load(jax_sq["SQ8"], kt)
    tidx = cross_load(jax_sq["SQ8"], ktt)
    assert "i8_nrm" not in tidx.node._store
    set_precision(True)
    ids_t, d_t = search(tidx, ktt, xq, SEARCH)
    ids_j, d_j = search(jidx, kt, xq, SEARCH)
    assert calls and set(calls) == {256}
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    assert recall(ids_t, gt) >= 0.85


def test_gpu_alias_serves(corpus):
    """The legacy GPU_FAISS_IVF_SQ8 name serves the plain IVF_SQ8 node."""
    xb, xq, gt = corpus
    idx = build(ktt, "GPU_FAISS_IVF_SQ8", xb, {"metric_type": "L2", "nlist": NLIST})
    set_precision(True)
    ids, d = search(idx, ktt, xq, SEARCH)
    assert recall(ids, gt) >= 0.85 and np.isfinite(d).all()
    assert not idx.HasRawData("L2")
