"""IVF_RABITQ: the port against the JAX package, codec, kernel and end to end.

The same numpy inputs go through the JAX functions and their counterparts in
the port (on the CPU, so the RaBitQ scan wrapper runs its plain PyTorch
version). The Pallas RaBitQ kernel runs in interpret mode, fed the +/-1 int8
sign planes it takes; the port gets the packed sign bits. End to end, the JAX
package builds the index under KNOWHERE_PALLAS_INTERPRET=1 and the port loads
it through the KWTPU bytes (and the other way); both search the same queries
through the public API.

A sign bit whose rotated residual lies within f32 rounding of 0 can differ
between two encodes, so id parity is held through cross-loaded BinarySets
(one encode, two searches) and the encode itself with that exception.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import distances as jdist
from knowhere_tpu.ops import quant as jquant
from knowhere_tpu.ops.ivf_pallas import LIST_ALIGN, pallas_rbq_tasks
from knowhere_tpu_torch.ops import distances as tdist
from knowhere_tpu_torch.ops import ivf_cuda
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.ops import quant as tquant

from .torch_parity import (
    assert_same_topk, build, cross_load, interpret_env, ivf_corpus, recall, search, set_precision,
)

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE, "refine_k": 4}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


@pytest.fixture(scope="module")
def corpus():
    return ivf_corpus(NB, NQ, DIM, K)


# ---------------------------------------------------------------------------
# ops/quant.py and ops/distances.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [128, 100])
def test_rabitq_make_rotation_bit_identical(dim):
    rot_j = jquant.rabitq_make(dim).rotation
    rot_t = tquant.rabitq_make(dim).rotation
    assert rot_t.dtype == rot_j.dtype == np.float32
    np.testing.assert_array_equal(rot_t.view(np.uint32), rot_j.view(np.uint32))


@pytest.mark.parametrize("dim", [128, 100])
def test_rabitq_encode_matches(corpus, dim):
    """Bits equal wherever the rotated residual is clear of 0 (|rr| >= 1e-5),
    r_norm and t within 1e-5 relative."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2000, dim)).astype(np.float32)
    cents = rng.standard_normal((16, dim)).astype(np.float32)
    assign = rng.integers(0, 16, 2000)
    codec = jquant.rabitq_make(dim)
    bits_j, rn_j, t_j = jquant.rabitq_encode(codec, x, cents, assign, chunk=700)
    bits_t, rn_t, t_t = tquant.rabitq_encode(tquant.rabitq_make(dim), x, cents, assign, chunk=700)
    assert bits_t.shape == bits_j.shape == (2000, -(-dim // 8)) and bits_t.dtype == np.uint8
    rr = (x.astype(np.float64) - cents[assign]) @ codec.rotation.T.astype(np.float64)
    b_j = tdist.unpack_bits_host(bits_j, dim)
    b_t = tdist.unpack_bits_host(bits_t, dim)
    assert ((b_j == b_t) | (np.abs(rr) < 1e-5)).all()
    np.testing.assert_allclose(rn_t, rn_j, rtol=1e-5)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-5)


def test_unpack_bits_host_identical():
    packed = np.random.default_rng(4).integers(0, 256, (37, 13)).astype(np.uint8)
    for bits in (104, 100, 97):
        out_t = tdist.unpack_bits_host(packed, bits)
        out_j = jdist.unpack_bits_host(packed, bits)
        assert out_t.dtype == out_j.dtype
        np.testing.assert_array_equal(out_t, out_j)


def test_rabitq_estimate_matches_jax():
    """The plain estimator against rabitq_estimate_dev."""
    rng = np.random.default_rng(5)
    qr = rng.standard_normal((12, DIM)).astype(np.float32)
    signs = np.where(rng.random((300, DIM)) < 0.5, -1, 1).astype(np.int8)
    rn = rng.random(300).astype(np.float32) * 3
    t = (0.6 + 0.3 * rng.random(300)).astype(np.float32)
    qn = (qr.astype(np.float64) ** 2).sum(1).astype(np.float32)
    est_j = np.asarray(jquant.rabitq_estimate_dev(*(jnp.asarray(a) for a in (qr, signs, rn, t, qn))))
    est_t = tquant.rabitq_estimate(*(T(a) for a in (qr, signs, rn, t, qn))).numpy()
    np.testing.assert_allclose(est_t, est_j, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the RaBitQ scan's plain version vs the Pallas RaBitQ kernel
# ---------------------------------------------------------------------------


def _rbq_inputs(rng, nlist=3, Qg=16, nq=40):
    """Sign planes (packed for the port, +/-1 int8 for the Pallas kernel),
    corrections, rotated centroids and queries over nlist aligned blocks, two
    tasks a block, ragged nrows."""
    nb = nlist * LIST_ALIGN
    bits = rng.random((nb, DIM)) < 0.5
    packed = np.packbits(bits, axis=1, bitorder="little")
    signs_i8 = np.where(bits, 1, -1).astype(np.int8)
    rn = (rng.random(nb) * 4).astype(np.float32)
    t = (0.6 + 0.3 * rng.random(nb)).astype(np.float32)
    cents = rng.standard_normal((nlist, DIM)).astype(np.float32)
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    Tc = 2 * nlist
    blk = np.tile(np.arange(nlist, dtype=np.int32), 2)
    lids = blk.copy()
    nrows = rng.integers(LIST_ALIGN // 2, LIST_ALIGN + 1, Tc).astype(np.int32)
    nrows[0] = LIST_ALIGN
    q_task = q[rng.integers(0, nq, (Tc, Qg))]
    return packed, signs_i8, rn, t, cents, blk, lids, nrows, q_task


@pytest.mark.parametrize(
    "is_l2,masked,three_pass,kk",
    [
        (True, False, False, 8),
        (True, True, False, 32),
        (False, False, False, 32),
        (False, True, False, 8),
        (True, False, True, 32),
        (False, True, True, 8),
    ],
)
def test_rbq_scan_plain_matches_pallas_rbq(is_l2, masked, three_pass, kk):
    """Scores within 1e-5 relative + 1e-3 (the same bf16 products, sums in
    another order), positions equal except near-ties; three_pass runs the
    reference's two passes qr_hi.s + qr_lo.s on both sides."""
    rng = np.random.default_rng(22)
    packed, signs_i8, rn, t, cents, blk, lids, nrows, q_task = _rbq_inputs(rng)
    keep = rng.random(packed.shape[0]) < 0.5 if masked else None
    args = (blk, nrows, lids, q_task, cents, rn, t, keep, kk, is_l2, three_pass)
    s_j, p_j = _pallas_rbq(signs_i8, *args)
    s_t, p_t = _port_rbq(packed, *args)
    assert_same_topk(s_j, p_j, s_t, p_t, 1e-5, 1e-3)
    if keep is not None:
        assert not (~keep[p_t[p_t >= 0]]).any()


def _pallas_rbq(signs_i8, blk, nrows, lids, q_task, cents, rn, t, keep, kk, is_l2, three_pass):
    blk3 = lambda a: jnp.asarray(a.reshape(-1, 1, LIST_ALIGN))  # noqa: E731
    s, p = pallas_rbq_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(lids), jnp.asarray(q_task), jnp.asarray(cents),
        jnp.asarray(signs_i8), blk3(rn), blk3(t), None if keep is None else blk3(keep.astype(np.int32)),
        B=LIST_ALIGN, Qg=q_task.shape[1], kk=kk, is_l2=is_l2, three_pass=three_pass, interpret=True,
    )
    return np.asarray(s), np.asarray(p)


def _port_rbq(packed, blk, nrows, lids, q_task, cents, rn, t, keep, kk, is_l2, three_pass, plain=False):
    fn = ivf_cuda.rbq_scan_plain if plain else ivf_cuda.rbq_scan_tasks
    s, p = fn(
        T(blk), T(nrows), T(lids), T(q_task), T(cents), T(packed), T(rn), T(t), None if keep is None else T(keep),
        B=LIST_ALIGN, kk=kk, is_l2=is_l2, three_pass=three_pass,
    )
    return s.numpy(), p.numpy()


def _split_sensitive_rbq_inputs(rng, nlist=2, Qg=8):
    """Sign planes, corrections and queries on which full f32 qr and the
    hi/lo split disagree far beyond 1e-5: each residual qr is 2^e times
    v = 1 + 2^-9 + 63 2^-23 (first half of the features, sign +1) or
    w = 1 + 2^-9 - 26 2^-23 (second half, sign -1 but for one or two +1 a
    row).
    Both split to hi = 1, lo = 2^-9, so the split drops +0.98 2^-17 and
    +0.41 2^-17 a feature times its sign, nearly all of one sign, against
    dots of 2 or 4; small t makes est amplify it. Centroids are multiples
    of 2^-12, so q = qr + c and q - c are exact in f32."""
    half = DIM // 2
    v, w = np.float32(1 + 2.0**-9 + 63 * 2.0**-23), np.float32(1 + 2.0**-9 - 26 * 2.0**-23)
    pattern = np.concatenate([np.full(half, v), np.full(half, w)]).astype(np.float32)
    nb = nlist * LIST_ALIGN
    bits = np.zeros((nb, DIM), bool)
    bits[:, :half] = True
    for r in range(nb):  # one or two of the second half's signs set to +1
        bits[r, half + rng.choice(half, rng.integers(1, 3), replace=False)] = True
    packed = np.packbits(bits, axis=1, bitorder="little")
    signs_i8 = np.where(bits, 1, -1).astype(np.int8)
    rn = (50 + 100 * rng.random(nb)).astype(np.float32)
    t = (0.005 + 0.015 * rng.random(nb)).astype(np.float32)
    cents = (rng.integers(-64, 65, (nlist, DIM)) * 2.0**-12).astype(np.float32)
    Tc = 2 * nlist
    blk = np.tile(np.arange(nlist, dtype=np.int32), 2)
    lids = blk.copy()
    nrows = np.full(Tc, LIST_ALIGN, np.int32)
    nrows[1] = 300
    qr = pattern[None, None, :] * 2.0 ** rng.integers(0, 4, (Tc, Qg, 1))
    q_task = (qr + cents[lids][:, None, :]).astype(np.float32)
    assert (q_task - cents[lids][:, None, :] == qr).all()
    return packed, signs_i8, rn, t, cents, blk, lids, nrows, q_task


@pytest.mark.parametrize("is_l2,masked,kk", [(False, False, 8), (True, True, 32)])
def test_rbq_three_pass_is_the_split_not_f32(is_l2, masked, kk):
    """On data where full f32 qr and the reference's hi/lo split disagree by
    far more than 1e-5 relative + 1e-3, the plain version's three_pass
    agrees with the JAX kernel's within that."""
    rng = np.random.default_rng(24)
    packed, signs_i8, rn, t, cents, blk, lids, nrows, q_task = _split_sensitive_rbq_inputs(rng)
    keep = rng.random(packed.shape[0]) < 0.5 if masked else None
    args = (blk, nrows, lids, q_task, cents, rn, t, keep, kk, is_l2, True)
    s_j, p_j = _pallas_rbq(signs_i8, *args)
    s_t, p_t = _port_rbq(packed, *args)
    assert_same_topk(s_j, p_j, s_t, p_t, 1e-5, 1e-3)
    # full f32 qr misses the JAX kernel here
    d = DIM
    qr = T(q_task) - T(cents)[T(lids).long()][:, None, :]
    rows = ivf_cuda._block_rows(T(blk), LIST_ALIGN)
    dots = torch.bmm(qr, ivf_cuda.unpack_signs(T(packed)[rows], d).transpose(1, 2))
    est = T(rn)[rows][:, None, :] * dots / (T(t)[rows][:, None, :].clamp(min=1e-6) * float(np.sqrt(d)))
    if is_l2:
        full = -((qr * qr).sum(-1, keepdim=True) + T(rn)[rows][:, None, :] ** 2 - 2.0 * est)
    else:
        full = (T(q_task) * T(cents)[T(lids).long()][:, None, :]).sum(-1, keepdim=True) + est
    s_f = ivf_cuda._finish(full, T(blk), T(nrows), None if keep is None else T(keep), LIST_ALIGN, kk)[0].numpy()
    assert (np.abs(s_f - s_j) / (1e-3 + 1e-5 * np.abs(s_j))).max() > 10


def test_rbq_available_gate():
    aligned = np.arange(0, 5 * LIST_ALIGN, LIST_ALIGN)
    store = {"signs": None}
    assert tscan.rbq_available(store, 128, 10, aligned)
    assert not tscan.rbq_available({"codes": None}, 128, 10, aligned)
    assert not tscan.rbq_available(store, 96, 10, aligned)
    assert not tscan.rbq_available(store, 128, 10, aligned + 1)
    assert not tscan.rbq_available(store, 128, 0, aligned)


# ---------------------------------------------------------------------------
# end to end through the public API
# ---------------------------------------------------------------------------


_CONFIGS = {  # name -> (dim, metric, refine)
    "l2_raw": (DIM, "L2", True),
    "l2_norefine": (DIM, "L2", False),
    "ip_norefine": (DIM, "IP", False),
    "d100_l2_norefine": (100, "L2", False),
}


@pytest.fixture(scope="module")
def jax_rbq():
    """JAX-built indexes, one per configuration, with their corpora."""
    out = {}
    corpora = {d: ivf_corpus(NB, NQ, d, K) for d in {c[0] for c in _CONFIGS.values()}}
    for name, (dim, metric, refine) in _CONFIGS.items():
        xb, xq, gt = corpora[dim]
        idx = build(kt, "IVF_RABITQ", xb, {"metric_type": metric, "nlist": NLIST, "refine": refine})
        out[name] = (idx, xq, gt, metric)
    return out


@pytest.fixture(scope="module")
def port_rbq(corpus):
    return build(ktt, "IVF_RABITQ", corpus[0], {"metric_type": "L2", "nlist": NLIST})


def _spy_rbq(monkeypatch):
    calls = []
    orig = tscan.rbq_scan_tasks
    monkeypatch.setattr(tscan, "rbq_scan_tasks", lambda *a, **kw: calls.append(kw["kk"]) or orig(*a, **kw))
    return calls


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("config", list(_CONFIGS))
def test_jax_built_index_cross_loads(jax_rbq, config, fast, monkeypatch):
    """Identical ids at FAST (the RaBitQ scan) and EXACT (the plain
    estimator), with the raw refine store and without it (the estimator's
    own distance, -score for L2); d=100 scans at the padded width 128,
    sqrt(d) included, as the reference does."""
    jidx, xq, gt, metric = jax_rbq[config]
    tidx = cross_load(jidx, ktt)
    calls = _spy_rbq(monkeypatch)
    cfg = dict(SEARCH, metric_type=metric)
    set_precision(fast)
    ids_j, d_j = search(jidx, kt, xq, cfg)
    ids_t, d_t = search(tidx, ktt, xq, cfg)
    assert bool(calls) == fast
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    if metric == "L2":
        assert recall(ids_t, gt) >= (0.85 if _CONFIGS[config][2] else 0.5)


def test_port_build_recall_and_jax_loads_it(corpus, jax_rbq, port_rbq):
    xb, xq, gt = corpus
    set_precision(True)
    ids_t, d_t = search(port_rbq, ktt, xq, SEARCH)
    ids_jb, _ = search(jax_rbq["l2_raw"][0], kt, xq, SEARCH)
    assert recall(ids_t, gt) >= recall(ids_jb, gt) - 0.01
    ids_j, d_j = search(cross_load(port_rbq, kt), kt, xq, SEARCH)
    np.testing.assert_array_equal(ids_j, ids_t)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)


@pytest.mark.parametrize("fast", [True, False])
def test_serialize_round_trip_identical(corpus, port_rbq, fast):
    set_precision(fast)
    xq = corpus[1]
    ids2, d2 = search(cross_load(port_rbq, ktt), ktt, xq, SEARCH)
    ids1, d1 = search(port_rbq, ktt, xq, SEARCH)
    np.testing.assert_array_equal(ids2, ids1)
    np.testing.assert_array_equal(d2, d1)


@pytest.mark.parametrize("config", ["l2_raw", "l2_norefine"])
def test_filtered_search_matches_jax(jax_rbq, config):
    jidx, xq, _, _ = jax_rbq[config]
    tidx = cross_load(jidx, ktt)
    drop = np.random.default_rng(1).random(NB) < 0.5
    set_precision(True)
    ids_j, d_j = search(jidx, kt, xq, SEARCH, bitset=kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = search(tidx, ktt, xq, SEARCH, bitset=ktt.BitsetView.from_bool_array(drop))
    assert (ids_t >= 0).all() and not drop[ids_t].any()
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)


def test_ensure_topk_full_widens(jax_rbq):
    """A 95% bitset at nprobe=1 leaves each probed list ~25 valid rows for
    k=40: the widening retry fills every row with the JAX package's ids."""
    jidx, xq, _, _ = jax_rbq["l2_raw"]
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


def test_fastscan_serves_and_bits_options_accepted(corpus, monkeypatch):
    """IVF_RABITQ_FASTSCAN serves through the RaBitQ scan; rbq_bits and
    rbq_bits_query are accepted (the scan takes one bit whatever they say,
    as in the reference), and the index keeps no raw data."""
    xb, xq, gt = corpus
    idx = build(ktt, "IVF_RABITQ_FASTSCAN", xb, {"metric_type": "L2", "nlist": NLIST, "rbq_bits": 4})
    calls = _spy_rbq(monkeypatch)
    set_precision(True)
    ids, d = search(idx, ktt, xq, dict(SEARCH, rbq_bits_query=2))
    assert calls and recall(ids, gt) >= 0.85 and np.isfinite(d).all()
    assert not idx.HasRawData("L2")
    bad = idx.Search(ktt.GenDataSetFromArray(xq), dict(SEARCH, rbq_bits_query=9), ktt.BitsetView())
    assert not bad.has_value()
