"""Range search, FLAT's range / iterator / by-id calls and the dense
BruteForce: the port against the JAX package on the same inputs.

The corpora are snapped to a 1/8 grid at small widths, so every L2 and IP
distance is exact in f32 on both sides: ids, lims and the order of equal
distances must then be identical, and distances agree within 1e-5 relative
+ 1e-4 (COSINE divides by rounded norms, so its distances only agree within
that tolerance; its radii sit at least 1e-5 from every distance). The
checks of tests/test_range_search_matrix.py, test_iterator_semantics.py and
test_iterator_streaming.py are run on the port's FLAT and BruteForce at the
end, copied, not imported.
"""

import jax
import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import distances as jD
from knowhere_tpu.ops import range as jR
from knowhere_tpu_torch.dataset import GenSparseDataSet
from knowhere_tpu_torch.ops import distances as tD
from knowhere_tpu_torch.ops import range as tR

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM = 1500, 8, 32
RTOL, ATOL = 1e-5, 1e-4
METRICS = ["L2", "IP", "COSINE"]


def _grid(n, d=DIM, seed=0):
    return (np.random.default_rng(seed).integers(-16, 17, (n, d)) / 8.0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _grid(NB, seed=1), _grid(NQ, seed=2)


def _dists(xq, xb, metric):
    x, q = xb.astype(np.float64), xq.astype(np.float64)
    if metric == "L2":
        return (q**2).sum(1)[:, None] - 2 * q @ x.T + (x**2).sum(1)[None]
    if metric == "IP":
        return q @ x.T
    return (q @ x.T) / np.linalg.norm(q, axis=1)[:, None] / np.linalg.norm(x, axis=1)[None]


def _between(d_all, qnt, gap=1e-5):
    """A bound near the qnt quantile of d_all at least ``gap`` from every value."""
    v = np.unique(d_all)
    i = int(np.clip(np.searchsorted(v, np.quantile(d_all, qnt)), 1, len(v) - 1))
    while v[i] - v[i - 1] <= 2 * gap:
        i += 1
    return float((v[i] + v[i - 1]) / 2)


def _window(d_all, metric, two_sided):
    """(radius, range_filter) of a window holding about 10% of the pairs."""
    larger = metric != "L2"
    radius = _between(d_all, 0.9 if larger else 0.1)
    if not two_sided:
        return radius, float("inf")
    return radius, _between(d_all, 0.98 if larger else 0.02)


def _ops_both(xq, xb, metric, radius, rf, mask=None, **kw):
    """(JAX's, the port's) range_search on the same inputs."""
    b_j = jax.device_put(xb)
    out_j = jR.range_search(
        xq, b_j, radius, rf, metric, aux=jD.base_aux(metric, b_j),
        bitset_mask=None if mask is None else jax.device_put(mask), **kw,
    )
    b_t = torch.from_numpy(xb)
    out_t = tR.range_search(
        xq, b_t, radius, rf, metric, aux=tD.base_aux(metric, b_t),
        bitset_mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    return out_j, out_t


def _assert_csr_equal(out_j, out_t):
    (i_j, d_j, l_j), (i_t, d_t, l_t) = out_j, out_t
    np.testing.assert_array_equal(l_t, l_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)
    assert i_t.dtype == np.int64 and d_t.dtype == np.float32 and l_t.dtype == np.int64


# ---------------------------------------------------------------------------
# ops/range.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_range_search_matches_jax(data, metric, two_sided):
    xb, xq = data
    radius, rf = _window(_dists(xq, xb, metric), metric, two_sided)
    out_j, out_t = _ops_both(xq, xb, metric, radius, rf)
    assert out_t[2][-1] > NQ  # the window holds hits
    _assert_csr_equal(out_j, out_t)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_range_search_bitset_k_and_id_map(data, metric):
    xb, xq = data
    radius, rf = _window(_dists(xq, xb, metric), metric, True)
    keep = np.random.default_rng(3).random(NB) >= 0.5
    id_map = np.random.default_rng(4).permutation(NB).astype(np.int64) + 10_000
    out_j, out_t = _ops_both(xq, xb, metric, radius, rf, mask=keep, id_map=id_map)
    _assert_csr_equal(out_j, out_t)
    assert np.isin(out_t[0], id_map[keep]).all()
    for rsk in (0, 1, 7, 10_000):
        capped_j = jR.apply_range_search_k(*out_j, rsk, metric != "L2")
        capped_t = tR.apply_range_search_k(*out_t, rsk, metric != "L2")
        _assert_csr_equal(capped_j, capped_t)
    assert tR.apply_range_search_k(*out_t, -1, False)[0] is out_t[0]


def test_range_search_tiles_are_neutral(data):
    """Small tiles and query chunks give the same CSR as one block."""
    xb, xq = data
    radius, rf = _window(_dists(xq, xb, "L2"), "L2", False)
    out_j, out_t = _ops_both(xq, xb, "L2", radius, rf, tile=97, query_chunk=3)
    _assert_csr_equal(out_j, out_t)
    _assert_csr_equal(out_t, _ops_both(xq, xb, "L2", radius, rf)[1])


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_range_search_ties_keep_jax_order(metric):
    """Duplicate rows (equal distances) and a radius equal to a distance that
    occurs: the same ids, in the same order, as the JAX package."""
    base = _grid(40, d=8, seed=5)
    xb = np.concatenate([base] * 6)[np.random.default_rng(6).permutation(240)]
    xq = np.concatenate([base[:3], _grid(3, d=8, seed=7)])
    d_all = _dists(xq, xb, metric)
    radius = float(np.sort(d_all, axis=None)[int(d_all.size * (0.6 if metric == "IP" else 0.4))])
    out_j, out_t = _ops_both(xq, xb, metric, radius, float("inf"))
    _assert_csr_equal(out_j, out_t)
    d_t = out_t[1]
    assert (np.diff(d_t[out_t[2][0] : out_t[2][1]]) == 0).any()  # ties in one query's run


def test_range_search_empty_result(data):
    xb, xq = data
    out_j, out_t = _ops_both(xq, xb, "L2", 0.0, float("inf"))
    _assert_csr_equal(out_j, out_t)
    assert out_t[2][-1] == 0


# ---------------------------------------------------------------------------
# FLAT
# ---------------------------------------------------------------------------


def _flat(pkg, xb, metric):
    idx = pkg.IndexFactory.Instance().Create("FLAT").value()
    assert idx.Build(pkg.GenDataSetFromArray(xb), {"metric_type": metric}) == pkg.Status.success
    return idx


def _csr(res):
    assert res.has_value(), res.what()
    v = res.value()
    return np.asarray(v.ids), np.asarray(v.distance), np.asarray(v.lims)


def _bitset(pkg, seed=8):
    return pkg.BitsetView.from_bool_array(np.random.default_rng(seed).random(NB) < 0.5)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_range_search_matches_jax(data, metric):
    xb, xq = data
    radius, rf = _window(_dists(xq, xb, metric), metric, True)
    cfgs = [
        {"radius": radius},
        {"radius": radius, "range_filter": rf},
        {"radius": radius, "range_search_k": 5},
    ]
    j, t = _flat(kt, xb, metric), _flat(ktt, xb, metric)
    for cfg in cfgs:
        cfg = {"metric_type": metric, **cfg}
        _assert_csr_equal(
            _csr(j.RangeSearch(kt.GenDataSetFromArray(xq), cfg)),
            _csr(t.RangeSearch(ktt.GenDataSetFromArray(xq), cfg)),
        )
        _assert_csr_equal(
            _csr(j.RangeSearch(kt.GenDataSetFromArray(xq), cfg, _bitset(kt))),
            _csr(t.RangeSearch(ktt.GenDataSetFromArray(xq), cfg, _bitset(ktt))),
        )


def _drain(it, n=None):
    out = []
    while it.HasNext() and (n is None or len(out) < n):
        out.append(it.Next())
    return np.array([i for i, _ in out], np.int64), np.array([d for _, d in out], np.float32)


def _assert_iterators_equal(its_j, its_t, n):
    assert len(its_j) == len(its_t)
    for it_j, it_t in zip(its_j, its_t):
        i_j, d_j = _drain(it_j, n)
        i_t, d_t = _drain(it_t, n)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_ann_iterator_matches_jax(data, metric, filtered):
    """The first 200 items of each query's iterator (COSINE: the distances
    only agree within the tolerance, so its order may differ at near-ties;
    its grid rows give few)."""
    xb, xq = data
    j, t = _flat(kt, xb, metric), _flat(ktt, xb, metric)
    bs_j, bs_t = (_bitset(kt), _bitset(ktt)) if filtered else (kt.BitsetView(), ktt.BitsetView())
    its_j = j.AnnIterator(kt.GenDataSetFromArray(xq), {"metric_type": metric}, bs_j).value()
    its_t = t.AnnIterator(ktt.GenDataSetFromArray(xq), {"metric_type": metric}, bs_t)
    assert its_t.has_value(), its_t.what()
    if metric == "COSINE":
        for it_j, it_t in zip(its_j, its_t.value()):
            i_j, d_j = _drain(it_j, 200)
            i_t, d_t = _drain(it_t, 200)
            np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)
            assert set(i_t[:150]) <= set(i_j)
        return
    _assert_iterators_equal(its_j, its_t.value(), 200)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_calc_dist_by_ids_matches_jax(data, metric):
    xb, xq = data
    ids = np.random.default_rng(9).choice(NB, 37, replace=False)
    d_j = _flat(kt, xb, metric).CalcDistByIDs(kt.GenDataSetFromArray(xq), None, ids, len(ids))
    d_t = _flat(ktt, xb, metric).CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, ids, len(ids))
    assert d_t.has_value(), d_t.what()
    assert d_t.value().shape == (NQ, len(ids))
    np.testing.assert_allclose(d_t.value(), np.asarray(d_j.value()), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# BruteForce (dense)
# ---------------------------------------------------------------------------


def _ds(pkg, x):
    return pkg.GenDataSetFromArray(x)


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_search_matches_jax(data, metric):
    xb, xq = data
    cfg = {"metric_type": metric, "k": 25}
    for bs_j, bs_t in ((None, None), (_bitset(kt), _bitset(ktt))):
        r_j = kt.BruteForce.Search(_ds(kt, xb), _ds(kt, xq), cfg, bs_j).value()
        r_t = ktt.BruteForce.Search(_ds(ktt, xb), _ds(ktt, xq), cfg, bs_t)
        assert r_t.has_value(), r_t.what()
        np.testing.assert_array_equal(r_t.value().ids, r_j.ids)
        np.testing.assert_allclose(r_t.value().distance, r_j.distance, rtol=RTOL, atol=ATOL)
    ids_buf, d_buf = np.empty(NQ * 25, np.int64), np.empty(NQ * 25, np.float32)
    assert ktt.BruteForce.SearchWithBuf(_ds(ktt, xb), _ds(ktt, xq), ids_buf, d_buf, cfg) == ktt.Status.success
    np.testing.assert_array_equal(ids_buf, kt.BruteForce.Search(_ds(kt, xb), _ds(kt, xq), cfg).value().ids)


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_range_search_matches_jax(data, metric):
    xb, xq = data
    radius, rf = _window(_dists(xq, xb, metric), metric, True)
    for cfg in ({"radius": radius}, {"radius": radius, "range_filter": rf, "range_search_k": 9}):
        cfg = {"metric_type": metric, **cfg}
        for bs_j, bs_t in ((None, None), (_bitset(kt), _bitset(ktt))):
            _assert_csr_equal(
                _csr(kt.BruteForce.RangeSearch(_ds(kt, xb), _ds(kt, xq), cfg, bs_j)),
                _csr(ktt.BruteForce.RangeSearch(_ds(ktt, xb), _ds(ktt, xq), cfg, bs_t)),
            )


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_brute_force_ann_iterator_matches_jax(data, metric):
    xb, xq = data
    cfg = {"metric_type": metric}
    its_j = kt.BruteForce.AnnIterator(_ds(kt, xb), _ds(kt, xq), cfg, _bitset(kt)).value()
    its_t = ktt.BruteForce.AnnIterator(_ds(ktt, xb), _ds(ktt, xq), cfg, _bitset(ktt))
    assert its_t.has_value(), its_t.what()
    _assert_iterators_equal(its_j, its_t.value(), 200)


def _chunks(pkg, xb, cuts=(0, 400, 401, 1100, NB)):
    return [pkg.GenDataSetFromArray(xb[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_brute_force_on_chunk_matches_jax(data, metric, filtered):
    """SearchOnChunkWithBuf over four chunks (one of a single row, k larger
    than it) and AnnIteratorOnChunk: global ids, the bitset over the
    concatenated rows, the same buffers and streams as the JAX package."""
    xb, xq = data
    k = 20
    bs_j, bs_t = (_bitset(kt), _bitset(ktt)) if filtered else (None, None)
    bufs = []
    for pkg, bs in ((kt, bs_j), (ktt, bs_t)):
        ids_buf, d_buf = np.empty(NQ * k, np.int64), np.empty(NQ * k, np.float32)
        st = pkg.BruteForce.SearchOnChunkWithBuf(
            _chunks(pkg, xb), _ds(pkg, xq), ids_buf, d_buf, {"metric_type": metric, "k": k}, bs
        )
        assert st == pkg.Status.success
        bufs.append((ids_buf, d_buf))
    np.testing.assert_array_equal(bufs[1][0], bufs[0][0])
    np.testing.assert_allclose(bufs[1][1], bufs[0][1], rtol=RTOL, atol=ATOL)
    whole = kt.BruteForce.Search(_ds(kt, xb), _ds(kt, xq), {"metric_type": metric, "k": k}, bs_j).value()
    np.testing.assert_array_equal(bufs[1][0], whole.ids)
    its_j = kt.BruteForce.AnnIteratorOnChunk(_chunks(kt, xb), _ds(kt, xq), {"metric_type": metric}, bs_j).value()
    its_t = ktt.BruteForce.AnnIteratorOnChunk(_chunks(ktt, xb), _ds(ktt, xq), {"metric_type": metric}, bs_t)
    assert its_t.has_value(), its_t.what()
    _assert_iterators_equal(its_j, its_t.value(), 200)


def _binary_ds(n, dim_bits=64, seed=10):
    x = np.random.default_rng(seed).integers(0, 256, (n, dim_bits // 8), dtype=np.uint8)
    return ktt.GenDataSet(n, dim_bits, x)


@pytest.mark.parametrize("call", ["Search", "RangeSearch", "AnnIterator", "SearchOnChunkWithBuf", "AnnIteratorOnChunk"])
@pytest.mark.parametrize("case", ["binary_metric", "sparse_base"])
def test_brute_force_binary_and_sparse_not_implemented(call, case):
    """Binary metrics and sparse bases answer Search, RangeSearch and
    AnnIterator, as the JAX package does (tests/test_torch_binary.py and
    tests/test_torch_sparse_index.py hold their results to it). The
    multi-chunk calls take dense chunks only: a sparse chunk answers
    not_implemented, with a message that names it (the JAX package raises
    a TypeError there, internal_error)."""
    if case == "binary_metric":
        base, query, cfg = _binary_ds(64), _binary_ds(2, seed=11), {"metric_type": "HAMMING", "k": 3, "radius": 20}
        want, word = ktt.Status.success, None
    else:
        rows = [{0: 1.0, 3: 2.0}, {1: 0.5}, {2: 1.5, 3: 0.25}]
        base, query = GenSparseDataSet(rows, 4), GenSparseDataSet(rows[:1], 4)
        cfg, word = {"metric_type": "IP", "k": 2, "radius": 0.1}, "sparse"
        want = ktt.Status.not_implemented if "Chunk" in call else ktt.Status.success
    fn = getattr(ktt.BruteForce, call)
    if call == "SearchOnChunkWithBuf":
        st = fn([base], query, np.empty(query.rows * 3, np.int64), np.empty(query.rows * 3, np.float32), cfg)
        assert st == want
        return
    res = fn([base] if call == "AnnIteratorOnChunk" else base, query, cfg)
    if want == ktt.Status.success:
        assert res.has_value(), res.what()
        return
    assert not res.has_value()
    assert res.error() == want
    assert word in res.what()


def test_brute_force_dense_metric_on_binary_data():
    res = ktt.BruteForce.Search(_binary_ds(64), _binary_ds(2, seed=11), {"metric_type": "L2", "k": 3})
    assert res.error() == ktt.Status.invalid_metric_type


# ---------------------------------------------------------------------------
# The reference's range / iterator checks on the port's FLAT and BruteForce
# (copied from tests/test_range_search_matrix.py, test_iterator_semantics.py
# and test_iterator_streaming.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(101)
    return rng.standard_normal((1200, 32), dtype=np.float32), np.random.default_rng(102).standard_normal(
        (6, 32), dtype=np.float32
    )


def _unpack(res, nq):
    ids, d, lims = _csr(res)
    assert lims.shape == (nq + 1,) and lims[-1] == len(ids) == len(d)
    return lims, ids, d


def test_matrix_flat_l2_one_sided(gauss):
    xb, xq = gauss
    med = float(np.median(((xq[0] - xb) ** 2).sum(1)))
    res = _flat(ktt, xb, "L2").RangeSearch(_ds(ktt, xq), {"metric_type": "L2", "radius": med})
    lims, ids, d = _unpack(res, len(xq))
    assert (d < med + 1e-3).all()
    for qi in range(len(xq)):
        sl = slice(lims[qi], lims[qi + 1])
        for i, dd in zip(ids[sl][:5], d[sl][:5]):
            np.testing.assert_allclose(dd, ((xq[qi] - xb[i]) ** 2).sum(), rtol=2e-3, atol=1e-2)


def test_matrix_flat_l2_two_sided_and_ip_windows(gauss):
    xb, xq = gauss
    dall = ((xq[:, None] - xb[None]) ** 2).sum(-1)
    lo, hi = float(np.quantile(dall, 0.1)), float(np.quantile(dall, 0.5))
    res = _flat(ktt, xb, "L2").RangeSearch(_ds(ktt, xq), {"metric_type": "L2", "radius": hi, "range_filter": lo})
    _, _, d = _unpack(res, len(xq))
    assert (d < hi + 1e-3).all() and (d >= lo - 1e-3).all()
    ip = xq @ xb.T
    lo, hi = float(np.quantile(ip, 0.6)), float(np.quantile(ip, 0.95))
    idx = _flat(ktt, xb, "IP")
    _, _, d = _unpack(idx.RangeSearch(_ds(ktt, xq), {"metric_type": "IP", "radius": lo}), len(xq))
    assert (d > lo - 1e-3).all()
    _, _, d2 = _unpack(idx.RangeSearch(_ds(ktt, xq), {"metric_type": "IP", "radius": lo, "range_filter": hi}), len(xq))
    assert (d2 > lo - 1e-3).all() and (d2 <= hi + 1e-3).all()


def test_matrix_flat_exact_count_cap_and_bitset(gauss):
    xb, xq = gauss
    dall = ((xq[:, None] - xb[None]) ** 2).sum(-1)
    idx = _flat(ktt, xb, "L2")
    r = float(np.quantile(dall, 0.2))
    lims, ids, _ = _unpack(idx.RangeSearch(_ds(ktt, xq), {"metric_type": "L2", "radius": r}), len(xq))
    for qi in range(len(xq)):
        assert set(ids[lims[qi] : lims[qi + 1]].tolist()) == set(np.nonzero(dall[qi] < r)[0].tolist())
    r = float(np.quantile(dall, 0.5))
    lims, _, _ = _unpack(idx.RangeSearch(_ds(ktt, xq), {"metric_type": "L2", "radius": r, "range_search_k": 7}), len(xq))
    assert (np.diff(lims) <= 7).all()
    drop = np.random.default_rng(11).random(len(xb)) < 0.5
    res = idx.RangeSearch(_ds(ktt, xq), {"metric_type": "L2", "radius": float(np.quantile(dall, 0.3))},
                          ktt.BitsetView.from_bool_array(drop))
    _, ids, _ = _unpack(res, len(xq))
    assert not drop[ids].any()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_semantics_flat_order_monotone_and_recall(metric):
    rng = np.random.default_rng(81)
    xb, xq = rng.standard_normal((1500, 48), dtype=np.float32), np.random.default_rng(82).standard_normal(
        (4, 48), dtype=np.float32
    )
    idx = _flat(ktt, xb, metric)
    its = idx.AnnIterator(_ds(ktt, xq), {"metric_type": metric, "retain_iterator_order": True,
                                         "iterator_refine_ratio": 0.5}, ktt.BitsetView())
    assert its.has_value(), its.what()
    gt = np.argsort(-_dists(xq, xb, metric) if metric == "IP" else _dists(xq, xb, metric), 1)[:, :10]
    for qi, it in enumerate(its.value()):
        ids, d = _drain(it, 50)
        assert len(ids) == 50
        assert (np.diff(d) >= -1e-4).all() if metric == "L2" else (np.diff(d) <= 1e-4).all()
        assert len(set(ids[:10]) & set(gt[qi])) >= 6


def test_semantics_flat_exhaustion_on_tiny_corpus():
    xb = np.random.default_rng(5).standard_normal((32, 48), dtype=np.float32)
    q = np.random.default_rng(6).standard_normal((1, 48), dtype=np.float32)
    it = _flat(ktt, xb, "L2").AnnIterator(_ds(ktt, q), {"metric_type": "L2"}, ktt.BitsetView()).value()[0]
    ids, _ = _drain(it, 100)
    assert len(ids) == 32 and not it.HasNext() and len(set(ids.tolist())) == 32


def test_streaming_brute_force_iterator_drains_in_order():
    """The reference's lazy precomputed sort, through BruteForce: a drain of
    60,001 rows surfaces every row once, best first, and its head is
    BruteForce.Search's."""
    xb = np.random.default_rng(1).random((60_001, 4)).astype(np.float32)
    q = np.random.default_rng(2).random((1, 4)).astype(np.float32)
    it = ktt.BruteForce.AnnIterator(_ds(ktt, xb), _ds(ktt, q), {"metric_type": "IP"}).value()[0]
    ids, d = _drain(it)
    assert len(ids) == 60_001 and len(np.unique(ids)) == 60_001
    assert (np.diff(d) <= 1e-6).all()
    head = ktt.BruteForce.Search(_ds(ktt, xb), _ds(ktt, q), {"metric_type": "IP", "k": 10}).value().ids
    assert set(ids[:10]) == set(head.tolist())
