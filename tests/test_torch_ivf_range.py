"""RangeSearch, AnnIterator, GetVectorByIds and CalcDistByIDs of the IVF
family: the port against the JAX package on the same index.

The JAX package builds IVF_FLAT, IVF_PQ (OPQ + FP16 refine), IVF_SQ8 and
IVF_RABITQ (raw refine) and the port loads each BinarySet
(torch_parity.cross_load), so both hold the same lists; both then answer the
same queries through the public API. EXACT runs the plain full-f32 task
scan on both sides: lims identical (radii sit at least 1e-5 relative from
every exact distance), ids identical except swaps of two distances within
1e-6 relative of each other (a few ulps: the f32 sums run in other orders,
which shows on IVF_PQ's FP16 refine rows), distances within 1e-5 relative +
1e-3. FAST runs
the JAX package's Pallas kernels in interpret mode and the port's plain
versions: ids identical except rows within 1e-3 relative of a window bound
and swaps of distances within that of each other (as assert_same_topk
defines near-ties). The covering exact pass (_full_sorted) runs with
DEVICE_K_MAX patched small in both packages. The checks of
tests/test_range_search_matrix.py, test_iterator_semantics.py and
test_iterator_streaming.py are run on the port's IVF_FLAT at the end,
copied, not imported.
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.models import ivf as tivf

from .torch_parity import assert_same_topk, build, cross_load, interpret_env, ivf_corpus, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, NLIST = 8192, 16, 128, 16
RTOL, ATOL = 1e-5, 1e-3
NEAR = 1e-3  # FAST: relative distance within which a bound or a tie may flip
TIE = 1e-6  # EXACT: two distances this close (a few f32 ulps) may swap
VARIANTS = {
    "IVF_FLAT": {"nlist": NLIST},
    "IVF_PQ": {"nlist": NLIST, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"},
    "IVF_SQ8": {"nlist": NLIST},
    "IVF_RABITQ": {"nlist": NLIST},
}
RAW = {"IVF_FLAT": True, "IVF_PQ": False, "IVF_SQ8": False, "IVF_RABITQ": False}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


@pytest.fixture(scope="module")
def corpus():
    xb, xq, _ = ivf_corpus(NB, NQ, DIM, 10)
    return xb, xq


@pytest.fixture(scope="module")
def pair(corpus):
    """pair(name, metric) -> (the JAX-built index, the port's cross-load)."""
    cache = {}

    def get(name, metric="L2"):
        if (name, metric) not in cache:
            j = build(kt, name, corpus[0], {"metric_type": metric, **VARIANTS[name]})
            cache[name, metric] = (j, cross_load(j, ktt))
        return cache[name, metric]

    return get


def _exact(xq, xb, metric="L2"):
    x, q = xb.astype(np.float64), xq.astype(np.float64)
    if metric == "L2":
        return (q**2).sum(1)[:, None] - 2 * q @ x.T + (x**2).sum(1)[None]
    if metric == "COSINE":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    return q @ x.T


def _between(d_all, qnt):
    """A bound near the qnt quantile of d_all at least 1e-5 of its magnitude
    from every value."""
    v = np.unique(d_all)
    i = int(np.clip(np.searchsorted(v, np.quantile(d_all, qnt)), 1, len(v) - 1))
    while v[i] - v[i - 1] <= 2e-5 * abs(v[i]):
        i += 1
    return float((v[i] + v[i - 1]) / 2)


def _csr(res):
    assert res.has_value(), res.what()
    v = res.value()
    return np.asarray(v.ids), np.asarray(v.distance), np.asarray(v.lims)


def _range(pair_, xq, cfg, bitset=None):
    j, t = pair_
    keep = bitset
    out_j = _csr(j.RangeSearch(kt.GenDataSetFromArray(xq), cfg, None if keep is None else kt.BitsetView.from_bool_array(keep)))
    out_t = _csr(t.RangeSearch(ktt.GenDataSetFromArray(xq), cfg, None if keep is None else ktt.BitsetView.from_bool_array(keep)))
    return out_j, out_t


def _assert_csr_equal(out_j, out_t):
    """lims identical; ids identical except swaps of two distances within
    TIE (relative) of each other; distances within RTOL + ATOL."""
    (i_j, d_j, l_j), (i_t, d_t, l_t) = out_j, out_t
    np.testing.assert_array_equal(l_t, l_j)
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)
    assert_same_topk(d_j, i_j, d_t, i_t, rtol=TIE, atol=0.0)


def _assert_csr_near(out_j, out_t, bounds):
    """Per query: the id sets equal except rows whose distance lies within
    NEAR (relative) of a window bound; the common rows in the same order
    except near-ties, their distances within NEAR."""
    (i_j, d_j, l_j), (i_t, d_t, l_t) = out_j, out_t
    bounds = np.array([b for b in bounds if np.isfinite(b)], np.float64)
    for q in range(len(l_j) - 1):
        a_i, a_d = i_j[l_j[q] : l_j[q + 1]], d_j[l_j[q] : l_j[q + 1]]
        b_i, b_d = i_t[l_t[q] : l_t[q + 1]], d_t[l_t[q] : l_t[q + 1]]
        for ids, ds, other in ((a_i, a_d, b_i), (b_i, b_d, a_i)):
            extra = ~np.isin(ids, other)
            near = (np.abs(ds[extra, None] - bounds[None]) <= NEAR * np.abs(bounds[None])).any(1)
            assert near.all(), (q, ids[extra][~near], ds[extra][~near])
        ca, cb = np.isin(a_i, b_i), np.isin(b_i, a_i)
        assert_same_topk(a_d[ca], a_i[ca], b_d[cb], b_i[cb], rtol=NEAR, atol=0.0)


# ---------------------------------------------------------------------------
# RangeSearch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_range_search_exact_identical(corpus, pair, name):
    xb, xq = corpus
    set_precision(False)
    radius = _between(_exact(xq, xb), 0.01)
    out_j, out_t = _range(pair(name), xq, {"metric_type": "L2", "radius": radius, "nprobe": 4})
    assert out_t[2][-1] > NQ * 20
    _assert_csr_equal(out_j, out_t)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_range_search_fast_matches(corpus, pair, name):
    xb, xq = corpus
    set_precision(True)
    radius = _between(_exact(xq, xb), 0.01)
    out_j, out_t = _range(pair(name), xq, {"metric_type": "L2", "radius": radius, "nprobe": 4})
    set_precision(False)
    assert out_t[2][-1] > NQ * 20
    _assert_csr_near(out_j, out_t, [radius])


def _window_case(case, d_all, metric):
    larger = metric != "L2"
    radius = _between(d_all, 0.95 if larger else 0.05)
    cfg = {"metric_type": metric, "radius": radius, "nprobe": 4}
    if case == "two_sided":
        cfg["range_filter"] = _between(d_all, 0.995 if larger else 0.005)
    elif case == "range_search_k":
        cfg["range_search_k"] = 37
    elif case == "max_empty_result_buckets":
        cfg["max_empty_result_buckets"] = 5
    return cfg


@pytest.mark.parametrize("case", ["two_sided", "bitset", "range_search_k", "max_empty_result_buckets"])
@pytest.mark.parametrize("name,metric", [(n, "L2") for n in VARIANTS] + [("IVF_FLAT", "IP"), ("IVF_FLAT", "COSINE")])
def test_range_search_windows_exact(corpus, pair, name, metric, case):
    """Two-sided windows, a 50% bitset, range_search_k and
    max_empty_result_buckets at EXACT: identical CSR. The radius holds about
    400 rows a query, so the k rounds pass 256."""
    xb, xq = corpus
    set_precision(False)
    cfg = _window_case(case, _exact(xq, xb, metric), metric)
    keep = np.random.default_rng(1).random(NB) < 0.5 if case == "bitset" else None
    out_j, out_t = _range(pair(name, metric), xq, cfg, None if keep is None else ~keep)
    _assert_csr_equal(out_j, out_t)
    assert out_t[2][-1] > 0
    if keep is not None:
        assert keep[out_t[0]].all()
    if case == "range_search_k":
        assert (np.diff(out_t[2]) <= 37).all() and (np.diff(out_t[2]) == 37).any()


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_range_search_covering_pass(corpus, pair, name, filtered, monkeypatch):
    """A huge radius with DEVICE_K_MAX patched to 1024 in both packages: the
    rounds stop at k=1024 and the covering exact pass returns every valid row
    of every query, best first, in the JAX package's order."""
    monkeypatch.setattr(kt.index_node, "DEVICE_K_MAX", 1024)
    monkeypatch.setattr(ktt.index_node, "DEVICE_K_MAX", 1024)
    xb, xq = corpus
    set_precision(False)
    drop = np.random.default_rng(2).random(NB) < 0.5 if filtered else None
    out_j, out_t = _range(pair(name), xq[:4], {"metric_type": "L2", "radius": 1e12}, drop)
    n_valid = NB - (int(drop.sum()) if filtered else 0)
    np.testing.assert_array_equal(out_t[2], np.arange(5) * n_valid)
    for q in range(4):
        ids = out_t[0][q * n_valid : (q + 1) * n_valid]
        assert len(np.unique(ids)) == n_valid and (not filtered or not drop[ids].any())
        assert (np.diff(out_t[1][q * n_valid : (q + 1) * n_valid]) >= 0).all()
    _assert_csr_equal(out_j, out_t)


# ---------------------------------------------------------------------------
# AnnIterator
# ---------------------------------------------------------------------------


def _drain(it, n=None):
    out = []
    while it.HasNext() and (n is None or len(out) < n):
        out.append(it.Next())
    return np.array([i for i, _ in out], np.int64), np.array([d for _, d in out], np.float32)


def _iterators(pair_, xq, cfg, drop=None):
    j, t = pair_
    bs_j = kt.BitsetView.from_bool_array(drop) if drop is not None else kt.BitsetView()
    bs_t = ktt.BitsetView.from_bool_array(drop) if drop is not None else ktt.BitsetView()
    its_t = t.AnnIterator(ktt.GenDataSetFromArray(xq), cfg, bs_t)
    assert its_t.has_value(), its_t.what()
    return j.AnnIterator(kt.GenDataSetFromArray(xq), cfg, bs_j).value(), its_t.value()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_ann_iterator_first_items(corpus, pair, name, fast):
    """The first 200 items of every query's stream equal the JAX package's
    (FAST: except near-ties)."""
    _, xq = corpus
    set_precision(fast)
    its_j, its_t = _iterators(pair(name), xq[:6], {"metric_type": "L2", "nprobe": 4})
    for it_j, it_t in zip(its_j, its_t):
        i_j, d_j = _drain(it_j, 200)
        i_t, d_t = _drain(it_t, 200)
        if fast:
            assert_same_topk(d_j, i_j, d_t, i_t, rtol=NEAR, atol=0.0)
        else:
            np.testing.assert_array_equal(i_t, i_j)
            np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)
    set_precision(False)


@pytest.mark.parametrize("covering", [False, True])
def test_ann_iterator_drains_tiny_corpus(corpus, covering, monkeypatch):
    """A dense drain to exhaustion on 600 rows: every row once, the same
    stream as the JAX package's; with DEVICE_K_MAX patched to 64 the only
    round is the covering exact pass."""
    if covering:
        monkeypatch.setattr(kt.index_node, "DEVICE_K_MAX", 64)
        monkeypatch.setattr(ktt.index_node, "DEVICE_K_MAX", 64)
    xb, xq = corpus
    set_precision(False)
    j = build(kt, "IVF_FLAT", xb[:600], {"metric_type": "L2", "nlist": 8})
    its_j, its_t = _iterators((j, cross_load(j, ktt)), xq[:3], {"metric_type": "L2", "nprobe": 2})
    for it_j, it_t in zip(its_j, its_t):
        i_j, d_j = _drain(it_j)
        i_t, d_t = _drain(it_t)
        assert len(i_t) == 600 and len(np.unique(i_t)) == 600 and not it_t.HasNext()
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)


def test_ann_iterator_respects_bitset(corpus, pair):
    _, xq = corpus
    set_precision(False)
    drop = np.random.default_rng(3).random(NB) < 0.5
    its_j, its_t = _iterators(pair("IVF_FLAT"), xq[:4], {"metric_type": "L2"}, drop)
    for it_j, it_t in zip(its_j, its_t):
        i_t, _ = _drain(it_t, 300)
        assert len(i_t) == 300 and not drop[i_t].any()
        np.testing.assert_array_equal(i_t, _drain(it_j, 300)[0])


# ---------------------------------------------------------------------------
# GetVectorByIds, CalcDistByIDs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,metric", [(n, "L2") for n in VARIANTS] + [("IVF_FLAT", "COSINE")])
def test_get_vector_by_ids(corpus, pair, name, metric):
    """IVF_FLAT returns its raw rows (COSINE: the normalized rows times the
    stored norms, as the JAX package restores them); PQ, SQ and RaBitQ
    answer not_implemented, where HasRawData is false."""
    xb, _ = corpus
    j, t = pair(name, metric)
    pick = np.array([0, 5, 4095, NB - 1, 77, 5])
    res_t = t.GetVectorByIds(ktt.GenIdsDataSet(pick))
    res_j = j.GetVectorByIds(kt.GenIdsDataSet(pick))
    assert t.HasRawData(metric) == j.HasRawData(metric) == RAW[name]
    if not RAW[name]:
        assert res_t.error() == res_j.error() == ktt.Status.not_implemented
        return
    assert res_t.has_value(), res_t.what()
    got = np.asarray(res_t.value().tensor).reshape(len(pick), DIM)
    np.testing.assert_array_equal(got, np.asarray(res_j.value().tensor).reshape(len(pick), DIM))
    np.testing.assert_allclose(got, xb[pick], rtol=1e-5, atol=1e-5)
    assert t.GetVectorByIds(ktt.GenIdsDataSet(np.array([NB]))).error() == ktt.Status.invalid_args


def test_get_vector_by_ids_port_build(corpus):
    """The port's own IVF_FLAT build keeps the input rows bit for bit."""
    xb, _ = corpus
    idx = _port_ivf(xb, "L2", nlist=NLIST)
    pick = np.array([3, 0, NB - 1, 1234])
    got = np.asarray(idx.GetVectorByIds(ktt.GenIdsDataSet(pick)).value().tensor).reshape(len(pick), DIM)
    np.testing.assert_array_equal(got, xb[pick].astype(np.float32))


@pytest.mark.parametrize("name,metric", [(n, "L2") for n in VARIANTS] + [("IVF_FLAT", "IP"), ("IVF_FLAT", "COSINE")])
def test_calc_dist_by_ids(corpus, pair, name, metric):
    """Exact distances to the raw (IVF_FLAT) or refine rows (IVF_PQ's FP16,
    IVF_RABITQ's raw), as the JAX package scores them; IVF_SQ8 without a
    refine store answers not_implemented."""
    _, xq = corpus
    j, t = pair(name, metric)
    ids = np.random.default_rng(4).choice(NB, 50, replace=False)
    d_t = t.CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, ids, len(ids))
    d_j = j.CalcDistByIDs(kt.GenDataSetFromArray(xq), None, ids, len(ids))
    if name == "IVF_SQ8":
        assert d_t.error() == d_j.error() == ktt.Status.not_implemented
        return
    assert d_t.has_value(), d_t.what()
    assert d_t.value().shape == (NQ, len(ids))
    np.testing.assert_allclose(d_t.value(), np.asarray(d_j.value()), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Query blocks of wide scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_query_blocks_bit_identical(corpus, pair, name, fast, monkeypatch):
    """With the rerank at 3 queries a step in both runs, SCAN_BLOCK_BYTES
    patched to 1 byte scans one rerank step a block (one query where nothing
    re-ranks): Search at k=10 and k=300 and RangeSearch give the same bits
    as one block."""
    xb, xq = corpus
    _, t = pair(name)
    set_precision(fast)
    radius = _between(_exact(xq, xb), 0.05)
    cfgs = [{"metric_type": "L2", "k": 10, "nprobe": 4}, {"metric_type": "L2", "k": 300, "nprobe": 4}]
    monkeypatch.setattr(tivf, "_refine_chunk", lambda *_: 3)

    def run():
        outs = []
        for cfg in cfgs:
            res = t.Search(ktt.GenDataSetFromArray(xq), cfg)
            assert res.has_value(), res.what()
            outs += [res.value().ids, res.value().distance]
        outs += list(_csr(t.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": radius})))
        return outs

    whole = run()
    calls = []
    scan = tivf.ivf_scan_search
    monkeypatch.setattr(tivf, "ivf_scan_search", lambda *a, **kw: calls.append(a[0].shape[0]) or scan(*a, **kw))
    monkeypatch.setattr(tivf, "SCAN_BLOCK_BYTES", 1)
    blocked = run()
    set_precision(False)
    assert calls and max(calls) <= 3 and len(calls) > len(xq)
    for a, b in zip(whole, blocked):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", ["IVF_FLAT", "IVF_PQ", "IVF_RABITQ"])
def test_k10_search_is_one_block(corpus, pair, name, monkeypatch):
    """At the default budgets a k=10 Search at FAST scans its whole padded
    batch in one call and re-ranks every query in one step."""
    _, xq = corpus
    _, t = pair(name)
    scans, steps = [], []
    scan, refine = tivf.ivf_scan_search, tivf.refine_topk_device
    monkeypatch.setattr(tivf, "ivf_scan_search", lambda *a, **kw: scans.append(a[0].shape[0]) or scan(*a, **kw))
    monkeypatch.setattr(
        tivf, "refine_topk_device", lambda *a, **kw: steps.append((a[2].shape[0], a[5])) or refine(*a, **kw)
    )
    set_precision(True)
    try:
        res = t.Search(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "k": 10, "nprobe": 4})
    finally:
        set_precision(False)
    assert res.has_value(), res.what()
    assert scans == [len(xq)]  # NQ = 16 is its own row ladder step
    assert len(steps) == 1 and steps[0][0] == len(xq) and steps[0][1] >= len(xq)


@pytest.mark.parametrize("k", [10, 300, 3000])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_pool_bound_holds_the_merged_pool(corpus, pair, name, fast, k):
    """ops/ivf_scan.pool_bound reads the task geometry the scan uses
    (route_geometry): past it the merged pool holds no candidate, so the
    rerank's slice of that width drops none."""
    from knowhere_tpu_torch.device import to_device
    from knowhere_tpu_torch.ops.ivf_scan import coarse_probe_host, pool_bound

    _, xq = corpus
    node = pair(name)[1].node
    set_precision(fast)
    try:
        plan = node._scan_plan(k, 1)
        probes = coarse_probe_host(node._prep_rows(xq), node._centroids, 4, node._is_l2_like())
        q = to_device(node._pad_q_host(node._prep_rows(xq)))[: len(xq)]
        if "rot_t" in node._store:
            q = q @ node._store["rot_t"]
        _, p = tivf.ivf_scan_search(
            q, node._store, probes, node._offsets, plan.k_scan, node._is_l2_like(), prec=plan.prec,
            list_lengths=node._lengths, sq_levels=node._sq_levels, sq_packed4=node._sq_packed4, route=plan.route,
        )
    finally:
        set_precision(False)
    bound = pool_bound(plan.route, node._lengths, 4, plan.k_scan)
    assert (p[:, bound:] == -1).all()
    assert (p[:, : min(bound, p.shape[1])] >= 0).sum(1).max() > 0


# ---------------------------------------------------------------------------
# The reference's range / iterator checks on the port's IVF_FLAT (copied
# from tests/test_range_search_matrix.py, test_iterator_semantics.py and
# test_iterator_streaming.py)
# ---------------------------------------------------------------------------


def _gauss(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _port_ivf(xb, metric, **cfg):
    idx = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), {"metric_type": metric, **cfg}) == ktt.Status.success
    return idx


def test_matrix_ivf_l2_windows():
    set_precision(False)
    xb, xq = _gauss(1200, 32, 101), _gauss(6, 32, 102)
    idx = _port_ivf(xb, "L2", nlist=16)
    med = float(np.median(((xq[0] - xb) ** 2).sum(1)))
    ids, d, lims = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": med}))
    assert lims.shape == (7,) and lims[-1] == len(ids) == len(d) and (d < med + 1e-3).all()
    for qi in range(6):
        for i, dd in zip(ids[lims[qi] : lims[qi + 1]][:5], d[lims[qi] : lims[qi + 1]][:5]):
            np.testing.assert_allclose(dd, ((xq[qi] - xb[i]) ** 2).sum(), rtol=2e-3, atol=1e-2)
    dall = ((xq[:, None] - xb[None]) ** 2).sum(-1)
    lo, hi = float(np.quantile(dall, 0.1)), float(np.quantile(dall, 0.5))
    _, d, _ = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": hi, "range_filter": lo}))
    assert (d < hi + 1e-3).all() and (d >= lo - 1e-3).all()


def test_matrix_ivf_ip_windows():
    set_precision(False)
    xb, xq = _gauss(1200, 32, 101), _gauss(6, 32, 102)
    idx = _port_ivf(xb, "IP", nlist=16)
    dall = xq @ xb.T
    lo, hi = float(np.quantile(dall, 0.6)), float(np.quantile(dall, 0.95))
    _, d, _ = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "IP", "radius": lo}))
    assert (d > lo - 1e-3).all()
    _, d2, _ = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "IP", "radius": lo, "range_filter": hi}))
    assert (d2 > lo - 1e-3).all() and (d2 <= hi + 1e-3).all()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_semantics_ivf_order_monotone(metric):
    set_precision(False)
    idx = _port_ivf(_gauss(1500, 48, 81), metric, nlist=16)
    its = idx.AnnIterator(ktt.GenDataSetFromArray(_gauss(4, 48, 82)), {"metric_type": metric, "nprobe": 8}, ktt.BitsetView())
    assert its.has_value(), its.what()
    for it in its.value():
        _, d = _drain(it, 50)
        assert len(d) >= 10
        assert (np.diff(d) >= -1e-4).all() if metric == "L2" else (np.diff(d) <= 1e-4).all()


def test_semantics_ivf_recall_knobs_and_bitset():
    set_precision(False)
    xb, xq = _gauss(1500, 48, 81), _gauss(4, 48, 82)
    idx = _port_ivf(xb, "L2", nlist=16)
    gt = np.argsort(((xq[:, None] - xb[None]) ** 2).sum(-1), 1)[:, :10]
    its = idx.AnnIterator(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "nprobe": 8, "retain_iterator_order": True,
                                                        "iterator_refine_ratio": 0.5}, ktt.BitsetView()).value()
    hits = 0
    for qi, it in enumerate(its):
        ids, d = _drain(it, 20)
        assert (np.diff(d) >= -1e-4).all()
        hits += len(set(ids[:10]) & set(gt[qi]))
    assert hits / 40 >= 0.6
    drop = np.random.default_rng(3).random(len(xb)) < 0.5
    its = idx.AnnIterator(ktt.GenDataSetFromArray(xq), {"metric_type": "L2"}, ktt.BitsetView.from_bool_array(drop)).value()
    for it in its:
        assert not drop[_drain(it, 40)[0]].any()


@pytest.fixture(scope="module")
def streaming():
    xb, xq = _gauss(12_000, 24, 7), _gauss(2, 24, 11)
    return xb, xq, _port_ivf(xb, "L2", nlist=64)


def test_streaming_ivf_drains_completely(streaming):
    set_precision(False)
    xb, xq, idx = streaming
    ids, _ = _drain(idx.AnnIterator(ktt.GenDataSetFromArray(xq), {"metric_type": "L2"}).value()[0])
    assert len(ids) == len(xb) and len(np.unique(ids)) == len(xb)
    head = ktt.BruteForce.Search(ktt.GenDataSetFromArray(xb), ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "k": 10})
    assert set(ids[:10]) & set(head.value().ids.reshape(2, 10)[0].tolist())
    drop = np.zeros(len(xb), dtype=bool)
    drop[::2] = True
    its = idx.AnnIterator(ktt.GenDataSetFromArray(xq), {"metric_type": "L2"}, ktt.BitsetView.from_bool_array(drop))
    ids, _ = _drain(its.value()[0])
    assert len(ids) == len(xb) // 2 and (ids % 2 == 1).all()


def test_streaming_ivf_huge_radius_and_two_sided(streaming):
    set_precision(False)
    xb, xq, idx = streaming
    ids, d, lims = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": 1e12}))
    assert lims[1] == len(xb) and lims[2] == 2 * len(xb)
    _, d, _ = _csr(idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": 1e12, "range_filter": 1.0}))
    assert (d >= 1.0).all()
