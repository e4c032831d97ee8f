"""Binary metrics, BIN_FLAT, BruteForce over bin1 rows and BIN_IVF_FLAT: the
port against the JAX package on the same seeded bits.

The distances are small integers (HAMMING, SUBSTRUCTURE, SUPERSTRUCTURE) or
ratios of them (JACCARD), exact in f32 on both sides, so a query's top k
holds many exact ties: ids and distances must be equal exactly, ties
included. BIN_IVF_FLAT is built by the JAX package and cross-loaded; under
FAST its HAMMING search runs the JAX package's f32 scan kernel in interpret
mode and the port's f32 scan (the single bf16 pass over {0,1} rows), its
JACCARD search the plain scan on both sides.
"""

import numpy as np
import pytest
import torch

import jax

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import distances as JD
from knowhere_tpu_torch.ops import distances as TD
from knowhere_tpu_torch.ops import ivf_scan as tscan

from .torch_parity import cross_load, interpret_env, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, BITS, K, NLIST = 4000, 24, 256, 10, 16
METRICS = ["HAMMING", "JACCARD", "SUBSTRUCTURE", "SUPERSTRUCTURE"]


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env(align_min=2048)  # aligned lists at NB rows: the f32 scan kernel serves


def _bits(n, bits=BITS, seed=0, density=0.5):
    """Packed rows (n, bits / 8) uint8, each bit set with ``density``."""
    rng = np.random.default_rng(seed)
    return np.packbits(rng.random((n, bits)) < density, axis=1, bitorder="little")


def _ds(pkg, x, bits=BITS):
    return pkg.GenDataSet(x.shape[0], bits, x)


def _search(idx, pkg, xq, cfg, bitset=None, bits=BITS):
    res = idx.Search(_ds(pkg, xq, bits), cfg, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(xq), -1), res.value().distance.reshape(len(xq), -1)


def _assert_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def data():
    return _bits(NB, seed=1), _bits(NQ, seed=2)


# ---------------------------------------------------------------------------
# ops/distances.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [64, 100])
def test_unpack_bits_host_matches_jax(bits):
    x = _bits(50, bits=-(-bits // 8) * 8, seed=3)
    got = TD.unpack_bits_host(x, bits)
    np.testing.assert_array_equal(got, JD.unpack_bits_host(x, bits))
    assert got.dtype == np.int8 and got.shape == (50, bits)
    np.testing.assert_array_equal(got[:, :8], (x[:, :1] >> np.arange(8)) & 1)  # LSB first


@pytest.mark.parametrize("metric", METRICS)
def test_binary_distances_match_jax(metric):
    q = TD.unpack_bits_host(_bits(40, seed=4, density=0.3), BITS)
    b = TD.unpack_bits_host(_bits(300, seed=5, density=0.3), BITS)
    b[:3] = 0  # empty rows: JACCARD's empty union
    q[:2] = 0
    want = np.asarray(JD.pairwise_distance(metric, jax.numpy.asarray(q), jax.numpy.asarray(b),
                                           JD.base_aux(metric, jax.numpy.asarray(b))))
    bt = torch.from_numpy(b)
    got = TD.pairwise_distance(metric, torch.from_numpy(q), bt, TD.base_aux(metric, bt)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TD.pairwise_distance(metric, torch.from_numpy(q), bt).numpy(), want)
    assert TD.is_binary_metric(metric) and not TD.larger_is_better(metric)


# ---------------------------------------------------------------------------
# BIN_FLAT and BruteForce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [1000, 4096])  # a tile of plain top-k, a tile of 64-row groups
@pytest.mark.parametrize("metric", METRICS)
def test_bin_flat_search_matches_jax(metric, nb):
    xb, xq = _bits(nb, seed=6), _bits(NQ, seed=7)
    cfg = {"metric_type": metric, "k": K}
    out = []
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create("BIN_FLAT", data_type="bin1").value()
        assert idx.Build(_ds(pkg, xb), cfg) == pkg.Status.success
        drop = np.random.default_rng(8).random(nb) < 0.3
        out.append((_search(idx, pkg, xq, cfg), _search(idx, pkg, xq, cfg, pkg.BitsetView.from_bool_array(drop))))
    _assert_equal(out[0][0], out[1][0])
    _assert_equal(out[0][1], out[1][1])


def test_bin_flat_range_iterator_by_ids_match_jax(data):
    xb, xq = data
    cfg = {"metric_type": "HAMMING", "k": K, "radius": 112.0}
    idx = {}
    for pkg in (kt, ktt):
        idx[pkg] = pkg.IndexFactory.Instance().Create("BINFLAT", data_type="bin1").value()
        assert idx[pkg].Build(_ds(pkg, xb), cfg) == pkg.Status.success
    rj, rt = (idx[p].RangeSearch(_ds(p, xq), cfg, p.BitsetView()).value() for p in (kt, ktt))
    np.testing.assert_array_equal(rt.lims, rj.lims)
    assert rt.lims[-1] > 0
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_array_equal(rt.distance, rj.distance)
    its_j, its_t = (idx[p].AnnIterator(_ds(p, xq[:3]), cfg, p.BitsetView()).value() for p in (kt, ktt))
    for it_j, it_t in zip(its_j, its_t):
        assert [it_t.Next() for _ in range(30)] == [it_j.Next() for _ in range(30)]
    ids = np.array([0, 17, NB - 1])
    got = idx[ktt].GetVectorByIds(ktt.GenIdsDataSet(ids)).value().tensor
    np.testing.assert_array_equal(got, xb[ids])
    dj = idx[kt].CalcDistByIDs(_ds(kt, xq), None, ids, None).value()
    dt = idx[ktt].CalcDistByIDs(_ds(ktt, xq), None, ids, None).value()
    np.testing.assert_array_equal(dt, dj)
    assert idx[ktt].Search(_ds(ktt, xq), {"metric_type": "L2", "k": K}).error() == ktt.Status.invalid_metric_type
    # the round trip keeps the packed rows and the answers
    back = cross_load(idx[ktt], ktt, "bin1")
    _assert_equal(_search(back, ktt, xq, cfg), _search(idx[ktt], ktt, xq, cfg))
    np.testing.assert_array_equal(cross_load(idx[ktt], kt, "bin1").node._xb, xb)


@pytest.mark.parametrize("call", ["Search", "RangeSearch", "AnnIterator", "SearchOnChunkWithBuf", "AnnIteratorOnChunk"])
@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_brute_force_binary_matches_jax(data, metric, call):
    xb, xq = data
    radius = 112.0 if metric == "HAMMING" else 0.62
    cfg = {"metric_type": metric, "k": K, "radius": radius}
    drop = np.random.default_rng(9).random(NB) < 0.25
    res = {}
    for pkg in (kt, ktt):
        bs = pkg.BitsetView.from_bool_array(drop)
        base, q = _ds(pkg, xb), _ds(pkg, xq)
        chunks = [_ds(pkg, xb[:1500]), _ds(pkg, xb[1500:])]
        if call == "SearchOnChunkWithBuf":
            ids, dist = np.empty(NQ * K, np.int64), np.empty(NQ * K, np.float32)
            assert pkg.BruteForce.SearchOnChunkWithBuf(chunks, q, ids, dist, cfg, bs) == pkg.Status.success
            res[pkg] = (ids, dist)
        elif call in ("AnnIterator", "AnnIteratorOnChunk"):
            its = getattr(pkg.BruteForce, call)(chunks if call.endswith("Chunk") else base, q, cfg, bs)
            assert its.has_value(), its.what()
            res[pkg] = [[it.Next() for _ in range(25)] for it in its.value()[:4]]
        else:
            r = getattr(pkg.BruteForce, call)(base, q, cfg, bs)
            assert r.has_value(), r.what()
            r = r.value()
            res[pkg] = (r.ids, r.distance, r.lims if call == "RangeSearch" else None)
    if call.startswith("AnnIterator"):
        assert res[ktt] == res[kt]
        return
    for a, b in zip(res[kt], res[ktt]):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# BIN_IVF_FLAT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["HAMMING", "JACCARD"])
def bin_ivf(request, data):
    """(metric, the JAX-built index, the port holding its BinarySet)."""
    xb, _ = data
    jidx = kt.IndexFactory.Instance().Create("BIN_IVF_FLAT", data_type="bin1").value()
    assert jidx.Build(_ds(kt, xb), {"metric_type": request.param, "nlist": NLIST}) == kt.Status.success
    return request.param, jidx, cross_load(jidx, ktt, "bin1")


@pytest.mark.parametrize("fast", [False, True])
def test_bin_ivf_flat_search_matches_jax(data, bin_ivf, fast, monkeypatch):
    """Ids and distances equal exactly, ties included; FAST HAMMING takes the
    f32 scan (one bf16 pass), JACCARD and EXACT the plain scan."""
    _, xq = data
    metric, jidx, tidx = bin_ivf
    assert tidx.node._store["data"].dtype == torch.float32 and "i8_nrm" not in tidx.node._store
    hits = []
    orig = tscan._f32_search
    monkeypatch.setattr(tscan, "_f32_search", lambda *a, **kw: hits.append(kw["three_pass"]) or orig(*a, **kw))
    set_precision(fast)
    drop = np.random.default_rng(10).random(NB) < 0.4
    for nprobe in (4, NLIST):
        cfg = {"metric_type": metric, "k": K, "nprobe": nprobe}
        got = _search(tidx, ktt, xq, cfg)
        _assert_equal(got, _search(jidx, kt, xq, cfg))
        assert (got[0] >= 0).all()
        bj, bt = kt.BitsetView.from_bool_array(drop), ktt.BitsetView.from_bool_array(drop)
        _assert_equal(_search(tidx, ktt, xq, cfg, bt), _search(jidx, kt, xq, cfg, bj))
    assert hits == ([False] * 4 if fast and metric == "HAMMING" else [])  # one bf16 pass, full probe too
    if metric == "HAMMING":
        xb = TD.unpack_bits_host(data[0], BITS)
        d = (TD.unpack_bits_host(xq, BITS)[:, None, :] != xb[None]).sum(-1)
        ids, dist = got
        np.testing.assert_array_equal(dist, np.take_along_axis(d, ids, 1))


def test_bin_ivf_flat_range_iterator_by_ids_match_jax(data, bin_ivf):
    xb, xq = data
    metric, jidx, tidx = bin_ivf
    set_precision(False)
    cfg = {"metric_type": metric, "nprobe": 8, "radius": 112.0 if metric == "HAMMING" else 0.62}
    rj, rt = jidx.RangeSearch(_ds(kt, xq), cfg, kt.BitsetView()).value(), tidx.RangeSearch(
        _ds(ktt, xq), cfg, ktt.BitsetView()
    ).value()
    np.testing.assert_array_equal(rt.lims, rj.lims)
    assert rt.lims[-1] > 0
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_array_equal(rt.distance, rj.distance)
    its_j, its_t = (i.AnnIterator(_ds(p, xq[:3]), cfg, p.BitsetView()).value() for i, p in ((jidx, kt), (tidx, ktt)))
    for it_j, it_t in zip(its_j, its_t):
        assert [it_t.Next() for _ in range(20)] == [it_j.Next() for _ in range(20)]
    ids = np.array([3, 99, NB - 1])
    assert tidx.HasRawData(metric) and jidx.HasRawData(metric)
    np.testing.assert_array_equal(tidx.GetVectorByIds(ktt.GenIdsDataSet(ids)).value().tensor, xb[ids])
    # the reference keeps no "data" or "refine" payload for bits: not_implemented in both
    assert tidx.CalcDistByIDs(_ds(ktt, xq), None, ids, None).error() == ktt.Status.not_implemented
    assert jidx.CalcDistByIDs(_ds(kt, xq), None, ids, None).error() == kt.Status.not_implemented


def test_bin_ivf_flat_port_build_cross_loads(data):
    """The port's own Build: snapped {0,1} centroids, recall against the
    exact HAMMING answer, and its BinarySet searched by the JAX package
    gives the same answers."""
    xb, xq = data
    set_precision(True)
    idx = ktt.IndexFactory.Instance().Create("IVFBIN", data_type="bin1").value()
    assert idx.Build(_ds(ktt, xb), {"metric_type": "HAMMING", "nlist": NLIST}) == ktt.Status.success
    assert set(np.unique(idx.node._centroids)) <= {0.0, 1.0}
    cfg = {"metric_type": "HAMMING", "k": K, "nprobe": 8}
    got = _search(idx, ktt, xq, cfg)
    _assert_equal(got, _search(cross_load(idx, kt, "bin1"), kt, xq, cfg))
    d = (TD.unpack_bits_host(xq, BITS)[:, None, :] != TD.unpack_bits_host(xb, BITS)[None]).sum(-1)
    kth = np.sort(d, 1)[:, K - 1 : K]
    assert (np.take_along_axis(d, got[0], 1) <= kth).mean() >= 0.5  # tie-aware recall
