"""Typed (fp16 / bf16 / int8) and binary (bin1) HNSW on the port against the
JAX package: knowhere_tpu_torch/models/hnsw.py, ops/graph.py and
ops/graph_inline.py against knowhere_tpu's.

The corpus and queries sit on a 1/8 grid in [-8, 8] (int8: the same grid
times 8), so every row is exact in each type and every product, norm and sum
of the walks is exact in f32: the graphs, ids and distances must then equal
the JAX package's (distances to 1e-5 relative, for the cosine rows, which
are not on the grid). Each case runs the general walk and the forced inline
walk (KNOWHERE_GRAPH_INLINE=1, routed entries from k-means).

Two cases are held to something else than the JAX package's own index of
the same type: a binary JACCARD search answered by the exact scan (the
reference's HNSW swaps ids and distances there) is held to BIN_FLAT, and an
int8 L2 index on the inline walk (the reference's walk reads wrapped int8
squares as f32 bits there) to the JAX package's fp32 index over the same
values (ROADMAP Queue 3).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import graph_inline as jinline
from knowhere_tpu_torch.ops import graph as tgraph
from knowhere_tpu_torch.ops import graph_inline as tinline

from .torch_parity import cross_load

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, D, NQ, K, BITS = 1500, 64, 20, 10, 256
BUILD = {"M": 8, "efConstruction": 64}
SEARCH = {"ef": 32}
TYPES = ["fp16", "bf16", "int8"]


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((16, D)) * 2.0
    xb = _grid(cents[rng.integers(0, 16, NB)] + rng.standard_normal((NB, D)))
    xq = _grid(cents[rng.integers(0, 16, NQ)] + rng.standard_normal((NQ, D)))
    xb[0], xb[1] = -8.0, 8.0
    return xb, xq


XB, XQ = _corpus()


def typed(a, dt):
    """Grid rows as the caller holds them in ``dt`` (bf16 as ml_dtypes)."""
    if dt == "int8":
        return (a * 8).astype(np.int8)
    if dt == "fp16":
        return a.astype(np.float16)
    if dt == "bf16":
        return a.astype(ml_dtypes.bfloat16)
    return a


def _codes(seed=1):
    """Clustered 256-bit codes: 16 centres with 15% of the bits flipped."""
    rng = np.random.default_rng(seed)
    cent = rng.integers(0, 256, (16, BITS // 8)).astype(np.uint8)

    def draw(n):
        flips = np.packbits(rng.random((n, BITS)) < 0.15, axis=1, bitorder="little")
        return cent[rng.integers(0, 16, n)] ^ flips

    return draw(NB), draw(NQ)


CB, CQ = _codes()


def _ds(pkg, a, dt):
    return pkg.GenDataSet(len(a), BITS, a) if dt == "bin1" else pkg.GenDataSetFromArray(a)


def build(pkg, x, dt, metric, name="HNSW", **extra):
    idx = pkg.IndexFactory.Instance().Create(name, data_type=dt).value()
    st = idx.Build(_ds(pkg, x, dt), dict(BUILD, metric_type=metric, **extra))
    assert st == pkg.Status.success, st
    return idx


def search(idx, pkg, q, dt, metric, bitset=None, **extra):
    res = idx.Search(_ds(pkg, q, dt), dict(SEARCH, metric_type=metric, k=K, **extra), bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(q), K), res.value().distance.reshape(len(q), K)


def assert_same(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=1e-5)


@pytest.fixture(params=["general", "inline"])
def walk(request, monkeypatch):
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1" if request.param == "inline" else "auto")
    return request.param


# ---------------------------------------------------------------------------
# typed corpora
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("dt", TYPES)
def test_typed_search_matches_jax(dt, metric, walk):
    xb, xq = typed(XB, dt), typed(XQ, dt)
    tidx = build(ktt, xb, dt, metric)
    # the inline walk serves int8 L2 / IP stores; a bf16-held store (fp16,
    # bf16, any cosine corpus) falls back to the general walk, as in the
    # reference
    assert (tidx.node._inline is not None) == (walk == "inline" and dt == "int8" and metric != "COSINE")
    want_dev = torch.int8 if dt == "int8" and metric != "COSINE" else torch.bfloat16
    assert tidx.node._store["data"].dtype == want_dev
    got = search(tidx, ktt, xq, dt, metric)
    if walk == "inline" and dt == "int8" and metric == "L2":
        # the reference's int8 inline norms wrap (Queue 3): held to its fp32
        # index over the same values instead
        jidx = build(kt, xb.astype(np.float32), "fp32", metric)
        want = search(jidx, kt, xq.astype(np.float32), "fp32", metric)
    else:
        jidx = build(kt, xb, dt, metric)
        np.testing.assert_array_equal(tidx.node._graph, jidx.node._graph)
        want = search(jidx, kt, xq, dt, metric)
    if walk == "general":
        # (the general walk from routed seeds may return a repeated seed
        # twice in its top k and so fewer than k ids, as the reference does)
        assert (got[0] >= 0).all()
    assert_same(got, want)


@pytest.mark.parametrize("dt", TYPES)
def test_typed_add_after_build_matches_jax(dt):
    """An Add of <= 20% inserts into the graph (the batched insert), a larger
    one rebuilds: the graphs and results equal the JAX package's."""
    xb, xq = typed(XB, dt), typed(XQ, dt)
    out = {}
    for pkg in (kt, ktt):
        idx = build(pkg, xb[:1100], dt, "L2")
        assert idx.Add(pkg.GenDataSetFromArray(xb[1100:1300]), {"metric_type": "L2"}) == pkg.Status.success
        first = search(idx, pkg, xq, dt, "L2"), np.array(idx.node._graph)
        assert idx.Add(pkg.GenDataSetFromArray(xb[1300:]), {"metric_type": "L2"}) == pkg.Status.success
        out[pkg] = first, (search(idx, pkg, xq, dt, "L2"), np.array(idx.node._graph)), idx
    (s_j, g_j), (s2_j, g2_j), jidx = out[kt]
    (s_t, g_t), (s2_t, g2_t), tidx = out[ktt]
    assert g_t.shape == (1300, 16) and tidx.Count() == NB
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(g2_t, g2_j)
    assert_same(s_t, s_j)
    assert_same(s2_t, s2_j)
    got = tidx.GetVectorByIds(ktt.GenIdsDataSet(np.array([5, 1250, 1499]))).value().tensor
    np.testing.assert_array_equal(np.asarray(got).view(np.uint8), xb[[5, 1250, 1499]].view(np.uint8))


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("dt", TYPES + ["bin1"])
def test_binary_sets_cross_load_both_ways(dt, metric):
    """A BinarySet written by either package loads in the other; both then
    search alike, and read back the input rows bit for bit."""
    if dt == "bin1":
        metric = {"L2": "HAMMING", "COSINE": "JACCARD"}[metric]
        xb, xq = CB, CQ
    else:
        xb, xq = typed(XB, dt), typed(XQ, dt)
    jidx, tidx = build(kt, xb, dt, metric), build(ktt, xb, dt, metric)
    for src, dst_pkg, other in ((jidx, ktt, tidx), (tidx, kt, jidx)):
        loaded = cross_load(src, dst_pkg, dt)
        src_pkg = kt if dst_pkg is ktt else ktt
        assert_same(search(loaded, dst_pkg, xq, dt, metric), search(src, src_pkg, xq, dt, metric))
        ids = np.array([0, 7, 1499])
        got = np.asarray(loaded.GetVectorByIds(dst_pkg.GenIdsDataSet(ids)).value().tensor)
        np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8).reshape(3, -1),
                                      np.ascontiguousarray(xb[ids]).view(np.uint8).reshape(3, -1))
        assert loaded.node.data_type == dt


@pytest.mark.parametrize("dt", TYPES)
def test_typed_reads_and_range_match_jax(dt):
    """GetVectorByIds (the host rows: fp16 as float16, bf16 as its bits),
    CalcDistByIDs, RangeSearch and the iterator's first items."""
    xb, xq = typed(XB, dt), typed(XQ, dt)
    jidx, tidx = build(kt, xb, dt, "L2"), build(ktt, xb, dt, "L2")
    ids = np.array([3, 99, 1000])
    got = np.asarray(tidx.GetVectorByIds(ktt.GenIdsDataSet(ids)).value().tensor)
    assert got.dtype == {"fp16": np.float16, "bf16": np.uint16, "int8": np.int8}[dt]
    np.testing.assert_array_equal(got.view(np.uint8), xb[ids].view(np.uint8))
    dj = jidx.CalcDistByIDs(kt.GenDataSetFromArray(xq), None, ids, None).value()
    dtt = tidx.CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, ids, None).value()
    np.testing.assert_allclose(np.asarray(dtt), np.asarray(dj), rtol=1e-6)
    radius = float(np.median(search(jidx, kt, xq, dt, "L2")[1][:, 5]))
    cfg = {"metric_type": "L2", "radius": radius, "ef": 64}
    rj = jidx.RangeSearch(kt.GenDataSetFromArray(xq), cfg, kt.BitsetView()).value()
    rt = tidx.RangeSearch(ktt.GenDataSetFromArray(xq), cfg, ktt.BitsetView()).value()
    np.testing.assert_array_equal(rt.lims, rj.lims)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.distance, rj.distance, rtol=1e-6)
    itj = jidx.AnnIterator(kt.GenDataSetFromArray(xq[:2]), {"metric_type": "L2"}, kt.BitsetView()).value()
    itt = tidx.AnnIterator(ktt.GenDataSetFromArray(xq[:2]), {"metric_type": "L2"}, ktt.BitsetView()).value()
    for a, b in zip(itj, itt):
        assert [a.Next()[0] for _ in range(30)] == [b.Next()[0] for _ in range(30)]


def test_typed_filtered_and_fallback_match_jax():
    """A 40% bitset (the masked walk) and a 95% one (the exact scan)."""
    xb, xq = typed(XB, "fp16"), typed(XQ, "fp16")
    jidx, tidx = build(kt, xb, "fp16", "L2"), build(ktt, xb, "fp16", "L2")
    for ratio in (0.4, 0.95):
        drop = np.random.default_rng(3).random(NB) < ratio
        got = search(tidx, ktt, xq, "fp16", "L2", ktt.BitsetView.from_bool_array(drop))
        assert not drop[got[0][got[0] >= 0]].any()
        assert_same(got, search(jidx, kt, xq, "fp16", "L2", kt.BitsetView.from_bool_array(drop)))


# ---------------------------------------------------------------------------
# binary corpora
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_binary_search_matches_jax(metric, walk):
    """Binary HNSW never takes the inline walk; the graph, entries, ids and
    distances equal the JAX package's, unfiltered and under a 30% bitset."""
    jidx, tidx = build(kt, CB, "bin1", metric), build(ktt, CB, "bin1", metric)
    assert tidx.node._inline is None and tidx.node._raw_host is None
    np.testing.assert_array_equal(tidx.node._graph, jidx.node._graph)
    np.testing.assert_array_equal(tidx.node._entry, jidx.node._entry)
    got = search(tidx, ktt, CQ, "bin1", metric)
    assert_same(got, search(jidx, kt, CQ, "bin1", metric))
    flat = build(kt, CB, "bin1", metric, name="BIN_FLAT")
    d_true = search(flat, kt, CQ, "bin1", metric)[1]
    assert (got[1][:, 0] >= d_true[:, 0]).all()
    drop = np.random.default_rng(5).random(NB) < 0.3
    got = search(tidx, ktt, CQ, "bin1", metric, ktt.BitsetView.from_bool_array(drop))
    assert not drop[got[0]].any()
    want = search(jidx, kt, CQ, "bin1", metric, kt.BitsetView.from_bool_array(drop))
    if metric == "JACCARD":
        # a query the walk leaves short is filled by the exact scan, whose
        # JACCARD result the reference stores swapped (ids 0, distances the
        # ids): those rows are held to BIN_FLAT under the same bitset
        fids, fd = search(flat, kt, CQ, "bin1", metric, kt.BitsetView.from_bool_array(drop))
        swapped = (want[0] == 0).all(1) & (want[1] == fids).all(1)
        assert_same((got[0][swapped], got[1][swapped]), (fids[swapped], fd[swapped]))
        got, want = (got[0][~swapped], got[1][~swapped]), (want[0][~swapped], want[1][~swapped])
    assert_same(got, want)


@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_binary_dense_filter_matches_bin_flat(metric):
    """A 95% bitset: the exact scan answers, equal to BIN_FLAT (ids and
    distances; the reference's JACCARD scan here returns ids and distances
    swapped, so BIN_FLAT is the yardstick for both metrics)."""
    tidx = build(ktt, CB, "bin1", metric)
    drop = np.random.default_rng(6).random(NB) < 0.95
    got = search(tidx, ktt, CQ, "bin1", metric, ktt.BitsetView.from_bool_array(drop))
    flat = build(kt, CB, "bin1", metric, name="BIN_FLAT")
    want = search(flat, kt, CQ, "bin1", metric, kt.BitsetView.from_bool_array(drop))
    assert_same(got, want)


def test_binary_calc_dist_and_add_match_jax():
    """CalcDistByIDs scores the {0,1} rows; an Add rebuilds from the packed
    codes (a binary index never inserts into its graph)."""
    out = {}
    for pkg in (kt, ktt):
        idx = build(pkg, CB[:1200], "bin1", "HAMMING")
        assert idx.Add(pkg.GenDataSet(300, BITS, CB[1200:]), {"metric_type": "HAMMING"}) == pkg.Status.success
        res = search(idx, pkg, CQ, "bin1", "HAMMING")  # the search merges the added rows
        dist = idx.CalcDistByIDs(pkg.GenDataSet(NQ, BITS, CQ), None, np.array([1, 1400]), None).value()
        out[pkg] = idx.node._graph, res, np.asarray(dist)
    np.testing.assert_array_equal(out[ktt][0], out[kt][0])
    assert_same(out[ktt][1], out[kt][1])
    np.testing.assert_array_equal(out[ktt][2], out[kt][2])
    bits = np.unpackbits(CQ[:, None] ^ CB[None, [1, 1400]], axis=-1).sum(-1)
    np.testing.assert_array_equal(out[ktt][2].reshape(NQ, 2), bits)


def test_binary_ivf_build_route_ranks_by_ip(monkeypatch):
    """Above KNN_EXACT_MAX_ROWS the kNN graph of {0,1} rows takes the IVF
    route, which ranks every metric but L2 by IP (``is_l2 = metric ==
    "L2"``), as the reference does: under HAMMING it keeps the exact IP
    lists, not the HAMMING ones."""
    monkeypatch.setattr(tgraph, "KNN_EXACT_MAX_ROWS", 1024)
    rng = np.random.default_rng(9)
    cent = (rng.random((8, 128)) < 0.5).astype(np.float32)
    x = np.abs(cent[rng.integers(0, 8, 4096)] - (rng.random((4096, 128)) < 0.2)).astype(np.float32)
    got = tgraph._approx_knn_graph(x, 16, "HAMMING")
    x64 = x.astype(np.float64)
    ip = x64 @ x64.T
    np.fill_diagonal(ip, -np.inf)
    ham = x64.sum(1)[:, None] + x64.sum(1)[None, :] - 2 * ip
    np.fill_diagonal(ham, np.inf)

    def kept(order):
        # a list counts as kept up to ties: its members score at least the
        # exact 16th best
        kth = np.take_along_axis(order[0], order[1][:, 15:16], axis=1)
        return np.mean(order[2](np.take_along_axis(order[0], np.maximum(got, 0), axis=1), kth) & (got >= 0))

    by_ip = kept((ip, np.argsort(-ip, 1, kind="stable"), lambda s, t: s >= t))
    by_ham = kept((ham, np.argsort(ham, 1, kind="stable"), lambda s, t: s <= t))
    assert by_ip >= 0.9 and by_ham < by_ip - 0.3, (by_ip, by_ham)


# ---------------------------------------------------------------------------
# the inline table over typed rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["bf16", "int8"])
@pytest.mark.parametrize("bits", [4, 8])
def test_inline_store_over_typed_rows(dt, bits):
    """make_inline_store's raw kind over bf16 / int8 device rows: the table,
    codec and walk equal the JAX package's over the same values held in f32
    (the reference's own inline build fails on bf16 rows and reads wrapped
    int8 squares, so f32 rows are its yardstick)."""
    x = typed(XB, dt)
    vals = np.asarray(x, np.float32)
    graph = tgraph.build_graph(vals, 16, "L2", intermediate_deg=32)
    entry = tgraph.pick_entry_points(vals, n_entry=64)
    rows = torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16) if dt == "bf16" else torch.from_numpy(x)
    host = x.view(np.uint16) if dt == "bf16" else x
    ts = tinline.make_inline_store(graph, "raw", {"data": rows}, x_host=host, bits=bits)
    js = jinline.make_inline_store(graph, "raw", {"data": jnp.asarray(vals)}, x_host=vals, bits=bits)
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    np.testing.assert_array_equal(ts.vmin.numpy(), np.asarray(js.vmin))
    q = np.asarray(typed(XQ, dt), np.float32)
    kw = dict(W=2, ef=48, deg=16, n_steps=30, ring_slots=8, n_seed=8, k=10, is_l2=True, has_mask=False,
              rerank_kind="raw", bits=ts.bits)
    cents = vals[entry]
    sj, ij = jinline.beam_search_inline(js.table, jnp.asarray(q), js.rerank0, None, None, jnp.asarray(entry),
                                        jnp.asarray(cents), js.vmin, js.vdiff, None, **kw)
    st, it = tinline.beam_search_inline(ts.table, torch.from_numpy(q), ts.rerank0, None, None,
                                        torch.from_numpy(entry), torch.from_numpy(cents), ts.vmin, ts.vdiff, None, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_inline_beam_width_knob(monkeypatch):
    """KNOWHERE_INLINE_W sets the inline walk's beam width, as in the
    reference: W=1 and W=4 give the JAX package's ids at each."""
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")
    jidx, tidx = build(kt, XB, "fp32", "L2"), build(ktt, XB, "fp32", "L2")
    assert tidx.node._inline is not None
    for w in ("1", "4"):
        monkeypatch.setenv("KNOWHERE_INLINE_W", w)
        assert_same(search(tidx, ktt, XQ, "fp32", "L2"), search(jidx, kt, XQ, "fp32", "L2"))


def test_int8_l2_inline_reference_fault_recorded(monkeypatch, capsys):
    """ROADMAP Queue 3: on the inline walk over an int8 L2 store the
    reference squares the int8 rows in int8 (wrapping), sums them to int32
    and reads those words as f32 norms, so its walk and rerank scores are
    off; the port takes the norms of the values. Both recalls@10 against the
    exact answer are printed (pytest -s) and the port's must hold."""
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")
    xb, xq = typed(XB, "int8"), typed(XQ, "int8")
    b, q = xb.astype(np.float64), xq.astype(np.float64)
    gt = np.argsort((q**2).sum(1)[:, None] - 2 * q @ b.T + (b**2).sum(1)[None], 1, kind="stable")[:, :K]
    rec = {}
    for pkg in (kt, ktt):
        ids, _ = search(build(pkg, xb, "int8", "L2"), pkg, xq, "int8", "L2")
        rec[pkg.__name__] = float(np.mean([len(set(ids[i]) & set(gt[i])) / K for i in range(NQ)]))
    with capsys.disabled():
        print(f"\nint8 L2 inline walk, {NB} x {D}, M=8, ef=32: recall@10 {rec}")
    assert rec["knowhere_tpu_torch"] >= 0.9 and rec["knowhere_tpu"] < rec["knowhere_tpu_torch"] - 0.3
