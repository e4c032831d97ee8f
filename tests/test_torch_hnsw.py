"""HNSW family on the port: the public-API behaviour of tests/test_hnsw.py and
tests/test_graph_inline.py, run against knowhere_tpu_torch on the CPU, and
BinarySets cross-loaded between the port and the JAX package.

Cross-loads: HNSW / HNSW_SQ / HNSW_PQ / HNSW_PRQ x L2 / IP / COSINE, with the
inline walk forced (KNOWHERE_GRAPH_INLINE=1, routed entries from k-means) and
without it. An index built by one package is loaded by the other and both
search the same queries; the ids must agree on >= 99% of slots (the walks
sum exact-valued products in other orders, so a near tie may flip).
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

from .torch_parity import cross_load
from .utils import KNN_RECALL_THRESHOLD, brute_force_gt, knn_recall

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 2000, 10, 64, 10


def ds(x):
    return ktt.GenDataSetFromArray(np.asarray(x, np.float32))


def gen(rows, dim, seed):
    return np.random.default_rng(seed).standard_normal((rows, dim), dtype=np.float32)


def bitset(n, ratio, seed=7):
    return ktt.BitsetView.from_bool_array(np.random.default_rng(seed).random(n) < ratio)


def build(name, x, cfg, pkg=ktt):
    idx = pkg.IndexFactory.Instance().Create(name).value()
    st = idx.Build(pkg.GenDataSetFromArray(np.asarray(x, np.float32)), cfg)
    assert st == pkg.Status.success, st
    return idx


def ids_of(res, nq, k=K):
    assert res.has_value(), res.what()
    return np.asarray(res.value().ids).reshape(nq, k)


@pytest.fixture(scope="module")
def base():
    return ds(gen(NB, DIM, 61))


@pytest.fixture(scope="module")
def queries():
    return ds(gen(NQ, DIM, 62))


@pytest.fixture(scope="module")
def hnsw_l2(base):
    return build("HNSW", base.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 200})


@pytest.fixture()
def force_inline(monkeypatch):
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")


CONFIGS = [
    ("HNSW", {"M": 16, "efConstruction": 200}, {"ef": 64}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "SQ8"}, {"ef": 64, "refine_k": 4}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "SQ6"}, {"ef": 96, "refine_k": 4}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "SQ4"}, {"ef": 96, "refine_k": 8}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "FP16"}, {"ef": 64, "refine_k": 4}),
    ("HNSW_PQ", {"M": 16, "efConstruction": 200, "m": 16}, {"ef": 96, "refine_k": 8}),
    ("HNSW_PRQ", {"M": 16, "efConstruction": 200, "m": 8, "nrq": 2}, {"ef": 96, "refine_k": 8}),
]


# ---------------------------------------------------------------------------
# public API (tests/test_hnsw.py against the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tcfg,scfg", CONFIGS)
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_recall(base, queries, name, tcfg, scfg, metric):
    idx = build(name, base.tensor, {"metric_type": metric, **tcfg})
    ids = ids_of(idx.Search(queries, {"metric_type": metric, "k": K, **scfg}), NQ)
    gt, _ = brute_force_gt(base, queries, metric, K)
    assert knn_recall(gt, ids, NQ, K) >= KNN_RECALL_THRESHOLD


def test_high_ef_high_recall(base, queries, hnsw_l2):
    ids = ids_of(hnsw_l2.Search(queries, {"metric_type": "L2", "k": K, "ef": 200}), NQ)
    assert knn_recall(brute_force_gt(base, queries, "L2", K)[0], ids, NQ, K) >= 0.9


def test_cosine(base, queries):
    idx = build("HNSW", base.tensor, {"metric_type": "COSINE", "M": 16, "efConstruction": 200})
    ids = ids_of(idx.Search(queries, {"metric_type": "COSINE", "k": K, "ef": 96}), NQ)
    assert knn_recall(brute_force_gt(base, queries, "COSINE", K)[0], ids, NQ, K) >= KNN_RECALL_THRESHOLD


def test_filtered(base, queries, hnsw_l2):
    bs = bitset(NB, 0.4)
    ids = ids_of(hnsw_l2.Search(queries, {"metric_type": "L2", "k": K, "ef": 96}, bs), NQ)
    assert not any(bs.test(int(i)) for i in ids[ids >= 0])
    gt, _ = brute_force_gt(base, queries, "L2", K, bs)
    assert knn_recall(gt, ids, NQ, K) >= KNN_RECALL_THRESHOLD


def test_dense_filter_brute_force_fallback(base, queries, hnsw_l2):
    filtered = np.ones(NB, bool)
    filtered[:40] = False  # 98% filtered: the exact-scan fallback
    bs = ktt.BitsetView.from_bool_array(filtered)
    ids = ids_of(hnsw_l2.Search(queries, {"metric_type": "L2", "k": K, "ef": 32}, bs), NQ)
    assert (ids >= 0).all() and (ids < 40).all()
    assert knn_recall(brute_force_gt(base, queries, "L2", K, bs)[0], ids, NQ, K) >= 0.99


def test_ef_defaults_from_k(queries, hnsw_l2):
    ids = ids_of(hnsw_l2.Search(queries, {"metric_type": "L2", "k": 50}), NQ, 50)
    assert (ids[:, 0] >= 0).all()


def test_metric_mismatch(base, queries):
    idx = build("HNSW", base.tensor, {"metric_type": "L2", "M": 16})
    assert idx.Search(queries, {"metric_type": "IP", "k": K}).error() == ktt.Status.invalid_metric_type


def test_range_search(base, queries, hnsw_l2):
    _, gt_d = brute_force_gt(base, queries, "L2", 60)
    radius = float(np.median(gt_d[:, 30]))
    res = hnsw_l2.RangeSearch(queries, {"metric_type": "L2", "radius": radius, "ef": 128})
    assert res.has_value(), res.what()
    assert res.value().lims[-1] > 0 and (res.value().distance < radius + 1e-3).all()


def test_iterator(queries, hnsw_l2):
    res = hnsw_l2.AnnIterator(queries, {"metric_type": "L2"})
    assert res.has_value(), res.what()
    it, prev, seen = res.value()[0], -np.inf, set()
    for _ in range(200):
        assert it.HasNext()
        i, d = it.Next()
        assert d >= prev - 1e-5 and i not in seen
        seen.add(i)
        prev = d


def test_serialize_roundtrip(base, queries):
    idx = build("HNSW", base.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 128})
    again = cross_load(idx, ktt)
    cfg = {"metric_type": "L2", "k": K, "ef": 64}
    np.testing.assert_array_equal(ids_of(idx.Search(queries, cfg), NQ), ids_of(again.Search(queries, cfg), NQ))


def test_get_vector_and_calc_dist(base, hnsw_l2):
    assert hnsw_l2.HasRawData("L2")
    ids = np.array([1, 42, 1999])
    res = hnsw_l2.GetVectorByIds(ktt.GenIdsDataSet(ids))
    np.testing.assert_allclose(res.value().tensor, np.asarray(base.tensor)[ids], rtol=1e-6)
    q = np.asarray(base.tensor)[:3]
    dd = hnsw_l2.CalcDistByIDs(ds(q), ktt.BitsetView(), ids, len(ids))
    assert dd.has_value(), dd.what()
    want = ((q[:, None] - np.asarray(base.tensor)[ids][None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(dd.value()).reshape(3, 3), want, rtol=1e-4, atol=1e-3)


def test_index_meta_not_ported(hnsw_l2):
    """GetIndexMeta (named when the port had none): the overview JSON equals
    the JAX package's for the same BinarySet."""
    meta = hnsw_l2.GetIndexMeta({"overview_levels": 2})
    assert meta.has_value(), meta.what()
    want = cross_load(hnsw_l2, kt).GetIndexMeta({"overview_levels": 2}).value().get("json_info")
    assert meta.value().get("json_info") == want


def _gt_all(xall, q):
    return np.argsort(((q[:, None] - xall[None]) ** 2).sum(-1), 1)[:, :K]


def test_incremental_add_rebuilds(queries):
    x1, x2 = gen(800, DIM, 63), gen(400, DIM, 64)
    idx = build("HNSW", x1, {"metric_type": "L2", "M": 16, "efConstruction": 128})
    assert idx.Add(ds(x2), {"metric_type": "L2"}) == ktt.Status.success
    assert idx.Count() == 1200
    ids = ids_of(idx.Search(queries, {"metric_type": "L2", "k": K, "ef": 96}), NQ)
    gt = _gt_all(np.concatenate([x1, x2]), np.asarray(queries.tensor))
    assert knn_recall(gt, ids, NQ, K) >= KNN_RECALL_THRESHOLD


def test_incremental_insert_no_rebuild(queries):
    """<= 20% growth inserts without a rebuild (batched walk + prune +
    reverse-edge repair)."""
    x1, x2 = gen(2000, DIM, 65), gen(200, DIM, 66)
    idx = build("HNSW", x1, {"metric_type": "L2", "M": 16, "efConstruction": 128})
    graph_before = idx.node._graph
    assert idx.Add(ds(x2), {"metric_type": "L2"}) == ktt.Status.success
    assert idx.Count() == 2200
    ids = ids_of(idx.Search(queries, {"metric_type": "L2", "k": K, "ef": 96}), NQ)
    assert idx.node._graph.shape[0] == 2200
    assert (idx.node._graph[:2000] == graph_before).mean() > 0.5  # old rows kept, not rebuilt
    assert knn_recall(_gt_all(np.concatenate([x1, x2]), np.asarray(queries.tensor)), ids, NQ, K) >= KNN_RECALL_THRESHOLD
    top1 = ids_of(idx.Search(ds(x2[:8]), {"metric_type": "L2", "k": 1, "ef": 96}), 8, 1).reshape(-1)
    assert (top1 >= 2000).mean() >= 0.75, top1


@pytest.mark.parametrize("name,extra", [
    ("HNSW_SQ", {"sq_type": "SQ8"}), ("HNSW_SQ", {"sq_type": "SQ4"}), ("HNSW_SQ", {"sq_type": "FP16"}),
    ("HNSW_PQ", {"m": 8, "nbits": 8}),
])
def test_incremental_insert_quantized(name, extra):
    """Added rows are encoded with the trained codecs and appended to the
    refine store; they are searchable and their raw rows survive."""
    x1, x2 = gen(2000, DIM, 67), gen(200, DIM, 68)
    idx = build(name, x1, {"metric_type": "L2", "M": 16, "efConstruction": 128, **extra})
    assert idx.Add(ds(x2), {"metric_type": "L2"}) == ktt.Status.success
    assert idx.Count() == 2200
    top1 = ids_of(idx.Search(ds(x2[:8]), {"metric_type": "L2", "k": 1, "ef": 96, "refine_k": 4}), 8, 1).reshape(-1)
    assert (top1 >= 2000).mean() >= 0.6, top1
    res = idx.GetVectorByIds(ktt.GenIdsDataSet(np.array([2100])))
    np.testing.assert_allclose(np.asarray(res.value().tensor).reshape(-1), x2[100], rtol=1e-6)


def test_incremental_insert_cosine():
    x1, x2 = gen(2000, DIM, 69), gen(200, DIM, 70)
    idx = build("HNSW", x1, {"metric_type": "COSINE", "M": 16, "efConstruction": 128})
    assert idx.Add(ds(x2), {"metric_type": "COSINE"}) == ktt.Status.success
    top1 = ids_of(idx.Search(ds(x2[:8]), {"metric_type": "COSINE", "k": 1, "ef": 96}), 8, 1).reshape(-1)
    assert (top1 >= 2000).mean() >= 0.75, top1


def test_mv_hints_trigger_earlier_fallback():
    xb, xq = gen(1500, 32, 67), gen(4, 32, 68)
    idx = build("HNSW", xb, {"metric_type": "L2", "M": 8, "efConstruction": 64})
    filtered = np.zeros(1500, bool)
    filtered[:900] = True  # 60%: above the hint's threshold, below the default
    bs = ktt.BitsetView.from_bool_array(filtered)
    mv = {"field_id_to_touched_categories_cnt": {"101": 1}, "is_pure_and": True, "has_not": False}
    res = idx.Search(ds(xq), {"metric_type": "L2", "k": 5, "ef": 16, "materialized_view_search_info": mv}, bs)
    gt, _ = brute_force_gt(ds(xb), ds(xq), "L2", 5, bs)
    assert (ids_of(res, 4, 5) == gt).mean() >= 0.95


def test_recall_non_decreasing_in_ef():
    """Ids stay unique within a row and recall does not fall as ef grows."""
    rng = np.random.default_rng(71)
    centers = rng.standard_normal((10, 32)).astype(np.float32) * 15
    xb = centers[rng.integers(0, 10, 4000)] + rng.standard_normal((4000, 32)).astype(np.float32)
    xq = xb[rng.choice(4000, 8, replace=False)] + 0.01
    gt = np.argsort(((xq[:, None] - xb[None]) ** 2).sum(-1), 1)[:, :K]
    idx = build("HNSW", xb, {"metric_type": "L2", "M": 12, "efConstruction": 100})
    recalls = []
    for ef in (16, 64, 192):
        ids = ids_of(idx.Search(ds(xq), {"metric_type": "L2", "k": K, "ef": ef}), 8)
        for row in ids:
            assert len(set(row[row >= 0])) == (row >= 0).sum()
        recalls.append(knn_recall(gt, ids, 8, K))
    assert recalls[-1] >= 0.9 and recalls[1] >= recalls[0] - 0.05 and recalls[2] >= recalls[1] - 0.05, recalls


def test_sq4_halves_code_storage():
    x = gen(2000, DIM, 90)
    i8 = build("HNSW_SQ", x, {"metric_type": "L2", "M": 8, "efConstruction": 80, "sq_type": "SQ8"})
    i4 = build("HNSW_SQ", x, {"metric_type": "L2", "M": 8, "efConstruction": 80, "sq_type": "SQ4"})
    assert i4.node._payload["codes"].nbytes * 2 == i8.node._payload["codes"].nbytes
    cfg = {"metric_type": "L2", "k": K, "ef": 64}
    np.testing.assert_array_equal(ids_of(i4.Search(ds(x[:8]), cfg), 8), ids_of(cross_load(i4, ktt).Search(ds(x[:8]), cfg), 8))


# ---------------------------------------------------------------------------
# the inline walk (tests/test_graph_inline.py against the port)
# ---------------------------------------------------------------------------

IB, IQ = 2048, 10


@pytest.fixture(scope="module")
def ibase():
    return ds(gen(IB, DIM, 71))


@pytest.fixture(scope="module")
def iqueries():
    return ds(gen(IQ, DIM, 72))


@pytest.mark.parametrize("name,tcfg", [
    ("HNSW", {"M": 16, "efConstruction": 200}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "SQ8"}),
    ("HNSW_PQ", {"M": 16, "efConstruction": 200, "m": 16}),
    ("HNSW_PRQ", {"M": 16, "efConstruction": 200, "m": 8, "nrq": 2}),
])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_inline_recall_and_active(force_inline, ibase, iqueries, name, tcfg, metric):
    idx = build(name, ibase.tensor, {"metric_type": metric, **tcfg})
    assert idx.node._inline is not None
    ids = ids_of(idx.Search(iqueries, {"metric_type": metric, "k": K, "ef": 64}), IQ)
    assert knn_recall(brute_force_gt(ibase, iqueries, metric, K)[0], ids, IQ, K) >= KNN_RECALL_THRESHOLD


@pytest.fixture(scope="module")
def inline_l2(ibase):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KNOWHERE_GRAPH_INLINE", "1")
        idx = build("HNSW", ibase.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 200})
        assert idx.node._inline is not None and idx.node._inline.bits == 4  # 4-bit walk codes by default
        yield idx


def test_inline_self_top1_exact(ibase, inline_l2):
    """The exact rerank puts each row's own id first."""
    xb = np.asarray(ibase.tensor)
    ids = ids_of(inline_l2.Search(ds(xb[:8]), {"k": 5, "ef": 64}), 8, 5)
    assert (ids[:, 0] == np.arange(8)).all()


def test_inline_filtered(ibase, iqueries, inline_l2):
    excluded = set(int(g) for g in brute_force_gt(ibase, iqueries, "L2", 1)[0].reshape(-1))
    mask = np.zeros(IB, bool)
    mask[list(excluded)] = True
    ids = ids_of(inline_l2.Search(iqueries, {"metric_type": "L2", "k": K, "ef": 64},
                                  ktt.BitsetView.from_bool_array(mask)), IQ)
    assert not np.isin(ids, list(excluded)).any()


def test_inline_filtered_recall(ibase, iqueries, inline_l2):
    bs = bitset(IB, 0.3, seed=9)
    ids = ids_of(inline_l2.Search(iqueries, {"metric_type": "L2", "k": K, "ef": 64}, bs), IQ)
    assert knn_recall(brute_force_gt(ibase, iqueries, "L2", K, bs)[0], ids, IQ, K) >= KNN_RECALL_THRESHOLD


def test_inline_serialize_roundtrip(force_inline, iqueries, inline_l2):
    again = cross_load(inline_l2, ktt)
    assert again.node._inline is not None  # rebuilt at load
    np.testing.assert_array_equal(again.node._inline.table.numpy(), inline_l2.node._inline.table.numpy())
    cfg = {"k": K, "ef": 64}
    np.testing.assert_array_equal(ids_of(inline_l2.Search(iqueries, cfg), IQ), ids_of(again.Search(iqueries, cfg), IQ))


def test_inline_disabled_by_env(monkeypatch, ibase, iqueries):
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "0")
    idx = build("HNSW", ibase.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 200})
    assert idx.node._inline is None
    assert idx.Search(iqueries, {"k": K, "ef": 64}).has_value()


def test_inline_auto_gating_small_corpus(monkeypatch, ibase):
    monkeypatch.delenv("KNOWHERE_GRAPH_INLINE", raising=False)
    idx = build("HNSW", ibase.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 200})
    assert idx.node._inline is None


def test_inline_incremental_add_refreshes(force_inline, ibase):
    idx = build("HNSW", ibase.tensor, {"metric_type": "L2", "M": 16, "efConstruction": 200})
    t0 = idx.node._inline.table
    assert idx.Add(ds(gen(64, DIM, 99)), {"metric_type": "L2"}) == ktt.Status.success
    assert idx.Search(ds(gen(4, DIM, 98)), {"k": 5, "ef": 64}).has_value()
    assert idx.node._inline is not None and idx.node._inline.table.shape[0] == IB + 64
    assert idx.node._inline.table is not t0


@pytest.mark.parametrize("name,tcfg", [
    ("HNSW", {"M": 16, "efConstruction": 200}),
    ("HNSW_SQ", {"M": 16, "efConstruction": 200, "sq_type": "SQ8"}),
])
@pytest.mark.parametrize("bits", [4, 8])
def test_inline_bits_recall(monkeypatch, ibase, iqueries, name, tcfg, bits):
    from knowhere_tpu_torch.ops.graph_inline import inline_row_words

    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")
    monkeypatch.setenv("KNOWHERE_INLINE_BITS", str(bits))
    idx = build(name, ibase.tensor, {"metric_type": "L2", **tcfg})
    inline = idx.node._inline
    assert inline.bits == bits and inline.table.shape[1] == inline_row_words(inline.deg, DIM, bits)
    ids = ids_of(idx.Search(iqueries, {"metric_type": "L2", "k": K, "ef": 64}), IQ)
    assert knn_recall(brute_force_gt(ibase, iqueries, "L2", K)[0], ids, IQ, K) >= KNN_RECALL_THRESHOLD


def test_inline_dim_not_multiple_of_8_falls_back(force_inline):
    idx = build("HNSW", gen(2048, 36, 73), {"metric_type": "L2", "M": 8, "efConstruction": 80})
    assert idx.node._inline is not None and idx.node._inline.bits == 8
    assert idx.Search(ds(gen(4, 36, 74)), {"k": 5, "ef": 32}).has_value()


def test_stranded_filtered_queries_are_filled(monkeypatch, base, queries, hnsw_l2):
    """A filter the walk cannot satisfy (here 85% filtered, fallback off, a
    narrow beam) leaves rows short; they are filled by the exact scan."""
    calls = []
    brute = hnsw_l2.node._brute_force
    monkeypatch.setattr(hnsw_l2.node, "_brute_force", lambda *a: (calls.append(len(a[0])), brute(*a))[1])
    bs = bitset(NB, 0.85, seed=11)
    cfg = {"metric_type": "L2", "k": K, "ef": 10, "disable_fallback_brute_force": True}
    ids = ids_of(hnsw_l2.Search(queries, cfg, bs), NQ)
    assert (ids >= 0).all() and not any(bs.test(int(i)) for i in ids.reshape(-1))
    assert calls, "no query was left short; the fill was not exercised"


@pytest.mark.parametrize("refine_type", ["SQ8", "FP16", "BF16", "DATA_VIEW"])
def test_refine_types_cross_load(cross_data, refine_type):
    """HNSW_PQ with each refine store, built by the JAX package and loaded
    by the port: the refined ids agree (>= 99% of slots)."""
    xb, xq = cross_data
    bcfg = {"metric_type": "L2", "M": 8, "efConstruction": 64, "m": 8, "nbits": 4, "refine": True,
            "refine_type": refine_type}
    cfg = {"metric_type": "L2", "k": K, "ef": 32, "refine_k": 3}
    src = build("HNSW_PQ", xb, bcfg, pkg=kt)
    dst = cross_load(src, ktt)
    assert dst.node._refine_store is not None and dst.HasRawData("L2") == (refine_type == "DATA_VIEW")
    a = ids_of(src.Search(kt.GenDataSetFromArray(xq), cfg), XQ)
    b = ids_of(dst.Search(ktt.GenDataSetFromArray(xq), cfg), XQ)
    assert np.mean([len(set(a[i]) & set(b[i])) / K for i in range(XQ)]) >= 0.99


class TestMaskedPoolWidth:
    """The masked inline walk reranks an ef-wide valid pool, not a k-wide one:
    filtered recall at a mild ratio stays within 0.1 of unfiltered recall."""

    def test_filtered_recall_parity(self, force_inline):
        rng = np.random.default_rng(5)
        nb, d, nq, k = 4096, 64, 64, 10
        cents = (rng.standard_normal((20, d)) * 3).astype(np.float32)
        xb = (cents[rng.integers(0, 20, nb)] + rng.standard_normal((nb, d))).astype(np.float32)
        xq = (cents[rng.integers(0, 20, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
        idx = build("HNSW", xb, {"metric_type": "L2", "M": 16, "efConstruction": 200})
        assert idx.node._inline is not None
        cfg = {"metric_type": "L2", "k": k, "ef": 64, "disable_fallback_brute_force": True}
        rec_u = knn_recall(brute_force_gt(ds(xb), ds(xq), "L2", k)[0], ids_of(idx.Search(ds(xq), cfg), nq, k), nq, k)
        bs = bitset(nb, 0.2, seed=6)
        rec_f = knn_recall(brute_force_gt(ds(xb), ds(xq), "L2", k, bs)[0], ids_of(idx.Search(ds(xq), cfg, bs), nq, k),
                           nq, k)
        assert rec_f >= rec_u - 0.1, (rec_f, rec_u)


# ---------------------------------------------------------------------------
# BinarySets across the packages
# ---------------------------------------------------------------------------

XB, XQ = 1024, 16
VARIANTS = [
    ("HNSW", {}, {}),
    ("HNSW_SQ", {"sq_type": "SQ8"}, {"refine_k": 4}),
    ("HNSW_PQ", {"m": 16, "nbits": 4}, {"refine_k": 4}),
    ("HNSW_PRQ", {"m": 8, "nrq": 2, "nbits": 4}, {"refine_k": 4}),
]


@pytest.fixture(scope="module")
def cross_data():
    return gen(XB, 32, 80), gen(XQ, 32, 81)


@pytest.mark.parametrize("inline", ["1", "0"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("name,tcfg,scfg", VARIANTS)
def test_binaryset_cross_loads(monkeypatch, cross_data, name, tcfg, scfg, metric, inline):
    """JAX-built -> port and port-built -> JAX: the loaded index searches to
    the ids of the one that built it (>= 99% of slots)."""
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", inline)
    xb, xq = cross_data
    bcfg = {"metric_type": metric, "M": 8, "efConstruction": 64, **tcfg}
    cfg = {"metric_type": metric, "k": K, "ef": 32, **scfg}
    for src_pkg, dst_pkg in ((kt, ktt), (ktt, kt)):
        src = build(name, xb, bcfg, pkg=src_pkg)
        dst = cross_load(src, dst_pkg)
        assert (src.node._inline is None) == (dst.node._inline is None) == (inline == "0")
        a = ids_of(src.Search(src_pkg.GenDataSetFromArray(xq), cfg), XQ)
        b = ids_of(dst.Search(dst_pkg.GenDataSetFromArray(xq), cfg), XQ)
        agree = np.mean([len(set(a[i]) & set(b[i])) / K for i in range(XQ)])
        assert agree >= 0.99, (src_pkg.__name__, agree)
