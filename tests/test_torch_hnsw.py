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


# ---------------------------------------------------------------------------
# the exact fallback: the kept rows' scan against the masked scan of every row
# ---------------------------------------------------------------------------

FB_NB, FB_NQ, FB_DIM, FB_BITS = 3000, 12, 32, 64
FB_INDEXES = {  # kind -> (metric, ids and distances bit for bit)
    "grid-L2": ("L2", True), "grid-IP": ("IP", True),  # integer rows: exact products
    "normal-L2": ("L2", False), "normal-IP": ("IP", False), "normal-COSINE": ("COSINE", False),
    "binary-HAMMING": ("HAMMING", True),  # 64-bit codes: integer distances, many ties
}
FB_KEPT = ["1%", "10%", "60%", "3 rows", "none", "10% id_offset", "10% out_ids"]


@pytest.fixture(scope="module")
def fallback_indexes():
    built = {}

    def get(kind):
        if kind not in built:
            rng = np.random.default_rng(sum(map(ord, kind)))
            metric = FB_INDEXES[kind][0]
            if kind.startswith("binary"):
                xb, xq = (rng.integers(0, 256, (n, FB_BITS // 8)).astype(np.uint8) for n in (FB_NB, FB_NQ))
                idx = ktt.IndexFactory.Instance().Create("HNSW", data_type="bin1").value()
                mk = lambda a: ktt.GenDataSet(len(a), FB_BITS, a)  # noqa: E731
            else:
                draw = (lambda n: rng.integers(-4, 5, (n, FB_DIM))) if kind.startswith("grid") else (
                    lambda n: rng.standard_normal((n, FB_DIM)))
                xb, xq = (draw(n).astype(np.float32) for n in (FB_NB, FB_NQ))
                idx = ktt.IndexFactory.Instance().Create("HNSW").value()
                mk = ds
            assert idx.Build(mk(xb), {"metric_type": metric, "M": 8, "efConstruction": 32}) == ktt.Status.success
            built[kind] = idx.node, idx.node._prep_rows(np.asarray(mk(xq).tensor))
        return built[kind]

    return get


def _fallback_bitset(case, n, rng):
    """(bitset, keep-mask over the n rows) of a FB_KEPT case."""
    share = {"1%": 0.01, "10%": 0.1, "60%": 0.6}.get(case.split()[0], 0.0)
    keep = rng.random(n) < share
    if case == "3 rows":
        keep[rng.choice(n, 3, replace=False)] = True
    if case.endswith("id_offset"):  # the node's rows are bits [off, off + n) of a longer bitset
        off = 777
        bs = ktt.BitsetView.from_bool_array(np.r_[rng.random(off) < 0.5, ~keep])
        bs.set_id_offset(off)
    elif case.endswith("out_ids"):  # the bitset is indexed by external id
        out_ids = rng.permutation(n)
        ext_filtered = np.empty(n, bool)
        ext_filtered[out_ids] = ~keep
        bs = ktt.BitsetView.from_bool_array(ext_filtered)
        bs.set_out_ids(out_ids)
    else:
        bs = ktt.BitsetView.from_bool_array(~keep)
    np.testing.assert_array_equal(bs.host_mask(n), keep)
    return bs, keep


@pytest.mark.parametrize("case", FB_KEPT)
@pytest.mark.parametrize("kind", list(FB_INDEXES))
def test_brute_force_fallback_matches_the_masked_scan(monkeypatch, fallback_indexes, kind, case):
    """The fallback against knn_device over every stored row under the
    keep-mask: kept shares of at most one half scan the kept rows alone,
    above it every row masked; fewer kept rows than k pad with -1 and the
    metric's worst distance. Ids and distances are equal where the products
    are exact (integer rows, {0,1} planes: ties included); elsewhere the
    distances agree to 1e-6 relative."""
    from knowhere_tpu_torch.ops import distances as D
    from knowhere_tpu_torch.ops import topk as T

    node, xq = fallback_indexes(kind)
    bs, keep = _fallback_bitset(case, FB_NB, np.random.default_rng(FB_KEPT.index(case)))
    compacted = []
    kept_scan = T.knn_device_kept
    monkeypatch.setattr(T, "knn_device_kept", lambda *a, **kw: (compacted.append(1), kept_scan(*a, **kw))[1])
    got_d, got_i = node._brute_force(xq, K, bs)
    assert bool(compacted) == (keep.sum() <= FB_NB // 2)

    metric = "L2" if node._internal_metric() == "HAMMING" else node._internal_metric()
    data = node._store["data"]
    want_d, want_i = T.knn_device(torch.from_numpy(xq), data, K, metric, aux=D.base_aux(metric, data),
                                  mask=torch.from_numpy(keep))
    want_d, want_i = want_d.numpy(), want_i.numpy()
    n_found = min(K, int(keep.sum()))
    assert ((got_i >= 0).sum(1) == n_found).all() and keep[got_i[got_i >= 0]].all()
    worst = -np.inf if D.larger_is_better(metric) else np.inf
    np.testing.assert_array_equal(got_d[got_i < 0], worst)
    if FB_INDEXES[kind][1]:
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
    else:
        np.testing.assert_array_equal(got_i < 0, want_i < 0)
        found = got_i >= 0
        scale = np.abs(want_d[found]).max(initial=1)
        np.testing.assert_allclose(got_d[found], want_d[found], rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("tile", [64, 200, 256, 131072])
def test_kept_scan_is_the_masked_scan_ties_included(tile):
    """knn_device_kept over the kept rows gives knn_device's masked answer
    slot for slot, over several tiles, on {0,1} rows whose integer scores
    tie heavily; and where the group selection ranks a higher id first (a
    tied row in a group of larger maximum), it ranks it first too."""
    from knowhere_tpu_torch.ops import distances as D
    from knowhere_tpu_torch.ops import topk as T

    rng = np.random.default_rng(tile)
    x = torch.from_numpy(rng.integers(0, 2, (2000, 6)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 2, (7, 6)).astype(np.float32))
    for share, k, metric in [(0.01, 10, "L2"), (0.05, 40, "IP"), (0.3, 1, "L2"), (0.5, 64, "COSINE")]:
        keep = rng.random(len(x)) < share
        keep[1000:1000 + int(rng.integers(0, 300))] = True  # a run of whole groups
        kept = np.flatnonzero(keep)
        want = T.knn_device(q, x, k, metric, aux=D.base_aux(metric, x), mask=torch.from_numpy(keep), tile=tile)
        rows = x[torch.from_numpy(kept)]
        got = T.knn_device_kept(q, rows, T.kept_plan(kept, len(x), k, tile), k, metric, aux=D.base_aux(metric, rows))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # IP scores: row 64's group has the larger maximum, so its tie 65 beats row 0
    x = torch.full((256, 1), -100.0)
    x[[0, 64, 65, 128, 192], 0] = torch.tensor([3.0, 5.0, 3.0, 1.0, 1.0])
    kept = np.array([0, 64, 65, 128, 192])
    got = T.knn_device_kept(torch.ones((1, 1)), x[kept], T.kept_plan(kept, 256, 2, tile), 2, "IP")
    want = T.knn_device(torch.ones((1, 1)), x, 2, "IP", mask=torch.from_numpy(np.isin(np.arange(256), kept)),
                        tile=tile)
    assert torch.equal(got[1], want[1]) and (tile < 256 or got[1].tolist() == [[64, 65]])


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
