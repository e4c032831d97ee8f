"""The port's sparse family and sparse BruteForce against the JAX package
(the checks of tests/test_sparse_index.py, tests/test_brute_force.py's
sparse cases and tests/test_cc_concurrent.py's sparse cases, run on both
packages over the same seeded rows).

Tolerance: scores within 1e-5 relative (f32 sums of the same products in
other orders); ids equal except where the JAX scores tie within that
tolerance (``torch_parity.assert_sparse_parity``).
"""

import threading
import time

import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.models import sparse as tsparse

from .torch_parity import (
    SPARSE_RTOL,
    assert_sparse_parity,
    cross_load,
    sparse_ds,
    sparse_index,
    sparse_search,
)

NB, NQ, DIM, K = 1000, 8, 200, 10
BM25 = {"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 8.0}
NAMES = ["SPARSE_INVERTED_INDEX", "SPARSE_WAND", "SPARSE_INVERTED_INDEX_CC", "SPARSE_WAND_CC"]


def gen_rows(n, dim=DIM, nnz=16, seed=71):
    """tests/utils.gen_sparse_dataset's rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.choice(dim, size=min(nnz, dim), replace=False)
        vals = rng.random(len(idx)).astype(np.float32) + 0.05
        out.append({int(i): float(v) for i, v in zip(idx, vals)})
    return out


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")


@pytest.fixture(scope="module")
def base():
    return gen_rows(NB, seed=71)


@pytest.fixture(scope="module")
def queries():
    return gen_rows(NQ, seed=72)


def _both(name, rows, build, search, queries, bitset=None):
    """(JAX ids, distances, port ids, distances) of the same build and
    search in both packages."""
    out = []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, name, rows, DIM, build)
        bs = None if bitset is None else pkg.BitsetView.from_bool_array(bitset)
        out.extend(sparse_search(pkg, idx, queries, DIM, search, bs))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_ip_matches_jax(base, queries, name):
    ids_j, d_j, ids_t, d_t = _both(name, base, {"metric_type": "IP"}, {"metric_type": "IP", "k": K}, queries)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    bf = ktt.BruteForce.Search(sparse_ds(ktt, base, DIM), sparse_ds(ktt, queries, DIM), {"metric_type": "IP", "k": K})
    assert_sparse_parity(bf.value().ids.reshape(NQ, K), bf.value().distance.reshape(NQ, K), ids_t, d_t)


def test_bm25_matches_jax(base, queries):
    cfg = {"metric_type": "BM25", "k": K, **BM25}
    ids_j, d_j, ids_t, d_t = _both("SPARSE_INVERTED_INDEX", base, {"metric_type": "BM25"}, cfg, queries)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    bf = ktt.BruteForce.Search(sparse_ds(ktt, base, DIM), sparse_ds(ktt, queries, DIM), cfg).value()
    assert_sparse_parity(bf.ids.reshape(NQ, K), bf.distance.reshape(NQ, K), ids_t, d_t)


def test_bm25_missing_params(base, queries):
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", base, DIM, {"metric_type": "BM25"})
        res = idx.Search(sparse_ds(pkg, queries, DIM), {"metric_type": "BM25", "k": K})
        assert res.error() == pkg.Status.invalid_param_in_json


def test_filtered_matches_jax(base, queries):
    filtered = np.random.default_rng(0).random(NB) < 0.5
    ids_j, d_j, ids_t, d_t = _both(
        "SPARSE_INVERTED_INDEX", base, {"metric_type": "IP"}, {"metric_type": "IP", "k": K}, queries, filtered
    )
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    assert not filtered[ids_t[ids_t >= 0]].any()


@pytest.mark.parametrize("refine", [1, 4])
def test_drop_ratio_search_matches_jax(base, queries, refine):
    cfg = {"metric_type": "IP", "k": K, "drop_ratio_search": 0.3, "refine_factor": refine}
    ids_j, d_j, ids_t, d_t = _both("SPARSE_INVERTED_INDEX", base, {"metric_type": "IP"}, cfg, queries)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)


def test_drop_ratio_build_matches_jax(base, queries):
    build = {"metric_type": "IP", "drop_ratio_build": 0.2}
    ids_j, d_j, ids_t, d_t = _both("SPARSE_INVERTED_INDEX", base, build, {"metric_type": "IP", "k": K}, queries)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    idx = sparse_index(ktt, "SPARSE_INVERTED_INDEX", base, DIM, build)
    assert not idx.HasRawData("IP")


@pytest.mark.parametrize("metric", ["IP", "BM25"])
def test_range_search_and_iterator_match_jax(base, queries, metric):
    extra = BM25 if metric == "BM25" else {}
    got = {}
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", base, DIM, {"metric_type": metric})
        top = sparse_search(pkg, idx, queries, DIM, {"metric_type": metric, "k": 30, **extra})[1]
        radius = float(np.median(top[:, 15]))
        bs = pkg.BitsetView.from_bool_array(np.arange(NB) % 3 == 0)
        res = idx.RangeSearch(sparse_ds(pkg, queries, DIM), {"metric_type": metric, "radius": radius, **extra}, bs)
        assert res.has_value(), res.what()
        its = idx.AnnIterator(sparse_ds(pkg, queries, DIM), {"metric_type": metric, **extra}, bs)
        assert its.has_value(), its.what()
        streams = []
        for it in its.value():
            pairs = [it.Next() for _ in range(40) if it.HasNext()]
            streams.append(pairs)
        got[pkg] = (radius, res.value(), streams)
    (r_j, rs_j, st_j), (r_t, rs_t, st_t) = got[kt], got[ktt]
    np.testing.assert_allclose(r_t, r_j, rtol=SPARSE_RTOL)
    np.testing.assert_array_equal(rs_t.lims, rs_j.lims)
    assert rs_t.lims[-1] > 0 and (rs_t.distance > r_t).all()
    np.testing.assert_allclose(rs_t.distance, rs_j.distance, rtol=SPARSE_RTOL)
    for a, b in zip(st_j, st_t):
        assert len(a) == len(b)
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a], rtol=SPARSE_RTOL)
        assert np.mean([x[0] == y[0] for x, y in zip(a, b)]) >= 0.95  # ties may swap
        assert all(b[i][1] >= b[i + 1][1] - 1e-5 for i in range(len(b) - 1))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("codec", ["", "flat", "block_streamvbyte", "block_adaptive"])
def test_binaryset_cross_load(base, queries, direction, codec):
    src, dst = (kt, ktt) if direction == "jax_to_torch" else (ktt, kt)
    build = {"metric_type": "IP", **({"inverted_index_codec": codec} if codec else {})}
    idx = sparse_index(src, "SPARSE_INVERTED_INDEX", base, DIM, build)
    cfg = {"metric_type": "IP", "k": K}
    ids_s, d_s = sparse_search(src, idx, queries, DIM, cfg)
    loaded = cross_load(idx, dst, data_type="sparse")
    ids_d, d_d = sparse_search(dst, loaded, queries, DIM, cfg)
    np.testing.assert_array_equal(ids_d, ids_s)
    np.testing.assert_allclose(d_d, d_s, rtol=SPARSE_RTOL)
    got = loaded.GetVectorByIds(dst.GenIdsDataSet(np.array([0, 5, NB - 1])))
    assert got.value().tensor == [base[0], base[5], base[NB - 1]]


def test_binaryset_bytes_equal_jax(base):
    """The same rows serialize to the same section bytes in both packages
    (the codec streams included)."""
    blobs = []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_WAND", base, DIM, {"metric_type": "IP"})
        bs = pkg.BinarySet()
        assert idx.Serialize(bs) == pkg.Status.success
        blobs.append(bs.GetByName("SPARSE_WAND").tobytes())
    assert blobs[0] == blobs[1]


def test_get_vector_by_ids(base):
    idx = sparse_index(ktt, "SPARSE_INVERTED_INDEX", base, DIM, {"metric_type": "IP"})
    assert idx.HasRawData("IP")
    res = idx.GetVectorByIds(ktt.GenIdsDataSet(np.array([0, 5])))
    assert res.has_value(), res.what()
    assert res.value().tensor == [base[0], base[5]]
    bad = idx.GetVectorByIds(ktt.GenIdsDataSet(np.array([NB])))
    assert bad.error() == ktt.Status.invalid_args


def test_cc_growable_matches_jax(queries):
    x1, x2 = gen_rows(500, seed=73), gen_rows(300, seed=74)
    got = []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX_CC", x1, DIM, {"metric_type": "IP"})
        assert idx.Add(sparse_ds(pkg, x2, DIM), {"metric_type": "IP"}) == pkg.Status.success
        assert idx.Count() == 800
        got.extend(sparse_search(pkg, idx, queries, DIM, {"metric_type": "IP", "k": K}))
    assert_sparse_parity(*got)


def test_bad_algo_and_codec_rejected(base):
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX", data_type="sparse").value()
        ds = sparse_ds(pkg, base[:100], DIM)
        assert idx.Build(ds, {"metric_type": "IP", "inverted_index_algo": "NOT_AN_ALGO"}) == pkg.Status.invalid_value_in_json
        assert idx.Build(ds, {"metric_type": "IP", "inverted_index_codec": "bogus"}) == pkg.Status.invalid_value_in_json
        assert idx.Build(ds, {"metric_type": "L2"}) == pkg.Status.invalid_metric_type


def test_bm25_hand_computed_scores():
    """tests/test_sparse_index.py's hand-written BM25 oracle on the port:
    score = sum_t q_t * tf*(k1+1)/(tf + k1*(1-b+b*dl/avgdl))."""
    k1, b, avgdl = 1.5, 0.6, 4.0
    docs = [{0: 2.0, 1: 1.0}, {1: 3.0}, {0: 1.0, 2: 5.0}]
    qs = [{0: 0.7, 1: 0.3}]
    cfg = {"metric_type": "BM25", "k": 3, "bm25_k1": k1, "bm25_b": b, "bm25_avgdl": avgdl}

    def oracle(qd, dd):
        dl = sum(dd.values())
        return sum(qv * dd[t] * (k1 + 1) / (dd[t] + k1 * (1 - b + b * dl / avgdl)) for t, qv in qd.items() if t in dd)

    want = sorted(((oracle(qs[0], d), i) for i, d in enumerate(docs)), reverse=True)
    idx = ktt.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX", data_type="sparse_u32_f32").value()
    assert idx.Build(ktt.GenSparseDataSet(docs, 3), cfg) == ktt.Status.success
    q = ktt.GenSparseDataSet(qs, 3)
    for res in (idx.Search(q, cfg), ktt.BruteForce.Search(ktt.GenSparseDataSet(docs, 3), q, cfg)):
        assert res.has_value(), res.what()
        np.testing.assert_array_equal(res.value().ids.reshape(-1), [i for _, i in want])
        np.testing.assert_allclose(res.value().distance.reshape(-1), [s for s, _ in want], rtol=1e-5)


# ---------------------------------------------------------------------------
# Sparse BruteForce (tests/test_brute_force.py:151-178)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["IP", "BM25"])
@pytest.mark.parametrize("filtered", [False, True])
def test_brute_force_search_matches_jax(metric, filtered):
    rows, qs = gen_rows(200, dim=100, nnz=8, seed=6), gen_rows(5, dim=100, nnz=8, seed=7)
    cfg = {"metric_type": metric, "k": 5, **({"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 4.0} if metric == "BM25" else {})}
    mask = np.arange(200) % 2 == 0 if filtered else None
    got = []
    for pkg in (kt, ktt):
        bs = pkg.BitsetView.from_bool_array(mask) if filtered else None
        for fn in (pkg.BruteForce.Search, pkg.BruteForce.SearchSparse):
            res = fn(sparse_ds(pkg, rows, 100), sparse_ds(pkg, qs, 100), cfg, bs)
            assert res.has_value(), res.what()
            got.append((res.value().ids.reshape(5, 5), res.value().distance.reshape(5, 5)))
    for ids, d in got[1:]:
        assert_sparse_parity(*got[0], ids, d)
    ids, d = got[-1]
    if metric == "IP":  # the dict dot products themselves
        for qi, qrow in enumerate(qs):
            for j in np.nonzero(ids[qi] >= 0)[0]:
                want = sum(v * rows[ids[qi, j]].get(dim, 0.0) for dim, v in qrow.items())
                assert abs(want - d[qi, j]) < 1e-4
    if filtered:
        assert not mask[ids[ids >= 0]].any()
    buf_i, buf_d = np.empty(25, np.int64), np.empty(25, np.float32)
    bs = ktt.BitsetView.from_bool_array(mask) if filtered else None
    st = ktt.BruteForce.SearchSparseWithBuf(sparse_ds(ktt, rows, 100), sparse_ds(ktt, qs, 100), buf_i, buf_d, cfg, bs)
    assert st == ktt.Status.success
    np.testing.assert_array_equal(buf_i.reshape(5, 5), got[2][0])


def test_brute_force_errors_match_jax():
    rows, qs = gen_rows(10, dim=20, nnz=4), gen_rows(2, dim=20, nnz=4, seed=3)
    for cfg, want in (({"metric_type": "BM25", "k": 2}, "invalid_param_in_json"),
                      ({"metric_type": "L2", "k": 2}, "invalid_metric_type")):
        for pkg in (kt, ktt):
            res = pkg.BruteForce.Search(sparse_ds(pkg, rows, 20), sparse_ds(pkg, qs, 20), cfg)
            assert res.error().name == want
    dense = ktt.GenDataSetFromArray(np.zeros((4, 4), np.float32))
    assert ktt.BruteForce.SearchSparse(dense, dense, {"metric_type": "IP", "k": 2}).error() == ktt.Status.invalid_args


@pytest.mark.parametrize("metric", ["IP", "BM25"])
def test_brute_force_range_and_iterator_match_jax(metric):
    rows, qs = gen_rows(300, dim=60, nnz=8, seed=8), gen_rows(4, dim=60, nnz=8, seed=9)
    extra = {"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 4.0} if metric == "BM25" else {}
    cfg = {"metric_type": metric, "radius": 0.5, "range_search_k": 20, **extra}
    out = []
    for pkg in (kt, ktt):
        bs = pkg.BitsetView.from_bool_array(np.arange(300) % 4 == 1)
        res = pkg.BruteForce.RangeSearch(sparse_ds(pkg, rows, 60), sparse_ds(pkg, qs, 60), cfg, bs)
        assert res.has_value(), res.what()
        its = pkg.BruteForce.AnnIterator(sparse_ds(pkg, rows, 60), sparse_ds(pkg, qs, 60), {"metric_type": metric, **extra}, bs)
        out.append((res.value(), [[it.Next() for _ in range(30) if it.HasNext()] for it in its.value()]))
    (r_j, it_j), (r_t, it_t) = out
    np.testing.assert_array_equal(r_t.lims, r_j.lims)
    np.testing.assert_allclose(r_t.distance, r_j.distance, rtol=SPARSE_RTOL)
    for a, b in zip(it_j, it_t):
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a], rtol=SPARSE_RTOL)


# ---------------------------------------------------------------------------
# The engine probe, its persisted choice, and the pending segment
# ---------------------------------------------------------------------------


@pytest.fixture
def probe_at_test_scale(monkeypatch):
    monkeypatch.setattr(tsparse, "PROBE_MIN_ROWS", 0)
    monkeypatch.setattr(tsparse, "PROBE_MIN_QUERIES", 0)


def test_engine_probe_failure_raises(base, queries, probe_at_test_scale, monkeypatch):
    """The reference answers a failing probe with the hybrid engine
    (models/sparse.py:770); the port's Search fails instead."""
    idx = sparse_index(ktt, "SPARSE_INVERTED_INDEX", base, DIM, {"metric_type": "IP"})

    def broken(*args, **kw):
        raise RuntimeError("pruned engine failed")

    monkeypatch.setattr(tsparse.SparseInvertedIndexNode, "_search_pruned", broken)
    res = idx.Search(sparse_ds(ktt, queries, DIM), {"metric_type": "IP", "k": K})
    assert not res.has_value()
    assert "pruned engine failed" in res.what()


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_engine_choice_persists_across_packages(base, queries, probe_at_test_scale, monkeypatch, direction):
    """The probe's choice (per drop ratio and bitset) is written by Serialize
    and restored by Deserialize in either package: the loaded index serves
    it without probing again."""
    src = ktt if direction == "torch_to_jax" else kt
    idx = sparse_index(src, "SPARSE_INVERTED_INDEX", base, DIM, {"metric_type": "IP"})
    cfg = {"metric_type": "IP", "k": K, "drop_ratio_search": 0.2}
    if src is ktt:
        sparse_search(ktt, idx, queries, DIM, cfg)
        choices = {k: v for k, v in idx.node._caches.items() if k[0] == "engine_choice"}
        assert list(choices) == [("engine_choice", 0.2, False)] and set(choices.values()) <= {"hybrid", "pruned"}
    else:  # what the JAX package's probe records on a corpus of 100,000 rows or more
        choices = {("engine_choice", 0.2, False): "pruned"}
        idx.node._caches.update(choices)
    dst = kt if src is ktt else ktt
    loaded = cross_load(idx, dst, data_type="sparse")
    assert {k: v for k, v in loaded.node._caches.items() if k[0] == "engine_choice"} == choices
    if dst is ktt:
        ids_t, d_t = sparse_search(ktt, loaded, queries, DIM, cfg)
        assert loaded.node._last_search_stats["engine"] == "pruned" and loaded.node._last_probe == {}
        monkeypatch.setenv("KNOWHERE_SPARSE_AUTO_ENGINE", "pruned")
        assert_sparse_parity(*sparse_search(kt, idx, queries, DIM, cfg), ids_t, d_t)


def test_pending_rows_without_overlap_are_no_match():
    """A pending (unmerged) row that shares no dim with the query is no
    match, as after the merge. The reference returns it with score 0
    (models/sparse.py:634-650 scores it 0, :718 keeps finite scores), so its
    answer changes when the segment merges (ROADMAP Queue 3c)."""
    rows = gen_rows(400, dim=48, nnz=4, seed=11)
    extra = [{40: 1.0}, {41: 2.0}]  # below the merge threshold: pending
    q = [{0: 1.0}]  # matches a few base rows, neither pending row
    cfg = {"metric_type": "IP", "k": 50}
    got = {}
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX_CC", rows, 48, {"metric_type": "IP"})
        assert idx.Add(sparse_ds(pkg, extra, 48), {"metric_type": "IP"}) == pkg.Status.success
        pending = sparse_search(pkg, idx, q, 48, cfg)
        assert idx.Serialize(pkg.BinarySet()) == pkg.Status.success  # merges
        got[pkg] = (pending, sparse_search(pkg, idx, q, 48, cfg))
    (p_t, m_t) = got[ktt]
    np.testing.assert_array_equal(p_t[0], m_t[0])
    assert not np.isin([400, 401], p_t[0]).any()
    p_j = got[kt][0][0]
    assert np.isin([400, 401], p_j).all()  # the reference's zero-score pending ids
    assert_sparse_parity(*got[kt][1], *m_t)


def test_pending_scores_match_merged_and_jax():
    """tests/test_cc_concurrent.py::test_sparse_pending_scores_match_merged
    on the port, and the pending search against the JAX package's."""
    rng = np.random.default_rng(11)

    def rows_(n):
        return [{int(d): float(rng.uniform(0.1, 2.0)) for d in rng.choice(48, size=int(rng.integers(3, 9)), replace=False)}
                for _ in range(n)]

    base_, extra, qs = rows_(400), rows_(50), rows_(4)
    cfg = {"metric_type": "IP", "k": 8}
    out = {}
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX_CC", base_, 48, cfg)
        assert idx.Add(sparse_ds(pkg, extra, 48), cfg) == pkg.Status.success
        pending = sparse_search(pkg, idx, qs, 48, cfg)
        assert idx.Serialize(pkg.BinarySet()) == pkg.Status.success
        out[pkg] = (pending, sparse_search(pkg, idx, qs, 48, cfg))
    (pi, pd), (mi, md) = out[ktt]
    np.testing.assert_allclose(pd, md, rtol=1e-5, atol=1e-5)
    assert (pi == mi).mean() > 0.9
    assert_sparse_parity(*out[kt][0], pi, pd)


def test_cc_add_during_search():
    """tests/test_cc_concurrent.py::test_sparse_cc_add_during_search on the
    port: three readers search while five batches are added (each a merge
    past the threshold); every read succeeds, every acknowledged row is
    counted and read back, and a freshly added row is found."""
    rng = np.random.default_rng(5)

    def rows_(n):
        return [{int(d): float(rng.uniform(0.1, 2.0)) for d in rng.choice(64, size=int(rng.integers(3, 9)), replace=False)}
                for _ in range(n)]

    base_, qs = rows_(3000), rows_(6)
    cfg = {"metric_type": "IP", "k": 10}
    idx = sparse_index(ktt, "SPARSE_INVERTED_INDEX_CC", base_, 64, cfg)
    stop, errors = threading.Event(), []

    def searcher():
        while not stop.is_set():
            r = idx.Search(sparse_ds(ktt, qs, 64), cfg, ktt.BitsetView())
            if not r.has_value():
                errors.append(r.what())
                return

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    for t in threads:
        t.start()
    added = list(base_)
    try:
        for _ in range(5):
            batch = rows_(900)
            assert idx.Add(sparse_ds(ktt, batch, 64), cfg) == ktt.Status.success
            added += batch
            time.sleep(0.01)
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert idx.Count() == len(added)
    back = idx.GetVectorByIds(ktt.GenIdsDataSet(np.arange(len(added)))).value().tensor
    assert back == added
    ids, _ = sparse_search(ktt, idx, [batch[0]], 64, cfg)
    assert (ids >= 0).any()
