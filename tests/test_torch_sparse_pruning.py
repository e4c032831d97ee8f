"""The port's windowed pruner (ops/sparse_ops.sparse_search_pruned, the
DAAT WAND / MaxScore / BlockMax / SINDI analog) and the posting codecs
against the JAX package: the checks of tests/test_sparse_pruning.py, run on
both packages, and the pruner's scan statistics equal to the JAX package's
(the same windows scanned in each phase).

Tolerance: scores within 1e-5 relative; ids equal except where the JAX
scores tie within that tolerance (``torch_parity.assert_sparse_parity``).
"""

import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

from .torch_parity import assert_sparse_parity, cross_load, sparse_index, sparse_search

NB, NQ, NDIM, K = 20000, 16, 256, 10
BM25 = {"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 10.0}


def _gen_rows(rng, n, nnz_hi=12, topic=None):
    """tests/test_sparse_pruning.py's topic-clustered rows."""
    rows = []
    for i in range(n):
        t = topic if topic is not None else (i * 16) // max(n, 1)
        nnz = int(rng.integers(4, nnz_hi))
        local = (t * (NDIM // 16) + rng.integers(0, NDIM // 16, size=nnz)) % NDIM
        row = {int(d): float(rng.uniform(0.1, 3.0)) for d in local}
        if rng.random() < 0.3:  # shared stopword dim
            row[int(rng.integers(0, 8))] = float(rng.uniform(0.05, 0.3))
        rows.append(row)
    return rows


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    return _gen_rows(rng, NB), _gen_rows(rng, NQ, topic=3)


@pytest.fixture(scope="module")
def indexes(corpus):
    base, _ = corpus
    cfg = {"metric_type": "IP", "inverted_index_algo": "DAAT_WAND"}
    return {pkg: sparse_index(pkg, "SPARSE_INVERTED_INDEX", base, NDIM, cfg) for pkg in (kt, ktt)}


def _both(indexes, queries, cfg, bitset=None):
    """(JAX ids, distances, port ids, distances); the two packages' scan
    statistics must be equal."""
    out, stats = [], []
    for pkg, idx in indexes.items():
        bs = None if bitset is None else pkg.BitsetView.from_bool_array(bitset)
        out.extend(sparse_search(pkg, idx, queries, NDIM, cfg, bs))
        stats.append({k: v for k, v in idx.node._last_search_stats.items() if k != "engine"})
    assert stats[0] == stats[1]
    return out


def _pos_sets(scores, ids):
    return [set(ids[i][scores[i] > 0].tolist()) for i in range(ids.shape[0])]


def test_pruned_equals_exact_at_ratio_ge_one(corpus, indexes):
    """With dim_max_score_ratio >= 1 and no term drop the pruner is exact:
    it equals the exhaustive scan, and the JAX package's pruner."""
    _, queries = corpus
    c_wand = {"metric_type": "IP", "k": K, "search_algo": "DAAT_WAND", "sindi_window_size": 1024, "dim_max_score_ratio": 1.0}
    ids_j, d_j, ids_t, d_t = _both(indexes, queries, c_wand)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    stats = indexes[ktt].node._last_search_stats
    assert stats["engine"] == "pruned" and stats["n_windows"] > 1
    assert stats["windows_scanned_a"] + stats["windows_scanned_b"] < stats["windows_total"], stats
    ids_e, d_e = sparse_search(ktt, indexes[ktt], queries, NDIM, {"metric_type": "IP", "k": K, "search_algo": "TAAT_NAIVE"})
    for a, b in zip(_pos_sets(d_e, ids_e), _pos_sets(d_t, ids_t)):
        assert a == b
    np.testing.assert_allclose(np.where(d_e > 0, d_e, 0), np.where(d_t > 0, d_t, 0), rtol=1e-5, atol=1e-5)


def test_sindi_window_size_controls_windowing(corpus, indexes):
    _, queries = corpus
    cfg = {"metric_type": "IP", "k": K, "search_algo": "SINDI", "sindi_window_size": 1024}
    ids_j, d_j, ids_s, d_s = _both(indexes, queries, cfg)
    assert_sparse_parity(ids_j, d_j, ids_s, d_s)
    n_small = indexes[ktt].node._last_search_stats["n_windows"]
    cfg["sindi_window_size"] = 16384
    ids_j, d_j, ids_b, d_b = _both(indexes, queries, cfg)
    assert_sparse_parity(ids_j, d_j, ids_b, d_b)
    assert n_small > indexes[ktt].node._last_search_stats["n_windows"] >= 1
    np.testing.assert_allclose(np.where(d_s > 0, d_s, 0), np.where(d_b > 0, d_b, 0), rtol=1e-5, atol=1e-5)


def test_dim_max_score_ratio_changes_pruning(indexes):
    """A ratio < 1 scales the bounds down and skips more windows; > 1 is
    conservative (sparse_index_config.h:97-126); both as in the JAX
    package."""
    rng = np.random.default_rng(5)
    queries = [{int(d): float(rng.uniform(0.5, 1.5)) for d in rng.choice(NDIM, size=24, replace=False)} for _ in range(NQ)]
    scanned = []
    for ratio in (0.5, 1.3):
        cfg = {"metric_type": "IP", "k": K, "search_algo": "DAAT_WAND", "sindi_window_size": 1024, "dim_max_score_ratio": ratio}
        assert_sparse_parity(*_both(indexes, queries, cfg))
        st = indexes[ktt].node._last_search_stats
        scanned.append(st["windows_scanned_a"] + st["windows_scanned_b"])
    assert scanned[0] < scanned[1]


def test_refine_factor_recovers_dropped_terms(corpus, indexes):
    _, queries = corpus
    gt = sparse_search(ktt, indexes[ktt], queries, NDIM, {"metric_type": "IP", "k": K, "search_algo": "TAAT_NAIVE"})[0]
    rec = []
    for rf in (1, 8):
        cfg = {"metric_type": "IP", "k": K, "search_algo": "DAAT_MAXSCORE", "sindi_window_size": 1024,
               "drop_ratio_search": 0.6, "refine_factor": rf}
        ids_j, d_j, ids, d = _both(indexes, queries, cfg)
        assert_sparse_parity(ids_j, d_j, ids, d)
        rec.append(np.mean([len(set(ids[i][ids[i] >= 0]) & set(gt[i][gt[i] >= 0])) / max((gt[i] >= 0).sum(), 1)
                            for i in range(NQ)]))
    assert rec[1] >= rec[0] and rec[1] > 0.9, rec


def test_pruned_respects_bitset(corpus, indexes):
    _, queries = corpus
    filtered = np.zeros(NB, bool)
    filtered[np.random.default_rng(2).choice(NB, size=NB // 3, replace=False)] = True
    cfg = {"metric_type": "IP", "k": K, "search_algo": "DAAT_WAND", "sindi_window_size": 1024}
    ids_j, d_j, ids, d = _both(indexes, queries, cfg, filtered)
    assert_sparse_parity(ids_j, d_j, ids, d)
    assert not filtered[ids[ids >= 0]].any()


def test_pruned_bm25(corpus):
    base, queries = corpus
    idxs = {pkg: sparse_index(pkg, "SPARSE_INVERTED_INDEX", base, NDIM, {"metric_type": "BM25", **BM25}) for pkg in (kt, ktt)}
    c_wand = {"metric_type": "BM25", "k": K, "search_algo": "BLOCK_MAX_WAND", "sindi_window_size": 1024,
              "dim_max_score_ratio": 1.0, **BM25}
    ids_j, d_j, ids_t, d_t = _both(idxs, queries, c_wand)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    ids_e, d_e = sparse_search(ktt, idxs[ktt], queries, NDIM, {"metric_type": "BM25", "k": K, "search_algo": "TAAT_NAIVE", **BM25})
    for a, b in zip(_pos_sets(d_e, ids_e), _pos_sets(d_t, ids_t)):
        assert a == b
    c_drop = dict(c_wand, drop_ratio_search=0.4, refine_factor=4)  # the BM25 rescore of the pool
    assert_sparse_parity(*_both(idxs, queries, c_drop))


def test_window_max_equals_jax(corpus):
    """build_window_max's per-dim windows, maxima and entry spans, bit for
    bit."""
    from knowhere_tpu.ops import sparse_ops as jops
    from knowhere_tpu_torch.ops import sparse_ops as tops

    base, _ = corpus
    p = tops.build_postings(base)
    wj, wt = jops.build_window_max(jops.build_postings(base), p.vals, 3000), tops.build_window_max(p, p.vals, 3000)
    assert (wt.W, wt.n_windows, wt.per_dim.keys()) == (wj.W, wj.n_windows, wj.per_dim.keys())
    for d, arrs in wj.per_dim.items():
        for a, b in zip(arrs, wt.per_dim[d]):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("codec", ["", "block_streamvbyte", "block_maskedvbyte", "block_adaptive", "adaptive", "delta_varint", "none"])
def test_codec_selection_roundtrip(corpus, codec):
    """inverted_index_codec by the reference's names: every choice
    round-trips to the same answers, in the port and into the JAX package,
    with the JAX package's section bytes."""
    base, queries = corpus
    cfg = {"metric_type": "IP", **({"inverted_index_codec": codec} if codec else {})}
    blobs, ids = [], []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", base[:2000], NDIM, cfg)
        bs = pkg.BinarySet()
        assert idx.Serialize(bs) == pkg.Status.success
        blobs.append(bs.GetByName("SPARSE_INVERTED_INDEX").tobytes())
        for dst in (kt, ktt):
            loaded = cross_load(idx, dst, data_type="sparse")
            ids.append(sparse_search(dst, loaded, queries, NDIM, {"metric_type": "IP", "k": K})[0])
    assert blobs[0] == blobs[1]
    for got in ids[1:]:
        np.testing.assert_array_equal(got, ids[0])


def test_unknown_codec_rejected(corpus):
    base, _ = corpus
    idx = ktt.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX", data_type="sparse").value()
    st = idx.Build(ktt.GenSparseDataSet(base[:100], NDIM), {"metric_type": "IP", "inverted_index_codec": "bogus"})
    assert st == ktt.Status.invalid_value_in_json
