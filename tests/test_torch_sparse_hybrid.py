"""The port's sparse engines (ops/sparse_ops.py) against the JAX package:
the hybrid head/tail engine (the checks of tests/test_sparse_hybrid.py),
the padded TAAT_NAIVE engine, the postings engine, their full-score
variants, and the host structures each builds (bit for bit).

Tolerance: scores within 1e-5 relative; ids equal except where the JAX
scores tie within that tolerance (``torch_parity.assert_sparse_parity``).
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import sparse_ops as jops
from knowhere_tpu_torch.ops import sparse_ops as tops

from .torch_parity import SPARSE_RTOL, assert_sparse_parity, sparse_index, sparse_search

NB, NQ, VOCAB, K = 6000, 24, 2000, 10
BM25 = {"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 30.0}


def _zipf_rows(rng, n, avg_nnz):
    rows = []
    for _ in range(n):
        dims = (rng.zipf(1.3, size=int(rng.integers(4, 2 * avg_nnz))).clip(1, VOCAB) - 1).astype(int)
        rows.append({int(d): float(rng.lognormal(0.0, 0.6)) for d in dims})
    return rows


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return _zipf_rows(rng, NB, 30), _zipf_rows(rng, NQ, 15)


def _pos_sets(scores, ids):
    return [set(ids[i][scores[i] > 0].tolist()) for i in range(ids.shape[0])]


def _both(rows, queries, build, search, bitset=None):
    out = []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", rows, VOCAB, build)
        bs = None if bitset is None else pkg.BitsetView.from_bool_array(bitset)
        out.append((idx, *sparse_search(pkg, idx, queries, VOCAB, search, bs)))
    return out


@pytest.mark.parametrize("metric", ["IP", "BM25"])
def test_hybrid_is_default_and_exact(corpus, metric):
    """The hybrid engine serves the DAAT names, equals the TAAT_NAIVE scan
    and the JAX package's hybrid engine."""
    base, queries = corpus
    extra = BM25 if metric == "BM25" else {}
    (jidx, ids_j, d_j), (tidx, ids_t, d_t) = _both(base, queries, {"metric_type": metric}, {"metric_type": metric, "k": K, **extra})
    assert tidx.node._last_search_stats["engine"] == "hybrid_slab"
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    ids_e, d_e = sparse_search(ktt, tidx, queries, VOCAB, {"metric_type": metric, "k": K, "search_algo": "TAAT_NAIVE", **extra})
    assert tidx.node._last_search_stats["engine"] == "padded_exhaustive"
    for a, b in zip(_pos_sets(d_e, ids_e), _pos_sets(d_t, ids_t)):
        assert a == b
    np.testing.assert_allclose(d_t, d_e, rtol=2e-5, atol=2e-5)
    ids_je, d_je = sparse_search(kt, jidx, queries, VOCAB, {"metric_type": metric, "k": K, "search_algo": "TAAT_NAIVE", **extra})
    assert_sparse_parity(ids_je, d_je, ids_e, d_e)


def test_hybrid_bitset_matches_jax(corpus):
    base, queries = corpus
    filtered = np.zeros(NB, bool)
    filtered[::2] = True  # filter out even ids
    (_, ids_j, d_j), (tidx, ids_t, d_t) = _both(base, queries, {"metric_type": "IP"}, {"metric_type": "IP", "k": K}, filtered)
    assert tidx.node._last_search_stats["engine"] == "hybrid_slab"
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)
    valid = ids_t[ids_t >= 0]
    assert valid.size and (valid % 2 == 1).all()


@pytest.mark.parametrize("metric", ["IP", "BM25"])
@pytest.mark.parametrize("algo", [None, "TAAT_NAIVE"])
def test_drop_and_refine_matches_jax(corpus, metric, algo):
    """drop_ratio_search filters query terms; refine_factor rescores the
    k*rf pool with the full query on the host (BM25 with its transformed
    doc values)."""
    base, queries = corpus
    extra = BM25 if metric == "BM25" else {}
    cfg = {"metric_type": metric, "k": K, "drop_ratio_search": 0.5, "refine_factor": 4, **extra}
    if algo:
        cfg["search_algo"] = algo
    (_, ids_j, d_j), (_, ids_t, d_t) = _both(base, queries, {"metric_type": metric}, cfg)
    assert_sparse_parity(ids_j, d_j, ids_t, d_t)


def test_drop_refine_recall(corpus):
    """tests/test_sparse_hybrid.py::test_hybrid_drop_and_refine on the port."""
    base, queries = corpus
    idx = sparse_index(ktt, "SPARSE_INVERTED_INDEX", base, VOCAB, {"metric_type": "IP"})
    ids0, d0 = sparse_search(ktt, idx, queries, VOCAB, {"metric_type": "IP", "k": K})
    gt = _pos_sets(d0, ids0)

    def recall(cfg):
        ids, d = sparse_search(ktt, idx, queries, VOCAB, cfg)
        return np.mean([len(a & b) / max(len(a), 1) for a, b in zip(gt, _pos_sets(d, ids))])

    rec_drop = recall({"metric_type": "IP", "k": K, "drop_ratio_search": 0.5})
    rec_ref = recall({"metric_type": "IP", "k": K, "drop_ratio_search": 0.5, "refine_factor": 4})
    assert rec_ref >= rec_drop - 1e-9 and rec_ref > 0.7


def test_build_structures_equal_jax(corpus):
    """build_postings, build_hybrid_slab (also at a small slab budget) and
    build_padded_docs give the JAX package's arrays bit for bit."""
    base, _ = corpus
    for drop in (0.0, 0.3):
        pj, pt = jops.build_postings(base, drop), tops.build_postings(base, drop)
        assert pj.dim_start == pt.dim_start and pj.nb == pt.nb
        for a in ("doc_ids", "vals", "row_sums"):
            np.testing.assert_array_equal(getattr(pt, a), getattr(pj, a))
        for budget in (512 << 20, 6144 * 128 * 4 + 1):
            hj, ht = jops.build_hybrid_slab(base, drop, budget), tops.build_hybrid_slab(base, drop, budget)
            assert (ht.F, ht.nb_pad, ht.head_nnz, ht.total_nnz, ht.head_map) == (hj.F, hj.nb_pad, hj.head_nnz, hj.total_nnz, hj.head_map)
            assert ht.head_nnz + len(ht.tail.vals) == ht.total_nnz
            np.testing.assert_array_equal(ht.slab, hj.slab)
            np.testing.assert_array_equal(ht.head_dims, hj.head_dims)
            assert ht.tail.dim_start == hj.tail.dim_start
            np.testing.assert_array_equal(ht.tail.doc_ids, hj.tail.doc_ids)
            np.testing.assert_array_equal(ht.tail.vals, hj.tail.vals)
        dj, dt = jops.build_padded_docs(base, drop), tops.build_padded_docs(base, drop)
        assert (dt.n_dims, dt.L, dt.nb, dt.dim_map) == (dj.n_dims, dj.L, dj.nb, dj.dim_map)
        for a in ("dims_pad", "vals_pad", "row_sums"):
            np.testing.assert_array_equal(getattr(dt, a), getattr(dj, a))
    small_j = jops.build_hybrid_slab(base, budget_bytes=6144 * 128 * 4 + 1)
    assert small_j.F < jops.build_hybrid_slab(base).F  # the small budget cuts F


@pytest.mark.parametrize("packed", ["1", "0"])
@pytest.mark.parametrize("bf16", ["1", "0"])
def test_resident_modes_match_jax(corpus, monkeypatch, packed, bf16):
    """Packed tail ids (KNOWHERE_SPARSE_PACKED_IDS) and bf16 values with the
    exact pool rescore (KNOWHERE_SPARSE_RESIDENT_BF16), each on and off:
    the same answers as the JAX package in the same mode, and the resident
    tensors of the mode."""
    base, queries = corpus
    monkeypatch.setenv("KNOWHERE_SPARSE_PACKED_IDS", packed)
    monkeypatch.setenv("KNOWHERE_SPARSE_RESIDENT_BF16", bf16)
    for metric in ("IP", "BM25"):
        extra = BM25 if metric == "BM25" else {}
        (_, ids_j, d_j), (tidx, ids_t, d_t) = _both(base, queries, {"metric_type": metric}, {"metric_type": metric, "k": K, **extra})
        assert_sparse_parity(ids_j, d_j, ids_t, d_t)
        h, ids_dev = tidx.node._caches["hybrid"]
        slot = tidx.node._caches[("hvals", "ip" if metric == "IP" else "bm25")]
        vals = slot[-1]
        if packed == "1":
            assert h.tail_bits == ktt.ops.bitpack.width_for(NB) and ids_dev.dtype == torch.int32
            assert ids_dev.numel() == (len(h.tail.doc_ids) * h.tail_bits + 31) // 32 + 1
        else:  # u16 ids held as their int16 bits (NB <= 65535)
            assert h.tail_bits == 0 and ids_dev.dtype == torch.int16
        assert h.vals_bf16 == (bf16 == "1")
        assert vals.dtype == (torch.bfloat16 if bf16 == "1" else torch.float32)
        if bf16 == "1":  # round to nearest even, as ml_dtypes rounds
            import ml_dtypes

            want = h.tail.vals if metric == "IP" else tops.bm25_transform(h.tail, *BM25.values())
            np.testing.assert_array_equal(
                vals.view(torch.int16).numpy().view(np.uint16), want.astype(ml_dtypes.bfloat16).view(np.uint16)
            )


@pytest.mark.parametrize("metric", ["IP", "BM25"])
def test_full_scores_match_jax(corpus, metric):
    """The full (nq, nb) scores of the hybrid, padded and postings engines
    (RangeSearch and the iterators read them) against the JAX package's."""
    import jax

    base, queries = corpus
    k1, b, avgdl = BM25.values()
    mask_np = np.arange(NB) % 5 != 0
    h_j, h_t = jops.build_hybrid_slab(base), tops.build_hybrid_slab(base)
    p_j, p_t = jops.build_padded_docs(base), tops.build_padded_docs(base)
    s_j, s_t = jops.build_postings(base), tops.build_postings(base)
    if metric == "BM25":
        slab, tvals = jops.hybrid_bm25_slab(h_j, k1, b, avgdl), jops.bm25_transform(h_j.tail, k1, b, avgdl)
        pvals, svals = jops.padded_bm25_vals(p_j, k1, b, avgdl), jops.bm25_transform(s_j, k1, b, avgdl)
    else:
        slab, tvals, pvals, svals = h_j.slab, h_j.tail.vals, p_j.vals_pad, s_j.vals
    t = torch.from_numpy
    for mask in (None, mask_np):
        jm = None if mask is None else jax.device_put(mask)
        tm = None if mask is None else t(mask)
        got = [
            (jops.sparse_full_scores_hybrid(h_j, jax.device_put(slab), jax.device_put(tvals),
                                            jax.device_put(h_j.tail.doc_ids), queries, 0.2, jm),
             tops.sparse_full_scores_hybrid(h_t, t(slab), t(tvals), t(h_t.tail.doc_ids), queries, 0.2, tm)),
            (jops.sparse_full_scores_padded(p_j, jax.device_put(p_j.dims_pad), jax.device_put(pvals), queries, 0.2, jm),
             tops.sparse_full_scores_padded(p_t, t(p_t.dims_pad), t(pvals), queries, 0.2, tm)),
            (jops.sparse_full_scores(s_j, jax.device_put(svals), jax.device_put(s_j.doc_ids), queries, 0.2, jm),
             tops.sparse_full_scores(s_t, t(svals), t(s_t.doc_ids), queries, 0.2, tm)),
        ]
        for a, c in got:
            np.testing.assert_array_equal(np.isfinite(c), np.isfinite(a))
            np.testing.assert_allclose(c[np.isfinite(c)], a[np.isfinite(a)], rtol=SPARSE_RTOL)


def test_postings_engine_matches_jax(corpus):
    """TAAT_NAIVE on a corpus whose row lengths make padding pathological
    (one row of 600 dims) takes the postings engine in both packages."""
    base, queries = corpus
    rows = list(base[:3000]) + [{d: 1.0 + d / 1000 for d in range(600)}]
    assert tops.build_padded_docs(rows) is None and jops.build_padded_docs(rows) is None
    for cfg in ({"metric_type": "IP", "k": K, "search_algo": "TAAT_NAIVE"},
                {"metric_type": "IP", "k": K, "search_algo": "TAAT_NAIVE", "drop_ratio_search": 0.3}):
        bitset = np.arange(len(rows)) % 7 == 0
        out = []
        for pkg in (kt, ktt):
            idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", rows, VOCAB, {"metric_type": "IP"})
            out.extend(sparse_search(pkg, idx, queries, VOCAB, cfg, pkg.BitsetView.from_bool_array(bitset)))
            assert idx.node._last_search_stats.get("engine") != "padded_exhaustive"
        assert_sparse_parity(*out)


def test_padded_ties_take_the_lower_id():
    """Rows with equal scores across blocks: the running pool comes before
    a block's columns, so the lower ids win, as in the JAX package."""
    rows = [{0: 1.0, (i % 7) + 1: 0.5} for i in range(3000)]
    q = [{0: 2.0}, {0: 1.0, 3: 1.0}]
    cfg = {"metric_type": "IP", "k": 20, "search_algo": "TAAT_NAIVE"}
    out = []
    for pkg in (kt, ktt):
        idx = sparse_index(pkg, "SPARSE_INVERTED_INDEX", rows, 8, {"metric_type": "IP"})
        out.append(sparse_search(pkg, idx, q, 8, cfg))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][0][0], np.arange(20))
