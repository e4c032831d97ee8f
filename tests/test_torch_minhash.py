"""The port's MINHASH_LSH against the JAX package: tests/test_minhash.py's
and tests/test_emb_list.py::TestMinHash's checks on the port, and both
packages on the same seeded signatures.

Tolerance: none. The hashing is the same uint64 arithmetic, so the band
tables and Bloom bytes are bit-equal; the rerank counts equal elements, so
ids and similarities are equal (ties keep the lower id in both).
"""

import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.models import minhash as jmh
from knowhere_tpu_torch.models import minhash as tmh

from .torch_parity import cross_load

DIM_BITS, WIDTH, NB, NQ, K = 32 * 16, 32, 2000, 8, 5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")


def _pack(elems: np.ndarray, width: int = WIDTH) -> np.ndarray:
    """(n, n_elem) element values -> packed bin1 rows of ``width``-bit elements."""
    n = elems.shape[0]
    return elems.astype(np.uint32 if width == 32 else np.uint64).view(np.uint8).reshape(n, -1)


def _ds(pkg, rows, dim=DIM_BITS):
    ds = pkg.DataSet()
    ds.set("tensor", rows)
    ds.rows = rows.shape[0]
    ds.dim = dim
    return ds


@pytest.fixture(scope="module")
def corpus():
    """tests/test_minhash.py's corpus: copies of base rows with two mutated
    elements, so LSH bands collide and the rerank has real gradations."""
    rng = np.random.default_rng(9)
    n_elem = DIM_BITS // WIDTH
    base = rng.integers(0, 50, size=(NB, n_elem), dtype=np.uint64)
    q_src = rng.integers(0, NB, size=NQ)
    queries = base[q_src].copy()
    for i in range(NQ):
        mut = rng.integers(0, n_elem, size=2)
        queries[i, mut] += 1
    return _pack(base), _pack(queries), q_src


def _build(pkg, base, dim=DIM_BITS, width=WIDTH, band=8, **extra):
    cfg = {"metric_type": "MHJACCARD", "mh_element_bit_width": width, "mh_lsh_band": band, **extra}
    idx = pkg.IndexFactory.Instance().Create("MINHASH_LSH", data_type="bin1").value()
    assert idx.Build(_ds(pkg, base, dim), cfg) == pkg.Status.success
    return idx


def _search(pkg, idx, q, dim=DIM_BITS, width=WIDTH, bitset=None, **extra):
    cfg = {"metric_type": "MHJACCARD", "k": K, "mh_element_bit_width": width, **extra}
    r = idx.Search(_ds(pkg, q, dim), cfg, bitset or pkg.BitsetView())
    assert r.has_value(), r.what()
    return r.value().ids.reshape(-1, K), r.value().distance.reshape(-1, K)


# --- tests/test_minhash.py on the port ------------------------------------------


def test_search_finds_source_row(corpus):
    base, queries, q_src = corpus
    ids, _ = _search(ktt, _build(ktt, base), queries)
    hits = np.mean([q_src[i] in set(ids[i]) for i in range(NQ)])
    assert hits >= 0.7, hits  # band collisions survive 2 mutated elements


def test_batch_search_matches_sequential(corpus):
    base, queries, _ = corpus
    idx = _build(ktt, base)
    ids_s, d_s = _search(ktt, idx, queries)
    ids_b, d_b = _search(ktt, idx, queries, mh_lsh_batch_search=True)
    np.testing.assert_array_equal(ids_s, ids_b)
    np.testing.assert_array_equal(d_s, d_b)


def test_bloom_prefilter_skips_absent_hashes(corpus):
    base, _, _ = corpus
    idx = _build(ktt, base)
    rng = np.random.default_rng(77)
    alien = _pack(rng.integers(1 << 20, 1 << 30, size=(NQ, DIM_BITS // WIDTH), dtype=np.uint64))
    ids, _ = _search(ktt, idx, alien)
    stats = idx.node._last_search_stats
    assert stats["bloom_skipped"] > 0, stats
    assert (ids == -1).all()


def test_shared_bloom_filter(corpus):
    base, queries, q_src = corpus
    idx = _build(ktt, base, mh_lsh_shared_bloom_filter=True, mh_lsh_bloom_false_positive_prob=0.001)
    ids, _ = _search(ktt, idx, queries)
    hits = np.mean([q_src[i] in set(ids[i]) for i in range(NQ)])
    assert hits >= 0.7, hits
    assert len(idx.node._blooms) == 1  # one shared filter, not per-band


def test_serialize_loads_tables_without_rebuild(corpus):
    base, queries, _ = corpus
    idx = _build(ktt, base)
    ids0, _ = _search(ktt, idx, queries)
    idx2 = cross_load(idx, ktt, data_type="bin1")
    assert idx2.node._tables_dirty is False
    assert idx2.node._band_hash is not None
    assert len(idx2.node._blooms) == idx2.node._n_band
    np.testing.assert_array_equal(_search(ktt, idx2, queries)[0], ids0)


def test_bitset_filtering(corpus):
    base, queries, q_src = corpus
    idx = _build(ktt, base)
    filtered = np.zeros(NB, bool)
    filtered[q_src] = True  # filter out every query's source row
    ids, _ = _search(ktt, idx, queries, bitset=ktt.BitsetView.from_bool_array(filtered))
    assert not filtered[ids[ids >= 0]].any()


# --- tests/test_emb_list.py::TestMinHash on the port ------------------------------


def test_mhjaccard_self_match_and_near_duplicate():
    rng = np.random.default_rng(93)
    nb, dim, width = 200, 256, 32
    xb = rng.integers(0, 256, size=(nb, dim // 8), dtype=np.uint8)
    xb[1] = xb[0].copy()
    xb[1, 0] ^= 0xFF
    idx = ktt.IndexFactory.Instance().Create("MINHASH_LSH", data_type="bin1").value()
    assert idx.Build(ktt.GenDataSet(nb, dim, xb), {"metric_type": "MHJACCARD", "mh_element_bit_width": width,
                                                  "mh_lsh_band": 4}) == ktt.Status.success
    res = idx.Search(ktt.GenDataSet(1, dim, xb[0:1]), {"metric_type": "MHJACCARD", "k": 3,
                                                      "mh_element_bit_width": width})
    assert res.has_value(), res.what()
    ids, d = res.value().ids, res.value().distance
    assert ids[0] == 0 and d[0] == 1.0  # exact self match
    assert 1 in ids.tolist()  # near-duplicate found via shared bands


def test_serialize_count():
    rng = np.random.default_rng(94)
    xb = rng.integers(0, 256, size=(100, 32), dtype=np.uint8)
    idx = ktt.IndexFactory.Instance().Create("MINHASH_LSH", data_type="bin1").value()
    idx.Build(ktt.GenDataSet(100, 256, xb), {"metric_type": "MHJACCARD", "mh_element_bit_width": 32,
                                             "mh_lsh_band": 4})
    assert cross_load(idx, ktt, data_type="bin1").Count() == 100


# --- the port against the JAX package ---------------------------------------------


@pytest.mark.parametrize("shared", [False, True], ids=["per_band", "shared"])
def test_tables_and_bloom_bytes_equal_jax(corpus, shared):
    base, _, _ = corpus
    nodes = [_build(pkg, base, mh_lsh_shared_bloom_filter=shared).node for pkg in (kt, ktt)]
    for n in nodes:
        n._ensure_tables()
    j, t = nodes
    np.testing.assert_array_equal(t._band_hash, j._band_hash)
    np.testing.assert_array_equal(t._band_rows, j._band_rows)
    assert len(t._blooms) == len(j._blooms)
    for bt, bj in zip(t._blooms, j._blooms):
        assert (bt.n_bits, bt.n_hashes) == (bj.n_bits, bj.n_hashes)
        np.testing.assert_array_equal(bt.bits, bj.bits)


@pytest.mark.parametrize("width,dim", [(32, 512), (64, 512), (12, 240), (8, 128)])
def test_elements_equal_jax(width, dim):
    rows = np.random.default_rng(width).integers(0, 256, (300, dim // 8), dtype=np.uint8)
    a = jmh._to_elements(rows, dim, width)
    b = tmh._to_elements(rows, dim, width)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [False, True], ids=["one_by_one", "batch"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_band", "shared"])
def test_search_equals_jax(corpus, batch, shared):
    base, queries, _ = corpus
    filtered = np.zeros(NB, bool)
    filtered[::3] = True
    for bits in (None, filtered):
        out = []
        for pkg in (kt, ktt):
            idx = _build(pkg, base, mh_lsh_shared_bloom_filter=shared)
            bs = pkg.BitsetView.from_bool_array(bits) if bits is not None else None
            out.append(_search(pkg, idx, queries, bitset=bs, mh_lsh_batch_search=batch) + (idx.node._last_search_stats,))
        (ij, dj, sj), (it, dt, st) = out
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
        assert st == sj


def test_width_64_equals_jax():
    """mh_element_bit_width 64: elements past 2^32 held as int64 on the
    device; a query element equal to a stored one modulo 2^32 only is no
    match."""
    rng = np.random.default_rng(5)
    n_elem, nb = 8, 500
    base = rng.integers(0, 40, size=(nb, n_elem), dtype=np.uint64) + (np.uint64(1) << np.uint64(40))
    q = base[:6].copy()
    q[:, 0] = (q[:, 0] & np.uint64(0xFFFFFFFF)) + (np.uint64(3) << np.uint64(33))  # low 32 bits kept
    rows, qrows = _pack(base, 64), _pack(q, 64)
    out = []
    for pkg in (kt, ktt):
        idx = _build(pkg, rows, dim=n_elem * 64, width=64, band=4)
        out.append(_search(pkg, idx, qrows, dim=n_elem * 64, width=64))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert (out[1][1][:, 0] == np.float32(7 / 8)).all()


@pytest.mark.parametrize("src,dst", [(kt, ktt), (ktt, kt)], ids=["jax_to_port", "port_to_jax"])
def test_blob_cross_loads_without_rebuild(corpus, src, dst):
    base, queries, _ = corpus
    idx = _build(src, base)
    want = _search(src, idx, queries)
    loaded = cross_load(idx, dst, data_type="bin1")
    assert loaded.node._tables_dirty is False
    got = _search(dst, loaded, queries)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_iterator_and_vectors_equal_jax(corpus):
    base, queries, _ = corpus
    its, vecs = [], []
    for pkg in (kt, ktt):
        idx = _build(pkg, base)
        r = idx.AnnIterator(_ds(pkg, queries[:2]), {"metric_type": "MHJACCARD", "mh_element_bit_width": WIDTH})
        assert r.has_value(), r.what()
        its.append([[it.Next() for _ in range(20)] for it in r.value()])
        v = idx.GetVectorByIds(pkg.GenIdsDataSet(np.array([3, 0, 1999])))
        vecs.append(np.asarray(v.value().tensor))
        assert idx.GetVectorByIds(pkg.GenIdsDataSet(np.array([NB]))).error() == pkg.Status.invalid_args
    assert its[1] == its[0]
    np.testing.assert_array_equal(vecs[1], vecs[0])
