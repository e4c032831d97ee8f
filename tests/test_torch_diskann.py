"""DISKANN and DISKANN_DEPRECATED on the port, against the JAX package.

The ten cases of tests/test_diskann.py run on the port. Prefixes cross
packages both ways: an index built by one package is loaded by the other
and both search the same queries (drawn apart from the corpus, so no
distance is a cancellation near 0), with no node cache, a partial one
(stride or BFS) and a full one, with and without a bitset: ids equal,
distances within 1e-5 relative. On a 1/8-grid corpus, where every product
is exact, the port writes the JAX package's graph and entry sections bit
for bit and its PQ codebooks within PQ's Lloyd tolerance. The routed branch
(k-means entries and centroids, n_seed > 0) is reached by lowering
ROUTED_MIN_ROWS, and the JAX package loads the port's routed prefix. The
disk_pq_dims, COSINE, fp16 and int8 indexes, RangeSearch, AnnIterator,
GetVectorByIds, GetIndexMeta and GetFederVisit answer as the JAX package's.

A bf16 corpus builds and searches in the port and answers as the fp32
index over the same (bf16-rounded) values. The JAX package reads a bf16
data file as float32 (knowhere_tpu/models/diskann.py:144) and its Build
fails on every bf16 corpus ("mmap length is greater than file size"); the
port does not reproduce that fault.
"""

import json
import os

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.factory import IndexFactory as JFactory
from knowhere_tpu.io.serialize import read_sections as jread
from knowhere_tpu.ops import refine as jrefine
from knowhere_tpu_torch.io.serialize import read_sections as tread
from knowhere_tpu_torch.models import diskann as tdk
from knowhere_tpu_torch.ops import refine as trefine
from knowhere_tpu_torch.utils.bf16 import bf16_bits, bf16_to_f32

from .utils import KNN_RECALL_THRESHOLD, brute_force_gt, knn_recall

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 2000, 8, 64, 10
BUILD = {
    "metric_type": "L2",
    "max_degree": 32,
    "search_list_size": 64,
    "pq_code_budget_gb": 32 * NB / 1e9,  # 32 bytes/vector
    "build_dram_budget_gb": 2.0,
}
SEARCH = {"metric_type": "L2", "k": K, "search_list_size": 100}
ROW_GB = DIM * 4 / 1e9
CACHES = {
    "none": {},
    "partial": {"search_cache_budget_gb": ROW_GB * (NB // 2)},
    "partial_bfs": {"search_cache_budget_gb": ROW_GB * (NB // 2), "use_bfs_cache": True},
    "full": {"search_cache_budget_gb": 1.0},
}
RTOL = 1e-5


class LocalFileManager:
    """tests/test_diskann.py's FileManager: records the calls."""

    def __init__(self):
        self.loaded, self.added = [], []

    def LoadFile(self, path):
        self.loaded.append(path)
        return True

    def AddFile(self, path):
        self.added.append(path)
        return os.path.exists(path)


def write_diskann_bin(path: str, x: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.asarray([x.shape[0], x.shape[1]], dtype=np.int32).tofile(f)
        x.tofile(f)


def build_prefix(pkg, tmp, tag, x, cfg=None, name="DISKANN", data_type="fp32", fm=None):
    data_path = str(tmp / f"{tag}.bin")
    write_diskann_bin(data_path, x)
    prefix = str(tmp / tag)
    idx = pkg.IndexFactory.Instance().Create(name, data_type=data_type, object=fm).value()
    st = idx.Build(pkg.DataSet(), dict(cfg or BUILD, index_prefix=prefix, data_path=data_path))
    assert st == pkg.Status.success, st
    return prefix


def load(pkg, prefix, fm=None, extra=None, name="DISKANN", data_type="fp32", metric="L2"):
    idx = pkg.IndexFactory.Instance().Create(name, data_type=data_type, object=fm).value()
    st = idx.Deserialize(pkg.BinarySet(), {"metric_type": metric, "index_prefix": prefix, **(extra or {})})
    assert st == pkg.Status.success, st
    return idx


def search(idx, pkg, q, cfg=SEARCH, drop=None):
    bs = pkg.BitsetView.from_bool_array(drop) if drop is not None else pkg.BitsetView()
    res = idx.Search(pkg.GenDataSetFromArray(q), cfg, bs)
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(q), -1), res.value().distance.reshape(len(q), -1)


def assert_alike(a, b):
    """(ids, dists) of the two packages: ids equal, distances within RTOL."""
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=RTOL)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_diskann")


@pytest.fixture(scope="module")
def corpus():
    x = np.random.default_rng(81).standard_normal((NB, DIM), dtype=np.float32)
    q = np.random.default_rng(5).standard_normal((16, DIM), dtype=np.float32)
    drop = np.random.default_rng(7).random(NB) < 0.4
    return x, q, drop


@pytest.fixture(scope="module")
def built(tmp, corpus):
    x = corpus[0]
    fm = LocalFileManager()
    prefix = build_prefix(ktt, tmp, "port", x, fm=fm)
    assert fm.added  # files went through the FileManager
    return x, prefix, fm


@pytest.fixture(scope="module")
def jax_built(tmp, corpus):
    return build_prefix(kt, tmp, "jax", corpus[0])


# ---------------------------------------------------------------------------
# tests/test_diskann.py on the port
# ---------------------------------------------------------------------------


class TestDiskANN:
    def test_search_before_load_fails(self, built):
        x, prefix, fm = built
        idx = ktt.IndexFactory.Instance().Create("DISKANN", object=fm).value()
        res = idx.Search(ktt.GenDataSetFromArray(x[:NQ]), {"metric_type": "L2", "k": K})
        assert not res.has_value()
        assert res.error() == ktt.Status.empty_index

    def test_recall(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm)
        assert idx.Count() == NB and idx.Dim() == DIM
        q_arr = x[:NQ] + 0.01 * np.random.default_rng(0).standard_normal((NQ, DIM)).astype(np.float32)
        res = idx.Search(ktt.GenDataSetFromArray(q_arr), SEARCH)
        assert res.has_value(), res.what()
        gt, _ = brute_force_gt(ktt.GenDataSetFromArray(x), ktt.GenDataSetFromArray(q_arr), "L2", K)
        rec = knn_recall(gt, res.value().ids, NQ, K)
        assert rec >= KNN_RECALL_THRESHOLD, rec

    def test_filtered(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm)
        drop = np.random.default_rng(7).random(NB) < 0.4
        ids, _ = search(idx, ktt, x[:NQ], drop=drop)
        assert not drop[ids[ids >= 0]].any()

    def test_node_cache_budget(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm, {"search_cache_budget_gb": 1.0, "warm_up": True})
        assert idx.node._refine_store is not None
        ids, _ = search(idx, ktt, x[:NQ])
        assert (ids[:, 0] == np.arange(NQ)).mean() >= 0.9  # self-recall

    def test_partial_node_cache_exact_match(self, built):
        """A partial device node cache must not change results: the rerank
        is exact whether a row comes from the cache slab or disk."""
        x, prefix, fm = built
        base = search(load(ktt, prefix, fm), ktt, x[:NQ])
        for cache in ("partial", "partial_bfs"):
            idx = load(ktt, prefix, fm, CACHES[cache])
            node = idx.node
            assert node._cache_rows is not None and node._cache_rows.shape[0] < NB
            ids, dists = search(idx, ktt, x[:NQ])
            np.testing.assert_array_equal(ids, base[0])
            np.testing.assert_allclose(dists, base[1], rtol=1e-4, atol=1e-4)

    def test_get_vector_by_ids(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm)
        ids = np.array([3, 77, 1500])
        res = idx.GetVectorByIds(ktt.GenIdsDataSet(ids))
        assert res.has_value(), res.what()
        np.testing.assert_allclose(res.value().tensor, x[ids], rtol=1e-6)
        bad = idx.GetVectorByIds(ktt.GenIdsDataSet(np.array([NB])))
        assert bad.error() == ktt.Status.invalid_args

    def test_range_search(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm)
        queries = ktt.GenDataSetFromArray(x[:4])
        _, gt_d = brute_force_gt(ktt.GenDataSetFromArray(x), queries, "L2", 50)
        radius = float(np.median(gt_d[:, 25]))
        res = idx.RangeSearch(queries, {"metric_type": "L2", "radius": radius, "min_k": 50})
        assert res.has_value(), res.what()
        assert res.value().lims[-1] > 0
        assert (res.value().distance < radius + 1e-3).all()

    def test_iterator(self, built):
        x, prefix, fm = built
        idx = load(ktt, prefix, fm)
        res = idx.AnnIterator(ktt.GenDataSetFromArray(x[:2]), {"metric_type": "L2"})
        assert res.has_value(), res.what()
        it = res.value()[0]
        prev = -np.inf
        for _ in range(50):
            assert it.HasNext()
            _i, d = it.Next()
            assert d >= prev - 1e-5
            prev = d

    def test_build_requires_paths(self):
        idx = ktt.IndexFactory.Instance().Create("DISKANN").value()
        assert idx.Build(ktt.DataSet(), {"metric_type": "L2"}) == ktt.Status.invalid_param_in_json

    def test_rebuild_on_existing_prefix_rejected(self, built):
        x, prefix, fm = built
        idx = ktt.IndexFactory.Instance().Create("DISKANN", object=fm).value()
        st = idx.Build(ktt.DataSet(), {"metric_type": "L2", "index_prefix": prefix, "data_path": prefix + "nope"})
        assert st == ktt.Status.index_already_trained


# ---------------------------------------------------------------------------
# prefixes across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "bitset"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_jax_built_prefix_loads_in_port(corpus, jax_built, cache, filtered):
    _, q, drop = corpus
    drop = drop if filtered else None
    want = search(load(kt, jax_built, extra=CACHES[cache]), kt, q, drop=drop)
    idx = load(ktt, jax_built, extra=CACHES[cache])
    assert (idx.node._cache_rows is not None) == cache.startswith("partial")
    assert_alike(search(idx, ktt, q, drop=drop), want)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "bitset"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_port_built_prefix_loads_in_jax(corpus, built, cache, filtered):
    _, q, drop = corpus
    drop = drop if filtered else None
    prefix = built[1]
    assert_alike(search(load(ktt, prefix, extra=CACHES[cache]), ktt, q, drop=drop),
                 search(load(kt, prefix, extra=CACHES[cache]), kt, q, drop=drop))


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_mem_sections_match_jax_on_grid(tmp, metric):
    """On a 1/8-grid corpus every product and sum of the graph build is
    exact: the graph and entry sections equal the JAX package's bit for bit
    and the meta is the same. The PQ codebooks come from 12 Lloyd steps
    whose means are not on the grid; a step agrees within 1e-5
    (tests/test_torch_ivf_pq.py), and a row at a near-tie between two
    codewords may take the other one in a later step, which moves those two
    codewords (measured: 4 of 16,384 entries under L2, none under IP). So
    at least 99.9% of the entries agree within 1e-5."""
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((16, DIM)) * 2.0
    x = _grid(cents[rng.integers(0, 16, NB)] + rng.standard_normal((NB, DIM)))
    cfg = dict(BUILD, metric_type=metric)
    secs = {}
    for pkg, read in ((kt, jread), (ktt, tread)):
        prefix = build_prefix(pkg, tmp, f"grid_{metric}_{pkg.__name__}", x, cfg)
        secs[pkg] = read(np.fromfile(prefix + "_kwtpu_mem.bin", np.uint8))
    (j, jm), (t, tm) = secs[kt], secs[ktt]
    assert set(j) == set(t) == {"graph", "entry", "pq_codebooks", "pq_codes"} and jm == tm
    for name in ("graph", "entry"):
        assert j[name].dtype == t[name].dtype
        np.testing.assert_array_equal(t[name], j[name])
    close = np.abs(t["pq_codebooks"] - j["pq_codebooks"]) <= 1e-5
    assert close.mean() >= 0.999, close.size - close.sum()


def test_routed_branch_cross_loads(tmp, corpus, monkeypatch):
    """ROUTED_MIN_ROWS lowered below the corpus: the port's build takes the
    k-means entries and writes entry_cents, its search seeds each query
    from its nearest centroids (n_seed > 0), and the JAX package loads the
    prefix and answers alike."""
    x, q, drop = corpus
    monkeypatch.setattr(tdk, "ROUTED_MIN_ROWS", 1000)
    prefix = build_prefix(ktt, tmp, "routed", x)
    arrays, _ = tread(np.fromfile(prefix + "_kwtpu_mem.bin", np.uint8))
    assert arrays["entry_cents"].shape == (64, DIM) and arrays["entry"].shape == (64,)
    idx = load(ktt, prefix)
    assert idx.node._entry_cents is not None
    ref = load(kt, prefix)
    for d in (None, drop):
        assert_alike(search(idx, ktt, q, drop=d), search(ref, kt, q, drop=d))


def _variant_rows(x, kind):
    if kind == "fp16":
        return x.astype(np.float16), "fp16"
    if kind == "int8":
        return np.clip(np.round(x * 40), -127, 127).astype(np.int8), "int8"
    return x, "fp32"


VARIANTS = {
    "disk_pq": ({"disk_pq_dims": 16}, "L2"),
    "cosine": ({"metric_type": "COSINE"}, "COSINE"),
    "fp16": ({}, "L2"),
    "int8": ({}, "L2"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_prefixes_cross_load(tmp, variant):
    """disk_pq_dims (PQ-decoded rerank), COSINE (normalized f32 rows on
    disk), fp16 and int8 corpora (rows at their width on disk): each
    package's prefix searches alike in the other, and GetVectorByIds gives
    the same answer (the rows in their own dtype, or the same Status)."""
    extra, metric = VARIANTS[variant]
    rng = np.random.default_rng(11)
    x, dt = _variant_rows(rng.standard_normal((1000, 32), dtype=np.float32), variant)
    q = rng.standard_normal((8, 32), dtype=np.float32)
    cfg = dict(BUILD, pq_code_budget_gb=8 * 1000 / 1e9, **extra)
    scfg = dict(SEARCH, metric_type=metric)
    pick = np.array([0, 5, 999])
    for src_pkg in (kt, ktt):
        prefix = build_prefix(src_pkg, tmp, f"{variant}_{src_pkg.__name__}", x, cfg, data_type=dt)
        got = {}
        for pkg in (kt, ktt):
            idx = load(pkg, prefix, data_type=dt, metric=metric)
            vec = idx.GetVectorByIds(pkg.GenIdsDataSet(pick))
            got[pkg] = search(idx, pkg, q, scfg), (vec.value().tensor if vec.has_value() else vec.error().name)
        assert_alike(got[ktt][0], got[kt][0])
        if isinstance(got[kt][1], str):
            assert got[ktt][1] == got[kt][1] == "not_implemented"
        else:
            assert got[ktt][1].dtype == x.dtype
            np.testing.assert_array_equal(got[ktt][1], x[pick])
            np.testing.assert_array_equal(got[ktt][1], got[kt][1])


@pytest.fixture(scope="module")
def both_on_jax_prefix(jax_built):
    return load(kt, jax_built), load(ktt, jax_built)


def test_range_search_matches_jax(corpus, both_on_jax_prefix):
    x, q, drop = corpus
    j, t = both_on_jax_prefix
    d = ((q[:4, None, :] - x[None]) ** 2).sum(-1)
    for radius, extra in ((float(np.median(np.sort(d, 1)[:, 30])), {"min_k": 10}),
                          (float(np.median(np.sort(d, 1)[:, 5])), {"range_filter": 0.0})):
        out = []
        for pkg, idx in ((kt, j), (ktt, t)):
            res = idx.RangeSearch(pkg.GenDataSetFromArray(q[:4]),
                                  {"metric_type": "L2", "radius": radius, **extra}, pkg.BitsetView())
            assert res.has_value(), res.what()
            out.append(res.value())
        np.testing.assert_array_equal(out[1].lims, out[0].lims)
        np.testing.assert_array_equal(out[1].ids, out[0].ids)
        np.testing.assert_allclose(out[1].distance, out[0].distance, rtol=RTOL)
        assert out[1].lims[-1] > 0


def test_iterator_matches_jax(corpus, both_on_jax_prefix):
    _, q, drop = corpus
    j, t = both_on_jax_prefix
    for d in (None, drop):
        seqs = []
        for pkg, idx in ((kt, j), (ktt, t)):
            bs = pkg.BitsetView.from_bool_array(d) if d is not None else pkg.BitsetView()
            its = idx.AnnIterator(pkg.GenDataSetFromArray(q[:2]), {"metric_type": "L2"}, bs).value()
            seqs.append([[it.Next() for _ in range(60)] for it in its])
        for a, b in zip(*seqs):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=RTOL)
            if d is not None:
                assert not d[[i for i, _ in a]].any()


def test_index_meta_and_feder_visit_match_jax(corpus, both_on_jax_prefix):
    _, q, _ = corpus
    j, t = both_on_jax_prefix
    jm = json.loads(j.node.GetIndexMeta(j.node.CreateConfig()).value().get("json_info"))
    tm = json.loads(t.node.GetIndexMeta(t.node.CreateConfig()).value().get("json_info"))
    assert tm == jm and tm["index_type"] == "DISKANN" and tm["count"] == NB
    visits = []
    for pkg, idx in ((kt, j), (ktt, t)):
        cfg = idx.node.CreateConfig()
        pkg.Config.load(cfg, {"metric_type": "L2", "k": K, "search_list_size": 32}, pkg.Stage.SEARCH)
        visits.append(json.loads(idx.node.GetFederVisit(pkg.GenDataSetFromArray(q[:2]), cfg).value().get("json_id_set")))
    assert visits[1] == visits[0] and all(len(v) > 1 for v in visits[1])
    empty = ktt.IndexFactory.Instance().Create("DISKANN").value()
    assert empty.node.GetIndexMeta(empty.node.CreateConfig()).error() == ktt.Status.empty_index


def test_refine_topk_matches_jax():
    """ops/refine.refine_topk, the host wrapper: numpy candidates (-1
    padded, repeated ids) in, numpy (dists, positions) out, as the JAX
    package's."""
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((300, 24), dtype=np.float32)
    q = rng.standard_normal((9, 24), dtype=np.float32)
    cand = rng.integers(-1, 300, (9, 40)).astype(np.int32)
    cand[0, :] = -1
    cand[1, 3] = cand[1, 5]
    for is_l2 in (True, False):
        d_j, i_j = jrefine.refine_topk(q, jrefine.RefineStore("raw", rows), cand, 10, is_l2)
        d_t, i_t = trefine.refine_topk(q, trefine.RefineStore("raw", torch.from_numpy(rows)), cand, 10, is_l2)
        assert isinstance(d_t, np.ndarray) and isinstance(i_t, np.ndarray)
        np.testing.assert_array_equal(i_t, np.asarray(i_j))
        np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=RTOL)
        assert (i_t[0] == -1).all()


# ---------------------------------------------------------------------------
# bf16 corpora: the reference's fault repaired
# ---------------------------------------------------------------------------


def test_bf16_corpus_matches_fp32_over_the_same_values(tmp, corpus):
    """A bf16 data file (uint16 bit patterns) builds, keeps its rows bf16 on
    disk, and searches as the fp32 DISKANN over the bf16-rounded values:
    ids equal, distances within 1e-5 relative. The JAX package's Build of
    the same file does not succeed (it maps the file as float32)."""
    x, q, drop = corpus
    bits = bf16_bits(x)
    vals = bf16_to_f32(bits)
    p16 = build_prefix(ktt, tmp, "bf16", bits, data_type="bf16")
    p32 = build_prefix(ktt, tmp, "bf16_values_fp32", vals)
    d_arrays, _ = tread(np.fromfile(p16 + "_kwtpu_disk.bin", np.uint8))
    assert d_arrays["data"].dtype == np.uint16 and d_arrays["data"].nbytes == NB * DIM * 2
    np.testing.assert_array_equal(d_arrays["data"], bits)
    i16, i32 = load(ktt, p16, data_type="bf16"), load(ktt, p32)
    for d in (None, drop):
        assert_alike(search(i16, ktt, bits[:16], drop=d), search(i32, ktt, vals[:16], drop=d))
        assert_alike(search(i16, ktt, q, drop=d), search(i32, ktt, q, drop=d))
    got = i16.GetVectorByIds(ktt.GenIdsDataSet(np.array([0, 9]))).value().tensor
    np.testing.assert_array_equal(got, bits[[0, 9]])

    ref = kt.IndexFactory.Instance().Create("DISKANN", data_type="bf16").value()
    jp = str(tmp / "bf16_jax")
    st = ref.Build(kt.DataSet(), dict(BUILD, index_prefix=jp, data_path=str(tmp / "bf16.bin")))
    assert st != kt.Status.success  # the reference's fault (ROADMAP Queue 3c)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _table(reg, names):
    out = {}
    for (name, dt), (ctor, feats) in reg.items():
        if name in names:
            cfg = ctor(version=0).CreateConfig()
            keys = sorted(type(cfg)._entries) if hasattr(type(cfg), "_entries") else sorted(vars(type(cfg)))
            out.setdefault(name, [set(), feats, type(cfg).__name__, keys])[0].add(dt)
    return out


def test_registry_matches_jax_for_diskann_names():
    names = ("DISKANN", "DISKANN_DEPRECATED", "AISAQ")
    want = _table(JFactory.Instance()._registry, names)
    got = _table(ktt.IndexFactory.Instance()._registry, names)
    assert set(got) == set(names) and got == want
    assert got["DISKANN"][0] == {"fp32", "fp16", "bf16", "int8"} and got["DISKANN_DEPRECATED"][0] == {
        "fp32", "fp16", "bf16"}
    for name in names:
        assert ktt.UseDiskLoad(name) == kt.UseDiskLoad(name)


def test_registry_lacks_only_the_unported_pairs():
    """No (name, data type) pair of the JAX package is left unported: the
    port's registry equals the JAX package's both ways (the five SHARDED_*
    nodes at fp32 came last), with the same feature bits and config
    classes."""
    want = set(JFactory.Instance()._registry)
    got = set(ktt.IndexFactory.Instance()._registry)
    assert want - got == set(), sorted(want - got)
    assert got - want == set(), sorted(got - want)
    names = {name for name, _ in want}
    assert _table(ktt.IndexFactory.Instance()._registry, names) == _table(JFactory.Instance()._registry, names)
