"""DiskANN's build knobs on the port: the sharded build under
build_dram_budget_gb, disk_pq_dims, accelerate_build and AISAQ's knobs (the
five cases of tests/test_diskann_budget.py), and the shard merge's
union-dedup-truncate held to the JAX package's bit for bit."""

import os

import numpy as np
import pytest
import torch

import knowhere_tpu_torch as ktt
from knowhere_tpu.models.diskann import DiskANNIndexNode as JNode
from knowhere_tpu_torch.models.diskann import DiskANNIndexNode as TNode

from .utils import brute_force_gt, knn_recall

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 6000, 8, 64, 10


def _write_bin(path, x):
    with open(path, "wb") as f:
        np.asarray([x.shape[0], x.shape[1]], dtype=np.int32).tofile(f)
        x.tofile(f)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_diskann_budget")
    x = np.random.default_rng(5).standard_normal((NB, DIM), dtype=np.float32)
    q = np.random.default_rng(6).standard_normal((NQ, DIM), dtype=np.float32)
    data_path = str(tmp / "raw.bin")
    _write_bin(data_path, x)
    gt_ids, _ = brute_force_gt(ktt.GenDataSetFromArray(x), ktt.GenDataSetFromArray(q), "L2", K)
    return tmp, data_path, x, ktt.GenDataSetFromArray(q), gt_ids


def _build_and_load(tmp, data_path, tag, extra):
    prefix = str(tmp / f"idx_{tag}")
    idx = ktt.IndexFactory.Instance().Create("DISKANN").value()
    cfg = {
        "metric_type": "L2",
        "index_prefix": prefix,
        "data_path": data_path,
        "max_degree": 32,
        "search_list_size": 64,
        "pq_code_budget_gb": 32 * NB / 1e9,
        **extra,
    }
    assert idx.Build(ktt.DataSet(), cfg) == ktt.Status.success
    assert idx.Deserialize(ktt.BinarySet(), {"index_prefix": prefix}) == ktt.Status.success
    return idx


@pytest.fixture(scope="module")
def single_shot(data):
    """The plain build (16 GB budget, raw rows on disk), shared by the
    single-shot and disk_pq_dims cases."""
    tmp, data_path, x, q, gt = data
    return _build_and_load(tmp, data_path, "big", {"build_dram_budget_gb": 16.0})


def _recall(idx, q, gt):
    r = idx.Search(q, {"metric_type": "L2", "k": K, "search_list_size": 128}, ktt.BitsetView())
    assert r.has_value(), r.what()
    return knn_recall(gt, r.value().ids, NQ, K)


def test_tiny_dram_budget_forces_sharded_build(data):
    """A corpus larger than build_dram_budget_gb still builds (one Vamana
    graph a shard, merged) and keeps the recall contract."""
    tmp, data_path, x, q, gt = data
    budget_gb = 1500 * (DIM * 8 + 32 * 16) / 1e9  # ~1,500 of the 6,000 rows: must shard
    idx = _build_and_load(tmp, data_path, "tiny", {"build_dram_budget_gb": budget_gb})
    stats = idx.node._build_stats
    assert stats["sharded"] is True
    assert stats["n_shards"] >= 2, stats
    assert stats["rows_in_budget"] == max(int(budget_gb * 1e9 // (DIM * 8 + 32 * 16)), 4096)
    rec = _recall(idx, q, gt)
    assert rec >= 0.8, rec
    assert idx.Count() == NB


def test_large_budget_single_shot(data, single_shot):
    tmp, data_path, x, q, gt = data
    idx = single_shot
    assert idx.node._build_stats["sharded"] is False
    rec = _recall(idx, q, gt)
    assert rec >= 0.8, rec


def test_disk_pq_dims_compresses_disk_payload(data, single_shot):
    """disk_pq_dims > 0 stores PQ codes instead of raw rows on disk: the disk
    file shrinks, raw-data APIs refuse, search still reranks decently."""
    tmp, data_path, x, q, gt = data
    idx = _build_and_load(tmp, data_path, "dpq", {"disk_pq_dims": 32})
    f_dpq = os.path.getsize(str(tmp / "idx_dpq") + "_kwtpu_disk.bin")
    f_raw = os.path.getsize(str(tmp / "idx_big") + "_kwtpu_disk.bin")
    assert f_dpq < f_raw / 4, (f_dpq, f_raw)
    assert idx.node._disk_pq is not None
    assert not idx.node.HasRawData("L2")
    ds = ktt.DataSet()
    ds.set("ids", np.asarray([0, 1], np.int64))
    ds.rows = 2
    assert idx.GetVectorByIds(ds).error() == ktt.Status.not_implemented
    rec = _recall(idx, q, gt)
    assert rec >= 0.6, rec  # PQ-decoded rerank is approximate


def test_accelerate_build_flag_observed(data):
    tmp, data_path, x, q, gt = data
    idx = _build_and_load(tmp, data_path, "accel", {"accelerate_build": True})
    assert idx.node._build_stats["accelerated"] is True
    rec = _recall(idx, q, gt)
    assert rec >= 0.6, rec  # a faster build trades some graph quality


def test_aisaq_knobs_have_effect(data):
    """AISAQ's knobs act: num_entry_points caps the entry list,
    pq_cache_size funds the node cache, vectors_beamwidth bounds the walk's
    beam."""
    tmp, data_path, x, q, gt = data
    prefix = str(tmp / "idx_aisaq")
    idx = ktt.IndexFactory.Instance().Create("AISAQ").value()
    st = idx.Build(ktt.DataSet(), {
        "metric_type": "L2", "index_prefix": prefix, "data_path": data_path,
        "max_degree": 32, "search_list_size": 64,
        "pq_code_budget_gb": 32 * NB / 1e9, "num_entry_points": 4,
    })
    assert st == ktt.Status.success, st
    cache_gb = 2000 * DIM * 4 / 1e9  # pq_cache_size funds a 2,000-row cache
    assert idx.Deserialize(ktt.BinarySet(), {"index_prefix": prefix, "pq_cache_size": cache_gb}) == ktt.Status.success
    assert idx.node._entry.shape[0] <= 4
    assert idx.node._cache_rows is not None and idx.node._cache_rows.shape[0] == 2000
    seen = []
    real = idx.node._search_inline_ssd
    idx.node._search_inline_ssd = lambda xq, L, W, keep: seen.append(W) or real(xq, L, W, keep)
    r = idx.Search(q, {"metric_type": "L2", "k": K, "search_list_size": 128, "vectors_beamwidth": 2},
                   ktt.BitsetView())
    assert r.has_value(), r.what()
    assert seen == [2]
    rec = knn_recall(gt, r.value().ids, NQ, K)
    assert rec >= 0.6, rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_edges_matches_jax(seed):
    """The shard merge: the per-row union of two edge lists (with -1
    padding and repeated ids), deduplicated in first-seen order and cut to
    max_degree, bit for bit the JAX package's."""
    rng = np.random.default_rng(seed)
    n, w, deg = 300, 24, 16
    cur = rng.integers(0, 60, (n, w)).astype(np.int32)
    new = rng.integers(0, 60, (n, w)).astype(np.int32)
    cur[rng.random((n, w)) < 0.3] = -1
    new[rng.random((n, w)) < 0.3] = -1
    cur[:5] = -1  # rows with no edge of their own
    new[5:10] = cur[5:10]  # rows whose lists repeat
    got = TNode._merge_edges(cur, new, deg)
    want = JNode._merge_edges(cur, new, deg)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for i in range(n):
        kept = got[i][got[i] >= 0]
        assert len(set(kept.tolist())) == len(kept) and set(kept) <= set(cur[i]) | set(new[i])


@pytest.mark.parametrize("sharded", [False, True], ids=["single_shot", "sharded"])
def test_ivf_route_builds(data, monkeypatch, sharded):
    """The builds of large corpora at test scale: ROUTED_MIN_ROWS and
    ops/graph.KNN_EXACT_MAX_ROWS lowered to 1,000 rows, so the single-shot
    build takes k-means entries and its kNN graph comes from the IVF scan
    (intermediate degree 112 at max_degree 56), and the sharded build's
    shards (about 4,000 rows each) do too. Both keep the recall
    contract."""
    from knowhere_tpu_torch.models import diskann as tdk
    from knowhere_tpu_torch.ops import graph as tgraph

    tmp, data_path, x, q, gt = data
    monkeypatch.setattr(tdk, "ROUTED_MIN_ROWS", 1000)
    monkeypatch.setattr(tgraph, "KNN_EXACT_MAX_ROWS", 1000)
    extra = {"max_degree": 56, "search_list_size": 128}
    if sharded:
        extra["build_dram_budget_gb"] = 4096 * (DIM * 8 + 56 * 16) / 1e9
    idx = _build_and_load(tmp, data_path, f"route_{sharded}", extra)
    stats = idx.node._build_stats
    assert stats["sharded"] is sharded and stats["n_shards"] == (3 if sharded else 1)
    assert idx.node._entry_cents is not None and idx.node._graph_shape == (NB, 56)
    rec = _recall(idx, q, gt)
    assert rec >= 0.9, rec
