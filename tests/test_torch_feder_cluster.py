"""feder (GetIndexMeta / GetFederVisit of HNSW and IVF) and the k-means
Cluster API on the port against the JAX package
(knowhere_tpu_torch/feder.py, cluster.py, models/hnsw.py, models/ivf.py).

Each feder check loads one BinarySet in both packages and compares the JSON
strings whole: the overview samples with numpy's seeded generator, and the
host replay of the walk (GetFederVisit) scores the same stored rows in the
same order. Cluster's Lloyd runs on each package's device: centroids within
1e-5, assignments equal on a corpus of well separated modes, and the error
codes of the reference's tests/test_cluster_and_errors.py.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.config import Config as JConfig, Stage as JStage
from knowhere_tpu_torch.config import Config as TConfig, Stage as TStage

from .torch_parity import cross_load

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, D = 1200, 32


def _rows(seed, n=NB, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _search_cfg(idx, pkg, cfg):
    config, stage = (JConfig, JStage) if pkg is kt else (TConfig, TStage)
    out = idx.node.CreateConfig()
    assert config.load(out, cfg, stage.SEARCH)[0].name == "success"
    return out


def _feder(idx, pkg, q, cfg, levels):
    meta = idx.GetIndexMeta({"overview_levels": levels})
    assert meta.has_value(), meta.what()
    visit = idx.node.GetFederVisit(pkg.GenDataSetFromArray(q), _search_cfg(idx, pkg, cfg))
    assert visit.has_value(), visit.what()
    return meta.value().get("json_info"), visit.value().get("json_id_set")


@pytest.mark.parametrize("name,dt,metric", [
    ("HNSW", "fp32", "L2"), ("HNSW", "fp32", "IP"), ("HNSW", "fp16", "L2"), ("HNSW", "bf16", "COSINE"),
    ("HNSW_SQ", "fp32", "L2"), ("SVS_VAMANA_LVQ", "fp32", "L2"),
])
def test_hnsw_feder_matches_jax(name, dt, metric):
    x, q = _rows(1), _rows(2, n=3)
    if dt != "fp32":
        x, q = x.astype(np.float16 if dt == "fp16" else ml_dtypes.bfloat16), q.astype(np.float32)
    jidx = kt.IndexFactory.Instance().Create(name, data_type=dt).value()
    assert jidx.Build(kt.GenDataSetFromArray(x), {"metric_type": metric, "M": 8, "efConstruction": 64}) == kt.Status.success
    tidx = cross_load(jidx, ktt, dt)
    cfg = {"metric_type": metric, "k": 5, "ef": 24}
    got, want = _feder(tidx, ktt, q, cfg, 2), _feder(jidx, kt, q, cfg, 2)
    assert got[0] == want[0]
    info = json.loads(got[0])
    assert info["type"] == "HNSW" and len(info["overview_levels"]) == 2 and info["count"] == NB
    tv, jv = json.loads(got[1]), json.loads(want[1])
    assert [[(t["id"], t["source"]) for t in tr] for tr in tv] == [[(t["id"], t["source"]) for t in tr] for tr in jv]
    for a, b in zip(tv, jv):
        np.testing.assert_allclose([t["distance"] for t in a], [t["distance"] for t in b], rtol=1e-5, atol=1e-4)
    assert all(tr[0]["source"] == -1 and tr[0]["id"] in set(tidx.node._entry.tolist()) for tr in tv)


def test_ivf_feder_matches_jax():
    x, q = _rows(3, n=2000), _rows(4, n=3)
    jidx = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert jidx.Build(kt.GenDataSetFromArray(x), {"metric_type": "L2", "nlist": 16}) == kt.Status.success
    tidx = cross_load(jidx, ktt)
    cfg = {"metric_type": "L2", "k": 5, "nprobe": 4}
    got, want = _feder(tidx, ktt, q, cfg, 3), _feder(jidx, kt, q, cfg, 3)
    assert got == want
    info, traces = json.loads(got[0]), json.loads(got[1])
    assert info["nlist"] == 16 and sum(info["list_sizes"]) == 2000 and info["index_type"] == "IVF_FLAT"
    assert len(traces) == 3 and all(len(t) == 4 for t in traces)
    own = ktt.IndexFactory.Instance().Create("IVF_SQ8").value()
    assert own.Build(ktt.GenDataSetFromArray(x), {"metric_type": "IP", "nlist": 8}) == ktt.Status.success
    assert sum(json.loads(own.GetIndexMeta({}).value().get("json_info"))["list_sizes"]) == 2000


@pytest.mark.parametrize("name", ["HNSW", "IVF_FLAT"])
def test_feder_empty_index(name):
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create(name).value()
        assert idx.GetIndexMeta({}).error() == pkg.Status.empty_index
        cfg = _search_cfg(idx, pkg, {"metric_type": "L2", "k": 5})
        assert idx.node.GetFederVisit(pkg.GenDataSetFromArray(_rows(5, n=2)), cfg).error() == pkg.Status.empty_index


# ---------------------------------------------------------------------------
# Cluster
# ---------------------------------------------------------------------------


def _modes(seed=7, n=300, d=16, k=4):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)).astype(np.float32) * 10
    return (centres[np.arange(n) % k] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("cfg", [{"num_clusters": 4, "num_iter": 10}, {"num_clusters": 7, "num_iter": 3}, {}])
def test_cluster_train_assign_centroids_match_jax(cfg):
    x = _modes()
    out = {}
    for pkg in (kt, ktt):
        cl = pkg.ClusterFactory.Instance().Create("KMEANS").value()
        res = cl.Train(pkg.GenDataSetFromArray(x), cfg)
        assert res.has_value(), res.what()
        cents = np.asarray(res.value().tensor).reshape(-1, 16)
        again = np.asarray(cl.GetCentroids().value().tensor).reshape(-1, 16)
        ids = np.asarray(cl.Assign(pkg.GenDataSetFromArray(x)).value().ids)
        out[pkg] = cents, again, ids, cl.Type()
    np.testing.assert_allclose(out[ktt][0], out[kt][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[ktt][1], out[ktt][0])
    np.testing.assert_array_equal(out[ktt][2], out[kt][2])
    assert out[ktt][0].shape[0] == cfg.get("num_clusters", 48) and out[ktt][3] == out[kt][3] == "KMEANS"


def test_cluster_train_repeats_its_bits():
    x = _modes(seed=8, n=2000, d=32, k=8)
    runs = []
    for _ in range(2):
        cl = ktt.ClusterFactory.Instance().Create("KMEANS").value()
        runs.append(np.asarray(cl.Train(ktt.GenDataSetFromArray(x), {"num_clusters": 16}).value().tensor))
    np.testing.assert_array_equal(runs[0].view(np.uint32), runs[1].view(np.uint32))


def test_cluster_error_codes_match_jax():
    """Assign or GetCentroids before Train, a second Train at another k,
    num_clusters out of range, an unknown cluster type."""
    x = _modes()
    for pkg in (kt, ktt):
        cl = pkg.ClusterFactory.Instance().Create("KMEANS").value()
        assert cl.Assign(pkg.GenDataSetFromArray(x)).error() == pkg.Status.empty_index
        assert cl.GetCentroids().error() == pkg.Status.empty_index
        assert cl.Train(pkg.GenDataSetFromArray(x), {"num_clusters": 0}).error() == pkg.Status.out_of_range_in_json
        assert cl.Train(pkg.GenDataSetFromArray(x), {"num_clusters": 4}).has_value()
        assert cl.Train(pkg.GenDataSetFromArray(x), {"num_clusters": 8}).error() == pkg.Status.cluster_inner_error
        assert cl.Train(pkg.GenDataSetFromArray(x[:, :8]), {"num_clusters": 4}).error() == pkg.Status.cluster_inner_error
        assert cl.Train(pkg.GenDataSetFromArray(x), {"num_clusters": 4}).has_value()
        assert pkg.ClusterFactory.Instance().Create("NOT_A_CLUSTER").error() == pkg.Status.invalid_cluster_error
