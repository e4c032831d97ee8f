"""CAGRA and the cuVS names on the port against the JAX package
(knowhere_tpu_torch/models/cagra.py against knowhere_tpu/models/cagra.py),
and the registry of every graph-family and cuVS name.

The knob translations (graph_degree -> M = gd / 2, intermediate_graph_degree
-> efConstruction = 4 * igd, itopk_size -> ef, m=0 -> the largest divisor of
dim that is at most dim / 2, kmeans_n_iters / kmeans_trainset_fraction ->
the Lloyd trainer) are checked on the built nodes, and the searches on a
1/8 grid corpus must give the JAX package's ids (distances within 1e-5
relative). refine_ratio and cache_dataset_on_device act only where the
loaded config leaves refine_k / refine unset, and the HNSW and IVF_PQ
configs give both defaults, so on CAGRA and GPU_CUVS_IVF_PQ they change
nothing, in the reference as in the port (ROADMAP Queue 3). GPU_CUVS_IVF_PQ is built by the JAX package and loaded by the
port (the PQ codebooks' Lloyd sums differ in order between the packages).
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.factory import IndexFactory as JFactory
from knowhere_tpu.feature import feature as JF
from knowhere_tpu_torch.models import cagra as tcagra

from .torch_parity import cross_load

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, D, NQ, K = 1500, 64, 20, 10


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


def _corpus(seed=0, d=D):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((16, d)) * 2.0
    xb = _grid(cents[rng.integers(0, 16, NB)] + rng.standard_normal((NB, d)))
    xq = _grid(cents[rng.integers(0, 16, NQ)] + rng.standard_normal((NQ, d)))
    return xb, xq


XB, XQ = _corpus()


def build(pkg, name, cfg, x=XB):
    idx = pkg.IndexFactory.Instance().Create(name).value()
    st = idx.Build(pkg.GenDataSetFromArray(x), cfg)
    assert st == pkg.Status.success, st
    return idx


def search(idx, pkg, cfg, q=XQ):
    res = idx.Search(pkg.GenDataSetFromArray(q), dict(cfg, k=K), pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(q), K), res.value().distance.reshape(len(q), K)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["GPU_CUVS_CAGRA", "GPU_CAGRA", "TPU_CAGRA"])
@pytest.mark.parametrize("build_cfg,search_cfg,want", [
    ({"graph_degree": 16, "intermediate_graph_degree": 32}, {"itopk_size": 40}, (8, 128, None)),
    ({"graph_degree": 16, "cache_dataset_on_device": True}, {"itopk_size": 24, "refine_ratio": 2.5}, (8, 512, None)),
    ({"M": 6, "efConstruction": 48, "graph_degree": 64}, {"ef": 32, "itopk_size": 99}, (6, 48, None)),
])
def test_cagra_knob_translation_matches_jax(name, build_cfg, search_cfg, want):
    cfg = dict(build_cfg, metric_type="L2")
    jidx, tidx = build(kt, name, cfg), build(ktt, name, cfg)
    node = tidx.node
    assert (node._M, node._efc, node._refine_cfg) == want
    assert (jidx.node._M, jidx.node._efc, jidx.node._refine_cfg) == want
    assert node._graph.shape[1] == 2 * want[0]
    np.testing.assert_array_equal(node._graph, jidx.node._graph)
    scfg = dict(search_cfg, metric_type="L2")
    assert_same(search(tidx, ktt, scfg), search(jidx, kt, scfg))
    rr = {"metric_type": "L2", "radius": 40.0, **search_cfg}
    rj = jidx.RangeSearch(kt.GenDataSetFromArray(XQ), rr, kt.BitsetView()).value()
    rt = tidx.RangeSearch(ktt.GenDataSetFromArray(XQ), rr, ktt.BitsetView()).value()
    np.testing.assert_array_equal(rt.lims, rj.lims)
    np.testing.assert_array_equal(rt.ids, rj.ids)


@pytest.mark.parametrize("cfg_name", ["GpuCuvsCagraConfig", "GpuCuvsIvfFlatConfig", "GpuCuvsIvfPqConfig"])
@pytest.mark.parametrize("given,ratio", [(None, 1.0), (None, 2.0), (None, 2.1), (5, 3.0)])
def test_apply_refine_ratio_matches_jax(cfg_name, given, ratio):
    """refine_ratio -> refine_k (ceil(ratio)) where the loaded config leaves
    refine_k unset (GPU_CUVS_IVF_FLAT's, which has no refine_k of its own),
    on each cuVS config as the reference does."""
    from knowhere_tpu.config import Config as JConfig, Stage as JStage
    from knowhere_tpu.models import cagra as jcagra
    from knowhere_tpu_torch.config import Config as TConfig, Stage as TStage

    json_cfg = {"metric_type": "L2", "k": 10, "refine_ratio": ratio}
    if given is not None:
        json_cfg["refine_k"] = given
    got = []
    for mod, config, stage in ((jcagra, JConfig, JStage), (tcagra, TConfig, TStage)):
        cfg = getattr(mod, cfg_name)()
        assert config.load(cfg, dict(json_cfg), stage.SEARCH)[0].name == "success"
        mod._apply_refine_ratio(cfg)
        got.append(cfg.get("refine_k"))
    assert got[0] == got[1]
    if cfg_name == "GpuCuvsIvfFlatConfig" and ratio > 1.0:
        assert got[1] == int(np.ceil(ratio))
    elif cfg_name != "GpuCuvsIvfFlatConfig":
        assert got[1] == (given or 1)


@pytest.mark.parametrize("dim,want_m", [(64, 32), (96, 48), (100, 50), (120, 60), (126, 63), (70, 35)])
def test_cuvs_ivf_pq_auto_m(dim, want_m):
    """m=0: the largest divisor of dim that is at most dim / 2."""
    xb = np.random.default_rng(dim).standard_normal((600, dim)).astype(np.float32)
    cfg = {"metric_type": "L2", "nlist": 4, "nbits": 4, "kmeans_n_iters": 2}
    tidx = build(ktt, "GPU_CUVS_IVF_PQ", cfg, x=xb)
    assert tidx.node._pq.codebooks.shape[0] == want_m


def test_cuvs_ivf_flat_matches_jax():
    """kmeans_n_iters (default 20) and kmeans_trainset_fraction feed the
    trainer: the same centroids, then the same search and refine."""
    for cfg in ({"nlist": 16}, {"nlist": 16, "kmeans_n_iters": 5, "kmeans_trainset_fraction": 0.3,
                                "cache_dataset_on_device": True}):
        cfg = dict(cfg, metric_type="L2")
        jidx, tidx = build(kt, "GPU_CUVS_IVF_FLAT", cfg), build(ktt, "GPU_CUVS_IVF_FLAT", cfg)
        np.testing.assert_allclose(tidx.node._centroids, jidx.node._centroids, rtol=1e-5, atol=1e-5)
        scfg = {"metric_type": "L2", "nprobe": 4, "refine_ratio": 2.0}
        assert_same(search(tidx, ktt, scfg), search(jidx, kt, scfg))


def test_cuvs_ivf_pq_cross_loads():
    """A JAX-built GPU_CUVS_IVF_PQ (m=0) searched by the port, and the
    port's own build loaded by the JAX package."""
    cfg = {"metric_type": "L2", "nlist": 16, "nbits": 4, "cache_dataset_on_device": True, "kmeans_n_iters": 4}
    jidx = build(kt, "GPU_CUVS_IVF_PQ", cfg)
    scfg = {"metric_type": "L2", "nprobe": 4, "refine_ratio": 4.0}
    want = search(jidx, kt, scfg)
    assert_same(search(cross_load(jidx, ktt), ktt, scfg), want)
    tidx = build(ktt, "GPU_CUVS_IVF_PQ", cfg)
    assert tidx.node._pq.codebooks.shape[0] == D // 2 and tidx.node._refine_cfg == jidx.node._refine_cfg
    assert_same(search(cross_load(tidx, kt), kt, scfg), search(tidx, ktt, scfg))


def test_cagra_config_ranges_match_jax():
    """The CUDA-scheduling knobs validate as in the reference."""
    for bad in ({"team_size": 64}, {"hashmap_max_fill_rate": 0.95}, {"refine_ratio": 0.5}, {"itopk_size": 0}):
        codes = []
        for pkg in (kt, ktt):
            idx = pkg.IndexFactory.Instance().Create("GPU_CUVS_CAGRA").value()
            res = idx.Search(pkg.GenDataSetFromArray(XQ[:1]), dict(bad, metric_type="L2", k=1), pkg.BitsetView())
            codes.append(res.error().name)
        assert codes[0] == codes[1] == "out_of_range_in_json", (bad, codes)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _table(reg, modules):
    out = {}
    for (name, dt), (ctor, feats) in reg.items():
        cls = next((c for c in ctor.__defaults__ or () if isinstance(c, type)), ctor)  # register_index's make
        if cls.__module__.rsplit(".", 1)[-1] in modules or name.startswith("SVS_"):
            out.setdefault(name, [set(), feats, type(cls(version=0).CreateConfig()).__name__])[0].add(dt)
    return out


def test_registry_matches_jax_for_graph_and_cuvs_names():
    """Every HNSW, SVS, HNSW_DEPRECATED, CAGRA and cuVS name the JAX package
    registers, with the same data types, feature bits (EMB_LIST included)
    and config class, and no other."""
    modules = ("hnsw", "svs", "cagra")
    want = _table(JFactory.Instance()._registry, modules)
    got = _table(ktt.IndexFactory.Instance()._registry, modules)
    assert set(want) == {"HNSW", "HNSW_SQ", "HNSW_PQ", "HNSW_PRQ", "SVS_FLAT", "SVS_VAMANA", "SVS_VAMANA_LVQ",
                         "SVS_VAMANA_LEANVEC", "HNSWLIB_DEPRECATED", "HNSW_DEPRECATED", "GPU_CUVS_CAGRA",
                         "GPU_CAGRA", "TPU_CAGRA", "GPU_CUVS_IVF_FLAT", "GPU_IVF_FLAT", "TPU_IVF_FLAT",
                         "GPU_CUVS_IVF_PQ", "GPU_IVF_PQ", "TPU_IVF_PQ"}
    assert got == want
    assert ktt.IndexFactory.Instance().GetIndexFeatures()["GPU_CUVS_CAGRA"] & JF.GPU
    for name, (dts, _, _) in want.items():
        for dt in dts:
            j = JFactory.Instance().Create(name, data_type=dt).value()
            t = ktt.IndexFactory.Instance().Create(name, data_type=dt).value()
            assert type(t.node).__name__ == type(j.node).__name__ and t.Type() == j.Type() == name
