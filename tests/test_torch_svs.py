"""SVS on the port against the JAX package: the LVQ codec
(knowhere_tpu_torch/ops/quant.py lvq_*), the lvq decode kind of both walks
(ops/graph.py, ops/graph_inline.py), models/svs.py (SVS_FLAT, SVS_VAMANA,
SVS_VAMANA_LVQ, SVS_VAMANA_LEANVEC and the svs_* knob mapping) and the
LeanVec store of models/hnsw.py.

LVQ codes, offsets and scales are compared byte for byte (the quotient
(r - off) / scale lands on integers at the bins' edges, so one ulp moves a
code; the test data puts rows on such edges). Indexes are built on a 1/8
grid corpus, where the graphs and walks are identical in both packages; ids
must be equal and distances within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.config import Config as JConfig, Stage as JStage
from knowhere_tpu.ops import graph as jgraph
from knowhere_tpu.ops import graph_inline as jinline
from knowhere_tpu.ops import quant as jquant
from knowhere_tpu_torch.config import Config as TConfig, Stage as TStage
from knowhere_tpu_torch.ops import graph as tgraph
from knowhere_tpu_torch.ops import graph_inline as tinline
from knowhere_tpu_torch.ops import quant as tquant

from .torch_parity import cross_load

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, D, NQ, K = 1500, 64, 20, 10
KNOBS = {"svs_graph_max_degree": 8, "svs_construction_window_size": 64}


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((16, D)) * 2.0
    xb = _grid(cents[rng.integers(0, 16, NB)] + rng.standard_normal((NB, D)))
    xq = _grid(cents[rng.integers(0, 16, NQ)] + rng.standard_normal((NQ, D)))
    xb[0], xb[1] = -8.0, 8.0
    return xb, xq


XB, XQ = _corpus()


def _edge_rows(seed=3):
    """Random rows, constant rows (span 0), and rows whose residuals sit on
    the grid's bin edges (off + j * scale exactly, and one ulp around)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((600, 48)) * rng.uniform(0.01, 50, (600, 1))).astype(np.float32)
    x[:10] = 1.25
    mean = x.mean(0).astype(np.float32)
    base = rng.uniform(-3, 3, (100, 1)).astype(np.float32)
    steps = rng.integers(0, 256, (100, 48)).astype(np.float32)
    steps[:, 0], steps[:, 1] = 0, 256
    r = base + steps * np.float32(1 / 64)
    x[100:200] = r + mean
    x[200:300] = np.nextafter(x[100:200], np.float32(np.inf))
    x[300:400] = np.nextafter(x[100:200], np.float32(-np.inf))
    return x


def build(pkg, name, metric, x=XB, **extra):
    idx = pkg.IndexFactory.Instance().Create(name).value()
    st = idx.Build(pkg.GenDataSetFromArray(x), dict(metric_type=metric, **extra))
    assert st == pkg.Status.success, st
    return idx


def search(idx, pkg, q=XQ, **cfg):
    res = idx.Search(pkg.GenDataSetFromArray(q), dict(k=K, **cfg), pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(q), K), res.value().distance.reshape(len(q), K)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the LVQ codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_lvq_codes_offsets_scales_bit_equal(seed):
    x = _edge_rows(seed)
    jc, tc = jquant.lvq_train(x), tquant.lvq_train(x)
    np.testing.assert_array_equal(tc.mean.view(np.uint32), jc.mean.view(np.uint32))
    (jq, jo, js), (tq, to, ts) = jquant.lvq_encode(jc, x), tquant.lvq_encode(tc, x)
    assert tq.dtype == np.uint8 and to.dtype == ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(to.view(np.uint32), jo.view(np.uint32))
    np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))
    assert (tq[100:200].astype(int) == np.clip(np.round((x[100:200] - tc.mean - to[100:200, None])
                                                        / ts[100:200, None]), 0, 255)).mean() > 0.5
    want = np.asarray(jquant.lvq_decode_dev(jnp.asarray(jq), jnp.asarray(jo), jnp.asarray(js), jnp.asarray(jc.mean)))
    np.testing.assert_allclose(tquant.lvq_decode(tq, to, ts, tc.mean), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tquant.lvq_decode(T(tq), T(to), T(ts), T(tc.mean)).numpy(),
                                  tquant.lvq_decode(tq, to, ts, tc.mean))


def _lvq_store(x):
    codec = jquant.lvq_train(x)
    codes, off, scale = jquant.lvq_encode(codec, x)
    arrays = {"codes": codes, "off": off, "scale": scale, "mean": codec.mean}
    return {k: jnp.asarray(v) for k, v in arrays.items()}, {k: T(np.array(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("bits", [4, 8])
def test_lvq_inline_table_equal(bits):
    """make_inline_store's lvq kind: the table (walk codes re-quantized on
    one grid, the decoded rows' norms), its grid and the rerank operands."""
    graph = jgraph.build_graph(XB, 16, "L2", intermediate_deg=32)
    js, ts = _lvq_store(XB)
    ji = jinline.make_inline_store(graph, "lvq", js, bits=bits)
    ti = tinline.make_inline_store(graph, "lvq", ts, bits=bits)
    assert ti.rerank_kind == "lvq" and ti.bits == ji.bits == bits
    tt, jt = ti.table.numpy(), np.asarray(ji.table)
    # ids and walk codes bit-equal; the norms of the decoded rows (not on
    # the grid) are sums of 64 f32 squares in another order: within 1e-6
    # relative (a few ulps)
    np.testing.assert_array_equal(tt[:, :16], jt[:, :16])
    np.testing.assert_array_equal(tt[:, 32:], jt[:, 32:])
    np.testing.assert_allclose(tt[:, 16:32].view(np.float32), jt[:, 16:32].view(np.float32), rtol=1e-6)
    # the grid's ends are decoded values: XLA on the CPU contracts the
    # reference's decode into an FMA where the port rounds the product first,
    # as the source writes it (ROADMAP Queue 3's FMA note): within an ulp
    np.testing.assert_allclose(ti.vmin.numpy(), np.asarray(ji.vmin), rtol=1.2e-7)
    np.testing.assert_allclose(ti.vdiff.numpy(), np.asarray(ji.vdiff), rtol=1.2e-7)
    np.testing.assert_array_equal(ti.rerank2.numpy(), np.asarray(ji.rerank2))


@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("is_l2", [True, False])
def test_lvq_walks_match_jax(inline, is_l2):
    """The lvq decode kind of the general walk and of the inline walk."""
    metric = "L2" if is_l2 else "IP"
    graph = jgraph.build_graph(XB, 16, metric, intermediate_deg=32)
    entry = jgraph.pick_entry_points(XB, n_entry=64)
    cents = XB[entry]
    js, ts = _lvq_store(XB)
    if inline:
        ji, ti = jinline.make_inline_store(graph, "lvq", js, bits=4), tinline.make_inline_store(graph, "lvq", ts, bits=4)
        kw = dict(W=2, ef=48, deg=16, n_steps=30, ring_slots=8, n_seed=8, k=K, is_l2=is_l2, has_mask=False,
                  rerank_kind="lvq", bits=4)
        sj, ij = jinline.beam_search_inline(ji.table, jnp.asarray(XQ), ji.rerank0, ji.rerank1, ji.rerank2,
                                            jnp.asarray(entry), jnp.asarray(cents), ji.vmin, ji.vdiff, None, **kw)
        st, it = tinline.beam_search_inline(ti.table, T(XQ), ti.rerank0, ti.rerank1, ti.rerank2, T(entry),
                                            T(cents), ti.vmin, ti.vdiff, None, **kw)
    else:
        kw = dict(kind="lvq", ef=48, k=K, deg=16, max_iters=60, is_l2=is_l2, beam_width=2, n_seed=8)
        sj, ij = jgraph.beam_search(jnp.asarray(XQ), js, jnp.asarray(graph), jnp.asarray(entry), None,
                                    route_cents=jnp.asarray(cents), **kw)
        st, it = tgraph.beam_search(T(XQ), ts, T(graph), T(entry), None, route_cents=T(cents), **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# the indexes
# ---------------------------------------------------------------------------


@pytest.fixture(params=["general", "inline"])
def walk(request, monkeypatch):
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1" if request.param == "inline" else "auto")
    return request.param


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_svs_vamana_lvq_matches_jax(metric, walk):
    """The LVQ payload bit-equal, the graph, the walk's ids, and BinarySets
    both ways."""
    jidx = build(kt, "SVS_VAMANA_LVQ", metric, **KNOBS)
    tidx = build(ktt, "SVS_VAMANA_LVQ", metric, **KNOBS)
    assert tidx.node._kind == "lvq" and (tidx.node._inline is not None) == (walk == "inline")
    for key in ("codes", "lvq_mean", "lvq_off", "lvq_scale"):
        np.testing.assert_array_equal(np.asarray(tidx.node._payload[key]), np.asarray(jidx.node._payload[key]))
    np.testing.assert_array_equal(tidx.node._graph, jidx.node._graph)
    cfg = {"metric_type": metric, "svs_search_window_size": 32}
    want = search(jidx, kt, **cfg)
    assert_same(search(tidx, ktt, **cfg), want)
    assert_same(search(cross_load(jidx, ktt), ktt, **cfg), want)
    assert_same(search(cross_load(tidx, kt), kt, **cfg), want)
    assert_same(search(tidx, ktt, **cfg, refine_k=3), search(jidx, kt, **cfg, refine_k=3))


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_svs_vamana_leanvec_matches_jax(metric):
    """The PCA basis (numpy eigh on both sides), the reduced walk store, the
    projected routing centroids, the full-width rerank of the window, and
    BinarySets both ways."""
    jidx = build(kt, "SVS_VAMANA_LEANVEC", metric, svs_leanvec_dim=16, **KNOBS)
    tidx = build(ktt, "SVS_VAMANA_LEANVEC", metric, svs_leanvec_dim=16, **KNOBS)
    assert tidx.node._lv_proj.shape == (D, 16) and tidx.node._inline is None
    np.testing.assert_array_equal(tidx.node._lv_proj, jidx.node._lv_proj)
    np.testing.assert_array_equal(np.asarray(tidx.node._payload["data_lv"]), np.asarray(jidx.node._payload["data_lv"]))
    np.testing.assert_array_equal(tidx.node._graph, jidx.node._graph)
    cfg = {"metric_type": metric, "ef": 40}
    want = search(jidx, kt, **cfg)
    assert_same(search(tidx, ktt, **cfg), want)
    assert_same(search(cross_load(jidx, ktt), ktt, **cfg), want)
    assert_same(search(cross_load(tidx, kt), kt, **cfg), want)


def test_leanvec_default_dim_and_routing(monkeypatch):
    """svs_leanvec_dim unset (or >= dim) reduces to dim / 2; with routed
    entries the centroids are projected into the reduced frame."""
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")  # k-means routing at this size
    jidx = build(kt, "SVS_VAMANA_LEANVEC", "L2", **KNOBS)
    tidx = build(ktt, "SVS_VAMANA_LEANVEC", "L2", svs_leanvec_dim=D, **KNOBS)
    assert tidx.node._lv_proj.shape == (D, D // 2) and tidx.node._inline is None
    np.testing.assert_allclose(tidx.node._entry_cents_dev.numpy(), np.asarray(jidx.node._entry_cents_dev),
                               rtol=1e-6, atol=1e-6)
    assert_same(search(tidx, ktt, metric_type="L2", ef=40), search(jidx, kt, metric_type="L2", ef=40))


def test_svs_lvq_add_after_build_matches_jax():
    """Add encodes with the trained mean: an insert, then a rebuild, as the
    JAX package."""
    out = {}
    for pkg in (kt, ktt):
        idx = build(pkg, "SVS_VAMANA_LVQ", "L2", x=XB[:1100], **KNOBS)
        idx.Add(pkg.GenDataSetFromArray(XB[1100:1300]), {"metric_type": "L2"})
        first = search(idx, pkg, metric_type="L2", ef=32)
        idx.Add(pkg.GenDataSetFromArray(XB[1300:]), {"metric_type": "L2"})
        out[pkg] = first, search(idx, pkg, metric_type="L2", ef=32), idx.node
    assert_same(out[ktt][0], out[kt][0])
    assert_same(out[ktt][1], out[kt][1])
    np.testing.assert_array_equal(out[ktt][2]._graph, out[kt][2]._graph)
    for key in ("codes", "lvq_off", "lvq_scale"):
        np.testing.assert_array_equal(np.asarray(out[ktt][2]._payload[key]), np.asarray(out[kt][2]._payload[key]))


def test_leanvec_add_after_build():
    """An Add of <= 20% inserts: the port walks the reduced store with the
    projected rows (the reference walks it with full-width rows and fails:
    ROADMAP Queue 3), the rows are projected on the trained basis, and each
    added row finds itself; a larger Add rebuilds as the JAX package does."""
    jidx = build(kt, "SVS_VAMANA_LEANVEC", "L2", x=XB[:1100], svs_leanvec_dim=16, **KNOBS)
    jidx.Add(kt.GenDataSetFromArray(XB[1100:1300]), {"metric_type": "L2"})
    assert not jidx.Search(kt.GenDataSetFromArray(XQ), {"metric_type": "L2", "k": K}, kt.BitsetView()).has_value()
    tidx = build(ktt, "SVS_VAMANA_LEANVEC", "L2", x=XB[:1100], svs_leanvec_dim=16, **KNOBS)
    proj, mean = tidx.node._lv_proj.copy(), tidx.node._lv_mean.copy()
    tidx.Add(ktt.GenDataSetFromArray(XB[1100:1300]), {"metric_type": "L2"})
    top1, _ = search(tidx, ktt, q=XB[1100:1300], metric_type="L2", ef=32)
    assert tidx.node._graph.shape[0] == 1300 and (top1[:, 0] == np.arange(1100, 1300)).mean() >= 0.95
    np.testing.assert_array_equal(np.asarray(tidx.node._payload["data_lv"])[1100:],
                                  ((XB[1100:1300] - mean) @ proj).astype(np.float32))
    rebuilt = {}
    for pkg in (kt, ktt):
        idx = build(pkg, "SVS_VAMANA_LEANVEC", "L2", x=XB[:1100], svs_leanvec_dim=16, **KNOBS)
        idx.Add(pkg.GenDataSetFromArray(XB[1100:]), {"metric_type": "L2"})
        rebuilt[pkg] = search(idx, pkg, metric_type="L2", ef=32)
    assert_same(rebuilt[ktt], rebuilt[kt])


def test_svs_vamana_and_flat_match_jax():
    for name, knobs in (("SVS_VAMANA", KNOBS), ("SVS_FLAT", {})):
        jidx, tidx = build(kt, name, "L2", **knobs), build(ktt, name, "L2", **knobs)
        assert_same(search(tidx, ktt, metric_type="L2", ef=32), search(jidx, kt, metric_type="L2", ef=32))
    assert type(tidx.node).__name__ == "FlatIndexNode"


@pytest.mark.parametrize("json_cfg,stage", [
    ({"svs_graph_max_degree": 24, "svs_construction_window_size": 99}, "TRAIN"),
    ({"svs_search_window_size": 77}, "SEARCH"),
    ({"svs_search_window_size": 77, "ef": 12}, "SEARCH"),
    ({"svs_alpha": 1.2, "svs_storage_kind": "lvq8", "svs_leanvec_dim": 32}, "TRAIN"),
    ({"svs_alpha": 9.0}, "TRAIN"),
])
def test_svs_knob_mapping_matches_jax(json_cfg, stage):
    """svs_graph_max_degree -> M, svs_construction_window_size ->
    efConstruction, svs_search_window_size -> ef unless ef is given; the
    ranges and their Status codes."""
    from knowhere_tpu.models.svs import SvsVamanaConfig as JCfg
    from knowhere_tpu_torch.models.svs import SvsVamanaConfig as TCfg

    base = {"metric_type": "L2", "k": 10}
    jc, tc = JCfg(), TCfg()
    js = JConfig.load(jc, dict(base, **json_cfg), getattr(JStage, stage))
    ts = TConfig.load(tc, dict(base, **json_cfg), getattr(TStage, stage))
    assert ts[0].name == js[0].name
    for key in ("M", "efConstruction", "ef", "svs_alpha", "svs_storage_kind", "svs_leanvec_dim"):
        assert tc.get(key) == jc.get(key), key
