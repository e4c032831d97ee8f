"""The SHARDED_* nodes of the port (knowhere_tpu_torch/models/sharded.py) on
the CPU: the checks of tests/test_sharded_nodes.py on a device list of the
CPU repeated 8 times (the JAX tests run on 8 CPU devices), and the nodes
held against the JAX package's: the same build inputs on both at 4 shards,
and BinarySets cross-loaded both ways at the same shard count.

Tolerance of every comparison with the JAX package: distances within 1e-5
relative + 1e-4 absolute; ids equal except between distances that close
(both compute the same f32 products and sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.ops import graph_inline as GI

from .test_torch_sharding import assert_near_tie_parity

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 4000, 24, 64, 10

CASES = [
    ("SHARDED_FLAT", {"metric_type": "L2", "k": K}, 0.99),
    ("SHARDED_IVF_FLAT", {"metric_type": "L2", "k": K, "nlist": 32, "nprobe": 32}, 0.99),
    ("SHARDED_IVF_SQ8", {"metric_type": "L2", "k": K, "nlist": 32, "nprobe": 32}, 0.9),
    ("SHARDED_IVF_PQ", {"metric_type": "L2", "k": K, "nlist": 32, "nprobe": 32, "m": 16}, 0.3),
    ("SHARDED_HNSW", {"metric_type": "L2", "k": K, "M": 16, "efConstruction": 64, "ef": 96}, 0.6),
]
NAMES = [c[0] for c in CASES]
CFG = {c[0]: c[1] for c in CASES}


def DS(x, pkg=ktt):
    return pkg.GenDataSetFromArray(np.asarray(x, np.float32))


def devices(pkg, n):
    return jax.devices()[:n] if pkg is kt else ["cpu"] * n


def create(pkg, name, n_shards):
    e = pkg.IndexFactory.Instance().Create(name, object=devices(pkg, n_shards))
    assert e.has_value(), e.what()
    return e.value()


def build(pkg, name, xb, cfg, n_shards):
    idx = create(pkg, name, n_shards)
    assert idx.Build(DS(xb, pkg), cfg) == pkg.Status.success
    return idx


def search(pkg, idx, xq, cfg, keep_out=None):
    """(ids, distances), each (nq, k); keep_out: bool rows to filter out."""
    bitset = pkg.BitsetView.from_bool_array(keep_out) if keep_out is not None else pkg.BitsetView()
    r = idx.Search(DS(xq, pkg), cfg, bitset)
    assert r.has_value(), r.what()
    k = cfg["k"]
    return r.value().ids.reshape(-1, k), r.value().distance.reshape(-1, k)


def load(src_pkg, src_idx, dst_pkg, n_shards):
    """src_idx's BinarySet bytes loaded into a fresh node of dst_pkg over
    n_shards devices."""
    bs = src_pkg.BinarySet()
    assert src_idx.Serialize(bs) == src_pkg.Status.success
    bs2 = dst_pkg.BinarySet()
    for name in bs:
        bs2.Append(name, bs.GetByName(name).tobytes())
    idx = create(dst_pkg, src_idx.Type(), n_shards)
    assert idx.Deserialize(bs2) == dst_pkg.Status.success
    return idx


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((NB, DIM), dtype=np.float32)
    xq = rng.standard_normal((NQ, DIM), dtype=np.float32)
    gt = ktt.BruteForce.Search(DS(xb), DS(xq), {"metric_type": "L2", "k": K}, ktt.BitsetView())
    filtered = np.zeros(NB, dtype=bool)
    filtered[np.random.default_rng(13).choice(NB, size=int(NB * 0.3), replace=False)] = True
    return xb, xq, gt.value().ids.reshape(NQ, K), filtered


@pytest.fixture(scope="module")
def port8(data):
    """The port's node of each name over 8 shards, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = build(ktt, name, data[0], CFG[name], 8)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def pair4(data):
    """(JAX node, port node) of each name over 4 shards, built once each on
    the same rows."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (build(kt, name, data[0], CFG[name], 4), build(ktt, name, data[0], CFG[name], 4))
        return cache[name]

    return get


def _recall(ids, gtids):
    return np.mean([len(set(ids[i]) & set(gtids[i])) / K for i in range(NQ)])


@pytest.mark.parametrize("name,cfg,floor", CASES)
def test_sharded_build_search_recall(name, cfg, floor, data, port8):
    xb, xq, gtids, _ = data
    idx = port8(name)
    assert idx.Count() == NB and idx.Dim() == DIM
    ids, _ = search(ktt, idx, xq, cfg)
    assert _recall(ids, gtids) >= floor


@pytest.mark.parametrize("name,cfg,floor", CASES)
def test_sharded_bitset_filtering(name, cfg, floor, data, port8):
    _, xq, _, filtered = data
    ids, _ = search(ktt, port8(name), xq, cfg, filtered)
    valid = ids[ids >= 0]
    assert valid.size > 0
    assert not filtered[valid].any(), "returned a filtered-out row"


@pytest.mark.parametrize("name,cfg,floor", [c for c in CASES if c[0] != "SHARDED_FLAT"])
def test_sharded_serialize_roundtrip(name, cfg, floor, data, port8):
    """A round trip onto the same 8 shards gives the same ids; onto the
    default device list (one shard here) the same ids but near-ties."""
    _, xq, _, _ = data
    idx = port8(name)
    ids0, d0 = search(ktt, idx, xq, cfg)
    again = load(ktt, idx, ktt, 8)
    assert again.Count() == NB
    ids1, _ = search(ktt, again, xq, cfg)
    assert (ids0 == ids1).mean() > 0.95
    bs = ktt.BinarySet()
    assert idx.Serialize(bs) == ktt.Status.success
    one = ktt.IndexFactory.Instance().Create(name).value()
    assert one.Deserialize(bs) == ktt.Status.success
    assert len(one.node._engine.devices) == 1
    ids2, d2 = search(ktt, one, xq, cfg)
    if name != "SHARDED_HNSW":  # a graph keeps its 8 shards' graphs, now walked on one device
        assert_near_tie_parity(ids0, d0, ids2, d2)
    else:
        np.testing.assert_array_equal(ids2, ids0)


def test_sharded_flat_serialize_roundtrip(data):
    xb, xq, gtids, _ = data
    cfg = {"metric_type": "L2", "k": K}
    idx = build(ktt, "SHARDED_FLAT", xb, cfg, 8)
    again = load(ktt, idx, ktt, 8)
    ids, _ = search(ktt, again, xq, cfg)
    assert _recall(ids, gtids) == 1.0


def test_sharded_get_vector_by_ids(data):
    xb = data[0]
    cfg = {"metric_type": "L2", "k": K}
    for name in ("SHARDED_FLAT", "SHARDED_IVF_FLAT", "SHARDED_HNSW"):
        c = dict(cfg)
        if name == "SHARDED_IVF_FLAT":
            c.update(nlist=16, nprobe=16)
        if name == "SHARDED_HNSW":
            c.update(M=8, efConstruction=32)
        idx = build(ktt, name, xb, c, 8)
        want = np.asarray([0, 17, NB - 1], dtype=np.int64)
        ds = ktt.DataSet()
        ds.set("ids", want)
        ds.rows = len(want)
        r = idx.GetVectorByIds(ds)
        assert r.has_value(), (name, r.what())
        np.testing.assert_allclose(np.asarray(r.value().tensor).reshape(len(want), DIM), xb[want], rtol=1e-6)


def test_sharded_cosine(data):
    xb, xq, _, _ = data
    cfg = {"metric_type": "COSINE", "k": K, "nlist": 32, "nprobe": 32}
    gt = ktt.BruteForce.Search(DS(xb), DS(xq), {"metric_type": "COSINE", "k": K}, ktt.BitsetView())
    gtids = gt.value().ids.reshape(NQ, K)
    for name in ("SHARDED_FLAT", "SHARDED_IVF_FLAT"):
        idx = build(ktt, name, xb, cfg, 8)
        ids, d = search(ktt, idx, xq, cfg)
        assert _recall(ids, gtids) >= 0.95
        # cosine returns similarities (larger = closer), in [-1, 1]
        assert (d[:, 0] + 1e-5 >= d[:, -1]).all()
        assert d.max() <= 1.0 + 1e-4


def test_sharded_ivfpq_refine_recall_at_scale():
    """The 100,000-row SHARDED_IVF_PQ + refine tier of
    tests/test_sharded_nodes.py: refine honoured gives 0.93 on this corpus,
    refine ignored 0.50, so the 0.85 floor tells them apart."""
    nb, nq, dim, k = 100_000, 64, 48, 10
    rng = np.random.default_rng(5)
    nc, intr = 100, 16
    centers = rng.standard_normal((nc, dim)).astype(np.float32)
    centers *= rng.uniform(0.9, 1.6, size=(nc, 1)).astype(np.float32)
    W = rng.standard_normal((intr, dim)).astype(np.float32)
    W *= np.sqrt(dim / intr) / np.sqrt(intr)
    xb = centers[rng.integers(0, nc, nb)] + (rng.standard_normal((nb, intr)).astype(np.float32) @ W)
    xq = centers[rng.integers(0, nc, nq)] + (rng.standard_normal((nq, intr)).astype(np.float32) @ W)
    d2 = (xq**2).sum(1)[:, None] - 2.0 * xq @ xb.T + (xb**2).sum(1)[None, :]
    gt = np.argsort(d2, 1)[:, :k]
    cfg = {"metric_type": "L2", "k": k, "nlist": 128, "nprobe": 16, "m": 6, "nbits": 8, "refine": True,
           "refine_type": "FP16", "refine_k": 8}
    idx = build(ktt, "SHARDED_IVF_PQ", xb, cfg, 8)
    assert all("refine" in sh["store"] for sh in idx.node._engine._shards)
    ids, _ = search(ktt, idx, xq, cfg)
    rec = np.mean([len(set(ids[i]) & set(gt[i])) / k for i in range(nq)])
    assert rec >= 0.85, f"sharded refine recall regressed: {rec:.4f}"


def test_sharded_rejects_unknown_metric():
    xb = np.random.default_rng(0).standard_normal((256, 16), dtype=np.float32)
    for name in NAMES:
        idx = create(ktt, name, 2)
        assert idx.Build(DS(xb), {"metric_type": "HAMMING", "k": 4}) == ktt.Status.invalid_metric_type


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_search_matches_jax(name, data, pair4):
    """The same rows built by both packages over 4 shards: the same answers,
    unfiltered and under the 30% bitset."""
    _, xq, _, filtered = data
    jidx, tidx = pair4(name)
    for out in (None, filtered):
        i_j, d_j = search(kt, jidx, xq, CFG[name], out)
        i_t, d_t = search(ktt, tidx, xq, CFG[name], out)
        assert_near_tie_parity(i_j, d_j, i_t, d_t)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_load(name, direction, data, pair4):
    """A BinarySet of one package loaded by the other over the same 4
    shards answers as the node that wrote it."""
    _, xq, _, filtered = data
    jidx, tidx = pair4(name)
    src_pkg, src, dst_pkg = (kt, jidx, ktt) if direction == "jax_to_port" else (ktt, tidx, kt)
    dst = load(src_pkg, src, dst_pkg, 4)
    assert dst.Count() == NB and dst.Dim() == DIM
    for out in (None, filtered):
        i_s, d_s = search(src_pkg, src, xq, CFG[name], out)
        i_d, d_d = search(dst_pkg, dst, xq, CFG[name], out)
        assert_near_tie_parity(i_s, d_s, i_d, d_d)


def test_flat_ann_iterator_matches_jax(data):
    xb, xq, _, filtered = data
    cfg = {"metric_type": "L2", "k": K}
    bits = {pkg: pkg.BitsetView.from_bool_array(filtered) for pkg in (kt, ktt)}
    its = {}
    for pkg in (kt, ktt):
        idx = build(pkg, "SHARDED_FLAT", xb, cfg, 4)
        r = idx.AnnIterator(DS(xq[:3], pkg), cfg, bits[pkg])
        assert r.has_value(), r.what()
        its[pkg] = r.value()
    for it_j, it_t in zip(its[kt], its[ktt]):
        got_j = [it_j.Next() for _ in range(50)]
        got_t = [it_t.Next() for _ in range(50)]
        np.testing.assert_allclose([d for _, d in got_t], [d for _, d in got_j], rtol=1e-5, atol=1e-4)
        assert not filtered[[i for i, _ in got_t]].any()


def test_hnsw_dense_filter_takes_the_exact_scan(data, port8):
    """A 5% keep bitset (keep-mean < 0.12) routes SHARDED_HNSW to the exact
    scan: BruteForce's ids and distances."""
    xb, xq, _, _ = data
    out = np.random.default_rng(3).random(NB) >= 0.05
    cfg = CFG["SHARDED_HNSW"]
    ids, d = search(ktt, port8("SHARDED_HNSW"), xq, cfg, out)
    want = ktt.BruteForce.Search(DS(xb), DS(xq), {"metric_type": "L2", "k": K}, ktt.BitsetView.from_bool_array(out))
    assert_near_tie_parity(want.value().ids.reshape(NQ, K), want.value().distance.reshape(NQ, K), ids, d)
    assert not out[ids].any()


def test_second_add_not_implemented(data):
    xb = data[0][:500]
    for name, cfg in (("SHARDED_IVF_FLAT", {"metric_type": "L2", "nlist": 8}),
                      ("SHARDED_HNSW", {"metric_type": "L2", "M": 8, "efConstruction": 32})):
        idx = build(ktt, name, xb, cfg, 2)
        node = idx.node
        assert node.Add(DS(xb), node.CreateConfig()) == ktt.Status.not_implemented


def test_default_device_list_on_the_cpu(data):
    """Without an explicit list the port shards over its own device: one
    shard when the caller selected the CPU."""
    xb, xq, _, _ = data
    idx = ktt.IndexFactory.Instance().Create("SHARDED_IVF_FLAT").value()
    assert idx.Build(DS(xb), CFG["SHARDED_IVF_FLAT"]) == ktt.Status.success
    assert idx.node._engine.devices == [torch.device("cpu")]
    assert len(idx.node._engine._shards) == 1


def test_cuda_without_a_card_fails_the_build(data, monkeypatch):
    """CUDA selected and no card visible: Build fails with a Status, nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    idx = ktt.IndexFactory.Instance().Create("SHARDED_FLAT").value()
    ktt.set_device("cuda")
    try:
        st = idx.Build(DS(data[0][:100]), {"metric_type": "L2"})
        assert st == ktt.Status.success  # SHARDED_FLAT places its rows at the first search
        assert not idx.Search(DS(data[1]), {"metric_type": "L2", "k": K}, ktt.BitsetView()).has_value()
        hnsw = ktt.IndexFactory.Instance().Create("SHARDED_HNSW").value()
        assert hnsw.Build(DS(data[0][:100]), {"metric_type": "L2", "M": 8}) == ktt.Status.internal_error
    finally:
        ktt.set_device("cpu")


def test_failing_inline_build_fails_the_build(data, monkeypatch):
    """The per-shard inline walk's build: a failure makes Build fail (the
    reference drops the shard to the general walk in silence); None (the
    kind or width does not fit) leaves the shard on the general walk."""
    xb, xq, _, _ = data
    cfg = {"metric_type": "L2", "k": K, "M": 8, "efConstruction": 32, "ef": 32}
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")

    def broken(*args, **kw):
        raise RuntimeError("inline table build failed")

    monkeypatch.setattr(GI, "make_inline_store", broken)
    idx = create(ktt, "SHARDED_HNSW", 2)
    assert idx.Build(DS(xb), cfg) == ktt.Status.internal_error
    monkeypatch.setattr(GI, "make_inline_store", lambda *a, **k: None)
    idx = build(ktt, "SHARDED_HNSW", xb, cfg, 2)
    assert not any("inline" in sh for sh in idx.node._engine._shards)
    ids, _ = search(ktt, idx, xq, cfg)
    assert (ids >= 0).all()
    monkeypatch.undo()
    monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")
    idx = build(ktt, "SHARDED_HNSW", xb, cfg, 2)
    assert all(sh["inline"].bits == 8 for sh in idx.node._engine._shards)
