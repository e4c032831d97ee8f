"""IVF_FLAT end to end: the port against the JAX package on one corpus.

The JAX package builds the index (its Pallas kernels in interpret mode, as
tests/test_pallas_interpret_e2e.py runs them) and the port loads the same
state, directly through load_state and through the KWTPU bytes; both then
search the same queries through the public API. FAST precision goes through
the int8 scan + exact rerank on both sides, EXACT through the full-f32 task
scan. The port's own Build is held by recall, as the JAX tier is.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.io.serialize import read_sections
from knowhere_tpu.ops import kmeans as jkmeans
from knowhere_tpu.ops.distances import DistancePrecision as JP
from knowhere_tpu.ops.distances import set_distance_precision as jset_prec
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.ops import kmeans as tkmeans
from knowhere_tpu_torch.ops.distances import DistancePrecision as TP
from knowhere_tpu_torch.ops.distances import set_distance_precision as tset_prec

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    saved = {k: os.environ.get(k) for k in ("KNOWHERE_PALLAS_INTERPRET", "KNOWHERE_IVF_ALIGN_MIN")}
    os.environ["KNOWHERE_PALLAS_INTERPRET"] = "1"
    os.environ["KNOWHERE_IVF_ALIGN_MIN"] = "4096"  # aligned lists at test scale
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jset_prec(JP.EXACT)
    tset_prec(TP.EXACT)


def _precision(fast: bool):
    jset_prec(JP.FAST if fast else JP.EXACT)
    tset_prec(TP.FAST if fast else TP.EXACT)


@pytest.fixture(scope="module")
def corpus():
    # the generator of tests/test_pallas_interpret_e2e.py, with more queries
    rng = np.random.default_rng(0)
    nc, intr = 64, 32
    centers = rng.standard_normal((nc, DIM)).astype(np.float32)
    W = rng.standard_normal((intr, DIM)).astype(np.float32) * np.sqrt(DIM / intr) / np.sqrt(intr)
    xb = centers[rng.integers(0, nc, NB)] + rng.standard_normal((NB, intr)).astype(np.float32) @ W
    xq = centers[rng.integers(0, nc, NQ)] + rng.standard_normal((NQ, intr)).astype(np.float32) @ W
    d2 = (xq**2).sum(1)[:, None] - 2.0 * xq @ xb.T + (xb**2).sum(1)[None, :]
    gt = np.argsort(d2, 1)[:, :K]
    return xb, xq, gt


@pytest.fixture(scope="module")
def jax_index(corpus):
    xb, _, _ = corpus
    idx = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": NLIST}) == kt.Status.success
    return idx


def _jax_state(jidx):
    bs = kt.BinarySet()
    assert jidx.Serialize(bs) == kt.Status.success
    return bs.GetByName("IVF_FLAT").tobytes()


@pytest.fixture(scope="module")
def port_loaded(jax_index):
    """The port holding the JAX-built state, via load_state on the node."""
    n = jax_index.node
    arrays = {
        "centroids": n._centroids, "row_ids": n._row_ids, "offsets": n._offsets,
        "lengths": n._lengths, "payload_data": np.asarray(n._sorted_payload["data"]),
    }
    meta = {"variant": "flat", "metric": n._metric, "dim": n._dim, "nlist": n._nlist,
            "data_type": n.data_type, "refine_cfg": None}
    idx = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    idx.node.load_state(arrays, meta)
    return idx


def _search(idx, pkg, xq, bitset=None):
    res = idx.Search(pkg.GenDataSetFromArray(xq), SEARCH, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(-1, K), res.value().distance.reshape(-1, K)


def _recall(ids, gt):
    return np.mean([len(set(ids[i]) & set(gt[i])) / K for i in range(len(gt))])


def _assert_parity(ids_j, d_j, ids_t, d_t, gt):
    same = ids_j == ids_t
    assert same.mean() >= 0.99
    assert abs(_recall(ids_j, gt) - _recall(ids_t, gt)) <= 0.01
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-5)


def test_fast_search_matches_jax(corpus, jax_index, port_loaded, monkeypatch):
    _, xq, gt = corpus
    hits = []
    orig = tscan._int8_search
    monkeypatch.setattr(tscan, "_int8_search", lambda *a, **kw: hits.append(1) or orig(*a, **kw))
    _precision(True)
    ids_j, d_j = _search(jax_index, kt, xq)
    ids_t, d_t = _search(port_loaded, ktt, xq)
    assert hits, "FAST search did not take the int8 scan"
    _assert_parity(ids_j, d_j, ids_t, d_t, gt)
    assert _recall(ids_t, gt) >= 0.9


def test_exact_search_identical_ids(corpus, jax_index, port_loaded):
    _, xq, _ = corpus
    _precision(False)
    ids_j, d_j = _search(jax_index, kt, xq)
    ids_t, d_t = _search(port_loaded, ktt, xq)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fast", [True, False])
def test_filtered_search_matches_jax(corpus, jax_index, port_loaded, fast):
    _, xq, _ = corpus
    drop = np.random.default_rng(1).random(NB) < 0.5
    _precision(fast)
    ids_j, d_j = _search(jax_index, kt, xq, kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = _search(port_loaded, ktt, xq, ktt.BitsetView.from_bool_array(drop))
    valid = ids_t[ids_t >= 0]
    assert valid.size > 0 and not drop[valid].any()
    keep = np.nonzero(~drop)[0]
    xb = corpus[0]
    d2 = (xq**2).sum(1)[:, None] - 2.0 * xq @ xb[keep].T + (xb[keep] ** 2).sum(1)[None, :]
    gt = keep[np.argsort(d2, 1)[:, :K]]
    _assert_parity(ids_j, d_j, ids_t, d_t, gt)


def test_binaryset_bytes_cross_load_both_ways(corpus, jax_index, port_loaded):
    _, xq, _ = corpus
    _precision(True)
    # JAX bytes -> port
    bs_t = ktt.BinarySet()
    bs_t.Append("IVF_FLAT", _jax_state(jax_index))
    idx_t = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx_t.Deserialize(bs_t) == ktt.Status.success
    np.testing.assert_array_equal(_search(idx_t, ktt, xq)[0], _search(port_loaded, ktt, xq)[0])
    # port bytes -> JAX
    bs_p = ktt.BinarySet()
    assert port_loaded.Serialize(bs_p) == ktt.Status.success
    bs_j = kt.BinarySet()
    bs_j.Append("IVF_FLAT", bs_p.GetByName("IVF_FLAT").tobytes())
    idx_j = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx_j.Deserialize(bs_j) == kt.Status.success
    np.testing.assert_array_equal(_search(idx_j, kt, xq)[0], _search(jax_index, kt, xq)[0])


def test_port_serialize_then_jax_deserialize(corpus):
    """A port-built index, serialized, serves the same results in JAX."""
    xb, xq, gt = corpus
    _precision(True)
    idx_t = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx_t.Build(ktt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": NLIST}) == ktt.Status.success
    ids_t, d_t = _search(idx_t, ktt, xq)
    assert _recall(ids_t, gt) >= 0.9
    bs = ktt.BinarySet()
    assert idx_t.Serialize(bs) == ktt.Status.success
    bs_j = kt.BinarySet()
    bs_j.Append("IVF_FLAT", bs.GetByName("IVF_FLAT").tobytes())
    idx_j = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx_j.Deserialize(bs_j) == kt.Status.success
    ids_j, d_j = _search(idx_j, kt, xq)
    _assert_parity(ids_j, d_j, ids_t, d_t, gt)


def test_int8_sidecar_bit_equal(jax_index, port_loaded):
    js, ts = jax_index.node._store, port_loaded.node._store
    np.testing.assert_array_equal(ts["data_i8"].numpy(), np.asarray(js["data_i8"]))
    for key in ("i8_scale", "i8_mu"):
        np.testing.assert_array_equal(
            ts[key].numpy().view(np.uint32), np.asarray(js[key]).view(np.uint32)
        )
    np.testing.assert_array_equal(ts["i8_nrm"].numpy(), np.asarray(js["i8_nrm_blk"]).reshape(-1))


def test_kmeans_lloyd_step_matches_jax(corpus):
    xb = corpus[0][:4096]
    cents = xb[np.random.default_rng(2).choice(len(xb), NLIST, replace=False)]
    new_j, counts_j = jkmeans._lloyd_step(jnp.asarray(xb), jnp.asarray(cents), k=NLIST)
    new_t, counts_t = tkmeans._lloyd_step(torch.from_numpy(xb), torch.from_numpy(cents), k=NLIST)
    assign_j = np.asarray(jkmeans._assign_block(jnp.asarray(xb), jnp.asarray(cents)))
    assign_t = tkmeans._assign_block(torch.from_numpy(xb), torch.from_numpy(cents)).numpy()
    np.testing.assert_array_equal(assign_t, assign_j)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), atol=1e-5)


def test_port_build_recall_at_equal_knob(corpus):
    """A full k-means run is held by recall, not by identical centroids."""
    xb, xq, gt = corpus
    _precision(False)
    idx = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": NLIST}) == ktt.Status.success
    assert _recall(_search(idx, ktt, xq)[0], gt) >= 0.9


@pytest.mark.parametrize(
    "name,cfg",
    [
        ("IVF_FLAT", {"metric_type": "L2", "nlist": 8}),
        ("IVF_SQ8", {"metric_type": "L2", "nlist": 8, "refine": True, "refine_type": "FP16"}),
        ("IVF_RABITQ", {"metric_type": "L2", "nlist": 8}),
    ],
)
def test_chunked_upload_bit_equal(name, cfg, monkeypatch):
    """Deserialize fills the device store in row chunks (UPLOAD_CHUNK_BYTES,
    here small enough for many chunks) at d=100, padded to 128 columns: the
    rows, their norms (an f64 einsum per chunk) and the refine rows are bit
    for bit what one whole-array f64 einsum and np.pad give."""
    from knowhere_tpu_torch.models import ivf as tivf

    xb = np.random.default_rng(3).standard_normal((3000, 100)).astype(np.float32)
    built = ktt.IndexFactory.Instance().Create(name).value()
    assert built.Build(ktt.GenDataSetFromArray(xb), cfg) == ktt.Status.success
    bs = ktt.BinarySet()
    assert built.Serialize(bs) == ktt.Status.success
    monkeypatch.setattr(tivf, "UPLOAD_CHUNK_BYTES", 4096)  # 10 rows of 400 bytes a chunk
    idx = ktt.IndexFactory.Instance().Create(name).value()
    assert idx.Deserialize(bs) == ktt.Status.success
    node = idx.node
    assert node._d_dev == 128
    payload = node._sorted_payload
    if "data" in payload:
        data = np.asarray(payload["data"])
        n = data.shape[0]
        want = np.zeros(n + tivf.B_SLACK, np.float32)
        want[:n] = np.einsum("ij,ij->i", data, data, dtype=np.float64)
        np.testing.assert_array_equal(node._store["norms"].numpy().view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(node._store["data"].numpy()[:n], np.pad(data, ((0, 0), (0, 28))))
        assert not node._store["data"].numpy()[n:].any()
    if name == "IVF_SQ8":
        codes = np.asarray(payload["codes"])
        got = node._store["codes"].numpy()
        np.testing.assert_array_equal(got[: len(codes)], np.pad(codes, ((0, 0), (0, 28))))
        assert got.shape[0] == len(codes) + tivf.B_SLACK and not got[len(codes):].any()
    if "refine" in payload:
        ref = np.asarray(payload["refine"])
        got = node._refine_store.data.numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view(np.uint8), np.pad(ref, ((0, 0), (0, 28))).view(np.uint8))
    else:
        assert name == "IVF_FLAT"
