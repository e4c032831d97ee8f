"""IVF_FLAT end to end: the port against the JAX package on one corpus.

The JAX package builds the index (its Pallas kernels in interpret mode, as
tests/test_pallas_interpret_e2e.py runs them) and the port loads the same
state, directly through load_state and through the KWTPU bytes; both then
search the same queries through the public API. FAST precision goes through
the int8 scan + exact rerank on both sides, EXACT through the full-f32 task
scan. The port's own Build is held by recall, as the JAX tier is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import kmeans as jkmeans
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.ops import kmeans as tkmeans

from .torch_parity import build, cross_load, interpret_env, ivf_corpus, recall, search, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


@pytest.fixture(scope="module")
def corpus():
    return ivf_corpus(NB, NQ, DIM, K)


@pytest.fixture(scope="module")
def jax_index(corpus):
    return build(kt, "IVF_FLAT", corpus[0], {"metric_type": "L2", "nlist": NLIST})


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
    return search(idx, pkg, xq, SEARCH, bitset)


def _assert_parity(ids_j, d_j, ids_t, d_t, gt):
    same = ids_j == ids_t
    assert same.mean() >= 0.99
    assert abs(recall(ids_j, gt) - recall(ids_t, gt)) <= 0.01
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-5)


def test_fast_search_matches_jax(corpus, jax_index, port_loaded, monkeypatch):
    _, xq, gt = corpus
    hits = []
    orig = tscan._int8_search
    monkeypatch.setattr(tscan, "_int8_search", lambda *a, **kw: hits.append(1) or orig(*a, **kw))
    set_precision(True)
    ids_j, d_j = _search(jax_index, kt, xq)
    ids_t, d_t = _search(port_loaded, ktt, xq)
    assert hits, "FAST search did not take the int8 scan"
    _assert_parity(ids_j, d_j, ids_t, d_t, gt)
    assert recall(ids_t, gt) >= 0.9


def test_exact_search_identical_ids(corpus, jax_index, port_loaded):
    _, xq, _ = corpus
    set_precision(False)
    ids_j, d_j = _search(jax_index, kt, xq)
    ids_t, d_t = _search(port_loaded, ktt, xq)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fast", [True, False])
def test_filtered_search_matches_jax(corpus, jax_index, port_loaded, fast):
    _, xq, _ = corpus
    drop = np.random.default_rng(1).random(NB) < 0.5
    set_precision(fast)
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
    set_precision(True)
    # JAX bytes -> port
    idx_t = cross_load(jax_index, ktt)
    np.testing.assert_array_equal(_search(idx_t, ktt, xq)[0], _search(port_loaded, ktt, xq)[0])
    # port bytes -> JAX
    idx_j = cross_load(port_loaded, kt)
    np.testing.assert_array_equal(_search(idx_j, kt, xq)[0], _search(jax_index, kt, xq)[0])


def test_port_serialize_then_jax_deserialize(corpus):
    """A port-built index, serialized, serves the same results in JAX."""
    xb, xq, gt = corpus
    set_precision(True)
    idx_t = build(ktt, "IVF_FLAT", xb, {"metric_type": "L2", "nlist": NLIST})
    ids_t, d_t = _search(idx_t, ktt, xq)
    assert recall(ids_t, gt) >= 0.9
    ids_j, d_j = _search(cross_load(idx_t, kt), kt, xq)
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


@pytest.mark.parametrize("skewed", [False, True])
def test_cluster_sums_fixed_order(corpus, skewed):
    """The Lloyd sums add each cluster's rows in row order (a stable sort by
    cluster, then segment_reduce): on the CPU the same bits as index_add_,
    within 1e-5 of the reference's jax.ops.segment_sum as centroids (sum /
    count), and the same bits on a second call (on the card index_add_ adds
    by atomics in no fixed order; this does not). Skewed: half the rows in
    one cluster and a quarter of the clusters empty."""
    xb = np.ascontiguousarray(corpus[0][:4096], dtype=np.float32)
    rng = np.random.default_rng(5)
    assign = rng.integers(0, NLIST, len(xb))
    if skewed:
        assign = np.where(rng.random(len(xb)) < 0.5, 3, assign % (3 * NLIST // 4))
    x, a = torch.from_numpy(xb), torch.from_numpy(assign)
    counts = np.maximum(np.bincount(assign, minlength=NLIST), 1).astype(np.float32)[:, None]
    sums = tkmeans.cluster_sums(x, a, NLIST)
    want = torch.zeros((NLIST, xb.shape[1])).index_add_(0, a, x)
    assert torch.equal(sums.view(torch.int32), want.view(torch.int32))
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(xb), jnp.asarray(assign), num_segments=NLIST))
    np.testing.assert_allclose(sums.numpy() / counts, seg / counts, atol=1e-5)
    assert torch.equal(tkmeans.cluster_sums(x, a, NLIST).view(torch.int32), sums.view(torch.int32))


def test_kmeans_lloyd_step_repeats_bit_for_bit(corpus):
    xb = torch.from_numpy(np.ascontiguousarray(corpus[0][:4096], dtype=np.float32))
    cents = xb[np.random.default_rng(2).choice(len(xb), NLIST, replace=False)]
    runs = [tkmeans._lloyd_step(xb, cents, k=NLIST) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_port_build_recall_at_equal_knob(corpus):
    """A full k-means run is held by recall, not by identical centroids."""
    xb, xq, gt = corpus
    set_precision(False)
    idx = build(ktt, "IVF_FLAT", xb, {"metric_type": "L2", "nlist": NLIST})
    assert recall(_search(idx, ktt, xq)[0], gt) >= 0.9


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
    built = build(ktt, name, xb, cfg)
    monkeypatch.setattr(tivf, "UPLOAD_CHUNK_BYTES", 4096)  # 10 rows of 400 bytes a chunk
    idx = cross_load(built, ktt)
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
