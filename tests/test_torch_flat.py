"""FLAT: the port against the JAX package through the public API.

Corpora at or above 16384 rows take the port's two-phase scan (the plain
phase-1 version on CPU tensors); smaller or filtered searches take the
streaming tiled scan. Both are exact, so ids match the JAX package's exact
scan one to one on tie-free random data.
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

from .torch_parity import build, cross_load, search

torch.set_num_threads(2)
ktt.set_device("cpu")

K = 10


def _data(nb, nq, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((nb, d)).astype(np.float32),
        rng.standard_normal((nq, d)).astype(np.float32),
    )


def _build(pkg, xb, metric):
    return build(pkg, "FLAT", xb, {"metric_type": metric})


def _search(idx, pkg, xq, metric, k=K, bitset=None):
    return search(idx, pkg, xq, {"metric_type": metric, "k": k}, bitset)


@pytest.mark.parametrize("nb", [3000, 20000])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_flat_matches_jax(nb, metric):
    xb, xq = _data(nb, 24)
    ids_j, d_j = _search(_build(kt, xb, metric), kt, xq, metric)
    ids_t, d_t = _search(_build(ktt, xb, metric), ktt, xq, metric)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_filtered_matches_jax(metric):
    xb, xq = _data(20000, 16, seed=1)
    drop = np.random.default_rng(2).random(len(xb)) < 0.5
    ids_j, d_j = _search(_build(kt, xb, metric), kt, xq, metric, bitset=kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = _search(
        _build(ktt, xb, metric), ktt, xq, metric, bitset=ktt.BitsetView.from_bool_array(drop)
    )
    np.testing.assert_array_equal(ids_t, ids_j)
    assert not drop[ids_t[ids_t >= 0]].any()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-3)


def test_flat_k_larger_than_corpus():
    xb, xq = _data(50, 3, d=16)
    ids_t, d_t = _search(_build(ktt, xb, "L2"), ktt, xq, "L2", k=64)
    assert (ids_t[:, :50] >= 0).all() and (ids_t[:, 50:] == -1).all()
    assert np.isinf(d_t[:, 50:]).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_flat_blob_crosses_packages(direction):
    xb, xq = _data(20000, 8, seed=3)
    src, dst = (kt, ktt) if direction == "jax_to_port" else (ktt, kt)
    built = _build(src, xb, "L2")
    loaded = cross_load(built, dst)
    assert loaded.Count() == len(xb)
    np.testing.assert_array_equal(_search(loaded, dst, xq, "L2")[0], _search(built, src, xq, "L2")[0])


def test_flat_load_state_matches_deserialize():
    xb, xq = _data(4000, 8, seed=4)
    built = _build(kt, xb, "IP")
    node = ktt.IndexFactory.Instance().Create("FLAT").value()
    node.node.load_state({"xb": xb}, {"dim": 64, "metric": "IP", "data_type": "fp32"})
    np.testing.assert_array_equal(_search(node, ktt, xq, "IP")[0], _search(built, kt, xq, "IP")[0])


def test_flat_spills_host_copy(monkeypatch):
    """After the first Search uploads the rows, the host copy is a
    disk-backed memmap, as the JAX package's FLAT demotes it; GetVectorByIds,
    Serialize and a later Add still see the same bytes."""
    monkeypatch.setenv("KNOWHERE_HOST_SPILL_THRESHOLD", "1024")
    xb, xq = _data(20000, 8, seed=5)
    idx = _build(ktt, xb, "L2")
    bs_before = ktt.BinarySet()
    assert idx.Serialize(bs_before) == ktt.Status.success
    ids, _ = _search(idx, ktt, xq, "L2")
    assert isinstance(idx.node._xb, np.memmap)
    ref = _build(kt, xb, "L2")
    _search(ref, kt, xq, "L2")
    assert isinstance(ref.node._xb, np.memmap)  # the reference spills the same way
    np.testing.assert_array_equal(ids, _search(ref, kt, xq, "L2")[0])

    pick = np.array([0, 7, 19999, 123])
    res = idx.GetVectorByIds(ktt.GenIdsDataSet(pick))
    assert res.has_value(), res.what()
    np.testing.assert_array_equal(np.asarray(res.value().tensor).reshape(len(pick), -1), xb[pick])
    bs = ktt.BinarySet()
    assert idx.Serialize(bs) == ktt.Status.success
    assert bs.GetByName("FLAT").tobytes() == bs_before.GetByName("FLAT").tobytes()

    more = _data(100, 1, seed=6)[0]
    assert idx.Add(ktt.GenDataSetFromArray(more), {"metric_type": "L2"}) == ktt.Status.success
    assert idx.Count() == len(xb) + len(more)
    np.testing.assert_array_equal(np.asarray(idx.node._xb), np.concatenate([xb, more]))
    assert _search(idx, ktt, more[:4], "L2")[0][:, 0].tolist() == [20000, 20001, 20002, 20003]
    assert isinstance(idx.node._xb, np.memmap)


@pytest.mark.parametrize("k", [1, 7, 64, 300, 400])
def test_topk_packed_equals_sorted(k):
    """topk_leftmost's two selections give the same values (bit for bit)
    and columns: ties (repeated values, -0.0 beside +0.0, +-inf, NaN of
    either sign) come back lowest column first; f32 rows of
    PACKED_MIN_COLS columns take the packed key."""
    from knowhere_tpu_torch.ops import topk as T

    g = torch.Generator().manual_seed(0)
    nan = float("nan")
    vals = torch.tensor([3.0, -1.0, 0.0, -0.0, 2.5, float("-inf"), float("inf"), -7.25, 1e-30, -1e-30, nan, -nan])
    for cols in (300, T.PACKED_MIN_COLS):
        score = vals[torch.randint(0, len(vals), (16, cols), generator=g)]
        score[5] = float("-inf")
        want = T._topk_sorted(score, k)
        for got in (T._topk_packed(score, k), T.topk_leftmost(score, k)):
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
