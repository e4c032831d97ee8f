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
    idx = pkg.IndexFactory.Instance().Create("FLAT").value()
    assert idx.Build(pkg.GenDataSetFromArray(xb), {"metric_type": metric}) == pkg.Status.success
    return idx


def _search(idx, pkg, xq, metric, k=K, bitset=None):
    res = idx.Search(
        pkg.GenDataSetFromArray(xq), {"metric_type": metric, "k": k}, bitset or pkg.BitsetView()
    )
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(xq), k), res.value().distance.reshape(len(xq), k)


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
    bs = src.BinarySet()
    assert built.Serialize(bs) == src.Status.success
    bs2 = dst.BinarySet()
    bs2.Append("FLAT", bs.GetByName("FLAT").tobytes())
    loaded = dst.IndexFactory.Instance().Create("FLAT").value()
    assert loaded.Deserialize(bs2) == dst.Status.success
    assert loaded.Count() == len(xb)
    np.testing.assert_array_equal(_search(loaded, dst, xq, "L2")[0], _search(built, src, xq, "L2")[0])


def test_flat_load_state_matches_deserialize():
    xb, xq = _data(4000, 8, seed=4)
    built = _build(kt, xb, "IP")
    node = ktt.IndexFactory.Instance().Create("FLAT").value()
    node.node.load_state({"xb": xb}, {"dim": 64, "metric": "IP", "data_type": "fp32"})
    np.testing.assert_array_equal(_search(node, ktt, xq, "IP")[0], _search(built, kt, xq, "IP")[0])
