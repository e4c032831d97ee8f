"""AISAQ on the port: the inline per-node records (adjacency, own and
neighbour PQ codes) served with no PQ codes on the device (the three cases
of tests/test_aisaq.py), the inline file written from a JAX-built mem file
byte for byte as the JAX package writes it, and the host walk's candidate
pools identical to the JAX package's on a JAX-built prefix."""

import os
import shutil

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 6000, 32, 64, 10


class _FM:
    def LoadFile(self, path):
        return True

    def AddFile(self, path):
        return os.path.exists(path)


def _write_bin(path, x):
    with open(path, "wb") as f:
        np.asarray(x.shape, dtype=np.int32).tofile(f)
        x.tofile(f)


def _build(pkg, tmp, tag, xb, cfg):
    data_path = str(tmp / f"{tag}.bin")
    _write_bin(data_path, xb)
    prefix = str(tmp / tag)
    idx = pkg.IndexFactory.Instance().Create("AISAQ", object=_FM()).value()
    st = idx.Build(pkg.DataSet(), {"metric_type": "L2", "index_prefix": prefix, "data_path": data_path, **cfg})
    assert st == pkg.Status.success, st
    return prefix


def _load(pkg, prefix, extra=None):
    idx = pkg.IndexFactory.Instance().Create("AISAQ", object=_FM()).value()
    st = idx.Deserialize(pkg.BinarySet(), {"metric_type": "L2", "index_prefix": prefix, **(extra or {})})
    assert st == pkg.Status.success, st
    return idx


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_aisaq")


@pytest.fixture(scope="module")
def built(tmp):
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((NB, DIM)).astype(np.float32)
    xq = rng.standard_normal((NQ, DIM)).astype(np.float32)
    prefix = _build(ktt, tmp, "idx", xb, {
        "max_degree": 24, "search_list_size": 48, "pq_code_budget_gb": 16 * NB / 1e9, "build_dram_budget_gb": 4.0,
    })
    return xb, xq, prefix


def test_inline_layout_and_search(built):
    xb, xq, prefix = built
    assert os.path.exists(prefix + "_aisaq_inline.bin")
    idx = _load(ktt, prefix)
    node = idx.node
    assert node._inline_nodes is not None
    assert "codes" not in node._store  # the all-in-storage property
    deg, m = node._inline_geom
    assert node._inline_nodes.shape[1] == deg * 4 + m + deg * m

    bf = ktt.BruteForce.Search(ktt.GenDataSetFromArray(xb), ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "k": K})
    gt = bf.value().ids.reshape(NQ, K)
    r = idx.Search(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "k": K, "search_list_size": 96})
    assert r.has_value(), r.what()
    ids = np.asarray(r.value().ids).reshape(NQ, K)
    rec = np.mean([len(set(gt[i].tolist()) & set(ids[i].tolist()) - {-1}) / K for i in range(NQ)])
    assert rec >= 0.8, rec


def test_inline_filtered(built):
    xb, xq, prefix = built
    idx = _load(ktt, prefix)
    # exclude the true NN of query 0 and check it disappears
    r0 = idx.Search(ktt.GenDataSetFromArray(xq[:1]), {"metric_type": "L2", "k": 1, "search_list_size": 64})
    top = int(np.asarray(r0.value().ids)[0])
    bits = np.zeros(NB, bool)
    bits[top] = True  # filtered out
    bs = ktt.BitsetView(np.packbits(bits, bitorder="little"), NB)
    r1 = idx.Search(ktt.GenDataSetFromArray(xq[:1]), {"metric_type": "L2", "k": 5, "search_list_size": 64}, bs)
    assert r1.has_value(), r1.what()
    assert top not in np.asarray(r1.value().ids).tolist()


def test_inline_pq_false_keeps_plain_path(tmp):
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((2000, 32)).astype(np.float32)
    prefix = _build(ktt, tmp, "off", xb, {
        "max_degree": 16, "search_list_size": 32, "inline_pq": False,
        "pq_code_budget_gb": 8 * 2000 / 1e9, "build_dram_budget_gb": 4.0,
    })
    assert not os.path.exists(prefix + "_aisaq_inline.bin")
    idx2 = _load(ktt, prefix, {"inline_pq": False})
    assert idx2.node._inline_nodes is None
    assert "codes" in idx2.node._store
    r = idx2.Search(ktt.GenDataSetFromArray(xb[:4]), {"metric_type": "L2", "k": 3, "search_list_size": 32})
    assert r.has_value(), r.what()


@pytest.fixture(scope="module")
def jax_prefix(tmp):
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((2000, 32)).astype(np.float32)
    xq = rng.standard_normal((12, 32)).astype(np.float32)
    prefix = _build(kt, tmp, "jax", xb, {
        "max_degree": 16, "search_list_size": 32, "pq_code_budget_gb": 8 * 2000 / 1e9, "num_entry_points": 8,
    })
    return xb, xq, prefix


def test_inline_file_bytes_match_jax(tmp, jax_prefix):
    """The port's inline records from the JAX package's mem file: the same
    bytes as the JAX package's inline file."""
    _, _, prefix = jax_prefix
    copy = str(tmp / "jax_copy")
    shutil.copy(prefix + "_kwtpu_mem.bin", copy + "_kwtpu_mem.bin")
    node = ktt.IndexFactory.Instance().Create("AISAQ").value().node
    node._write_inline_nodes(copy)
    with open(copy + "_aisaq_inline.bin", "rb") as a, open(prefix + "_aisaq_inline.bin", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "bitset"])
def test_inline_walk_candidates_match_jax(jax_prefix, filtered):
    """_search_inline_ssd on a JAX-built prefix: the candidate pools equal
    the JAX package's, id for id; the searches answer alike."""
    xb, xq, prefix = jax_prefix
    keep = np.random.default_rng(9).random(len(xb)) >= 0.3 if filtered else None
    j, t = _load(kt, prefix), _load(ktt, prefix)
    assert "codes" not in t.node._store and t.node._entry.shape[0] <= 8
    for L, W in ((32, 4), (48, 2)):
        want = j.node._search_inline_ssd(xq, L, W, keep)
        got = t.node._search_inline_ssd(xq, L, W, keep)
        np.testing.assert_array_equal(got, want)
    out = []
    for pkg, idx in ((kt, j), (ktt, t)):
        bs = pkg.BitsetView.from_bool_array(~keep) if filtered else pkg.BitsetView()
        r = idx.Search(pkg.GenDataSetFromArray(xq), {"metric_type": "L2", "k": K, "search_list_size": 48}, bs)
        assert r.has_value(), r.what()
        out.append((r.value().ids.reshape(len(xq), K), r.value().distance.reshape(len(xq), K)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)
