"""The port's FAISS node (faiss index_factory descriptions) against the JAX
package: tests/test_comp.py::TestFaissGenericNode's checks on the port, each
description's ids against the JAX node's on the same rows, and BinarySets
both ways.

Tolerance: ids equal except where the JAX distances of two neighbours lie
within 1e-5 relative of each other (a near-tie may swap); distances within
1e-5 relative + 1e-5 (f32 sums in other orders). Every description runs at
EXACT precision in both packages.
"""

import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

from .torch_parity import cross_load, set_precision

DESCS = [
    ("Flat", {}),
    ("IVF32,Flat", {"nprobe": 8}),
    ("IVF32,PQ8", {"nprobe": 16}),
    ("IVF32,SQ8", {"nprobe": 8}),
    ("HNSW16", {"ef": 64}),
]
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")
    set_precision(False)


def _rows(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _faiss(pkg, xb, desc, **extra):
    idx = pkg.IndexFactory.Instance().Create("FAISS").value()
    st = idx.Build(pkg.GenDataSetFromArray(xb), {"metric_type": "L2", "index_description": desc, **extra})
    assert st == pkg.Status.success, (desc, st)
    return idx


def _search(pkg, idx, xq, k, scfg):
    res = idx.Search(pkg.GenDataSetFromArray(xq), {"metric_type": "L2", "k": k, **scfg})
    assert res.has_value(), res.what()
    return res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)


def _assert_near(ids_t, d_t, ids_j, d_j):
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=1e-5)
    diff = ids_t != ids_j
    if diff.any():
        gap = np.abs(np.diff(d_j, axis=1)) <= RTOL * np.abs(d_j[:, 1:]) + 1e-5
        near = np.zeros_like(diff)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        assert (~diff | near).all()


@pytest.mark.parametrize("desc,scfg", DESCS)
def test_descriptions(desc, scfg):
    """tests/test_comp.py::TestFaissGenericNode::test_descriptions on the
    port, and the JAX node's ids on the same rows."""
    xb, xq = _rows(1200, 64, 101), _rows(4, 64, 102)
    got = [_search(pkg, _faiss(pkg, xb, desc), xq, 5, scfg) for pkg in (kt, ktt)]
    assert (got[1][0] >= 0).any()
    _assert_near(got[1][0], got[1][1], got[0][0], got[0][1])


def test_bad_description():
    xb = _rows(100, 16, 42)
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create("FAISS").value()
        st = idx.Build(pkg.GenDataSetFromArray(xb), {"metric_type": "L2", "index_description": "LSH,Whatever"})
        assert st == pkg.Status.invalid_param_in_json


@pytest.mark.parametrize("src,dst", [(ktt, ktt), (kt, ktt), (ktt, kt)], ids=["round_trip", "jax_to_port", "port_to_jax"])
def test_serialize_roundtrip(src, dst):
    xb, xq = _rows(500, 32, 103), _rows(3, 32, 104)
    idx = _faiss(src, xb, "IVF16,Flat")
    want = _search(src, idx, xq, 3, {"nprobe": 16})
    loaded = cross_load(idx, dst)
    got = _search(dst, loaded, xq, 3, {"nprobe": 16})
    np.testing.assert_array_equal(got[0], want[0])


def test_add_after_deserialize():
    """The port's Add on a loaded FAISS node loads the caller's config into
    the inner node's (the JAX package keeps it only from Train and fails:
    internal_error). The loaded-and-added index answers as the one built and
    added in either package."""
    xb, extra, xq = _rows(600, 16, 0), _rows(50, 16, 1), _rows(5, 16, 2)
    want = []
    for pkg in (kt, ktt):
        idx = _faiss(pkg, xb, "IVF16,Flat")
        assert idx.Add(pkg.GenDataSetFromArray(extra), {"metric_type": "L2"}) == pkg.Status.success
        want.append(_search(pkg, idx, xq, 5, {"nprobe": 16}))
    _assert_near(want[1][0], want[1][1], want[0][0], want[0][1])
    loaded = {pkg: cross_load(_faiss(pkg, xb, "IVF16,Flat"), pkg) for pkg in (kt, ktt)}
    assert loaded[kt].Add(kt.GenDataSetFromArray(extra), {"metric_type": "L2"}) == kt.Status.internal_error
    assert loaded[ktt].Add(ktt.GenDataSetFromArray(extra), {"metric_type": "L2"}) == ktt.Status.success
    assert loaded[ktt].Count() == 650
    got = _search(ktt, loaded[ktt], xq, 5, {"nprobe": 16})
    np.testing.assert_array_equal(got[0], want[1][0])
