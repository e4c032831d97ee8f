"""The port's compat shim (the SWIG-style surface) and node wrappers against
the JAX package: tests/test_compat.py's checks on the port, and the same
calls on both packages over the same seeded rows.

Tolerance: ids equal (FLAT and BruteForce are exact; the IVF_FLAT builds
are the same on both sides at EXACT precision); distances within 1e-5
relative + 1e-5 (f32 sums in other orders). bf16 rows are the port's
uint16 bit patterns, compared bit for bit with ml_dtypes' rounding.
"""

import json
import os
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu.compat as jcompat
import knowhere_tpu_torch as ktt
import knowhere_tpu_torch.compat as knowhere
from knowhere_tpu_torch.config import Config, Stage
from knowhere_tpu_torch.models.flat import FlatIndexNode
from knowhere_tpu_torch.wrappers import IndexNodeDataMockWrapper, IndexNodeThreadPoolWrapper

from .torch_parity import set_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")
    set_precision(False)


def _rows(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _exact_l2(xb, xq, k):
    d = ((xq[:, None, :].astype(np.float64) - xb[None].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d, 1, kind="stable")[:, :k]


# --- tests/test_compat.py::TestCompatShim on the port -------------------------------


def test_swig_style_flow():
    xb, xq = _rows(2000, 64, 111), _rows(5, 64, 112)
    out = []
    for mod in (jcompat, knowhere):
        idx = mod.CreateIndex("IVF_FLAT", mod.GetCurrentVersion())
        st = idx.Build(mod.ArrayToDataSet(xb), json.dumps({"metric_type": "L2", "nlist": 32}))
        assert st == mod.Status.success
        res, st = idx.Search(mod.ArrayToDataSet(xq), json.dumps({"metric_type": "L2", "k": 5, "nprobe": 16}))
        assert st == mod.Status.success
        out.append(mod.DataSetToArray(res))
    dists, ids = out[1]
    assert dists.shape == (5, 5) and ids.shape == (5, 5)
    gt = _exact_l2(xb, xq, 5)
    assert np.mean([len(set(ids[i]) & set(gt[i])) / 5 for i in range(5)]) >= 0.6
    np.testing.assert_array_equal(ids, out[0][1])
    np.testing.assert_allclose(dists, out[0][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(knowhere, knowhere), (jcompat, knowhere), (knowhere, jcompat)],
                         ids=["port", "jax_dump_port_load", "port_dump_jax_load"])
def test_binset_dump_load(tmp_path, src, dst):
    xb = _rows(500, 32, 112)
    idx = src.CreateIndex("FLAT")
    idx.Build(src.ArrayToDataSet(xb), json.dumps({"metric_type": "L2"}))
    binset = src.GetBinarySet()
    assert idx.Serialize(binset) == src.Status.success
    path = str(tmp_path / "dump.bin")
    src.Dump(binset, path)
    binset2 = dst.GetBinarySet()
    assert dst.Load(binset2, path)
    idx2 = dst.CreateIndex("FLAT")
    assert idx2.Deserialize(binset2) == dst.Status.success
    assert idx2.Count() == 500


def test_brute_force_and_bitset():
    xb = _rows(300, 32, 113)
    out = []
    for mod in (jcompat, knowhere):
        res, st = mod.BruteForceSearch(mod.ArrayToDataSet(xb), mod.ArrayToDataSet(xb[:2]),
                                       json.dumps({"metric_type": "L2", "k": 3}), mod.GetNullBitSetView())
        assert st == mod.Status.success
        out.append(mod.DataSetToArray(res))
        rr, st = mod.BruteForceRangeSearch(mod.ArrayToDataSet(xb), mod.ArrayToDataSet(xb[:2]),
                                           json.dumps({"metric_type": "L2", "radius": 40.0}))
        assert st == mod.Status.success
        out.append(mod.RangeSearchDataSetToArray(rr))
    assert out[2][1][0, 0] == 0
    np.testing.assert_array_equal(out[2][1], out[0][1])
    np.testing.assert_array_equal(out[3][2], out[1][2])  # range lims
    np.testing.assert_array_equal(np.sort(out[3][1]), np.sort(out[1][1]))


def test_sparse_dataset():
    data = np.array([0.5, 1.0, 0.25], np.float32)
    indices = np.array([1, 0, 2], np.int32)
    indptr = np.array([0, 1, 3], np.int64)
    ds = knowhere.ArrayToSparseDataSet(data, indices, indptr)
    assert ds.is_sparse and ds.rows == 2
    assert ds.tensor == jcompat.ArrayToSparseDataSet(data, indices, indptr).tensor


# --- tests/test_compat.py::TestWrappers on the port --------------------------------


@pytest.mark.parametrize("dtype_name", ["fp16", "bf16", "int8"])
def test_mock_wrapper_casts(dtype_name):
    """The mock wrapper widens fp16 / bf16 / int8 rows to f32 before the
    inner node sees them: bf16 bit patterns exactly (never as numbers), and
    the ids of a fp32 node built on the widened rows."""
    x = _rows(100, 16, 0)
    if dtype_name == "fp16":
        rows, wide = x.astype(np.float16), x.astype(np.float16).astype(np.float32)
    elif dtype_name == "bf16":
        rows = knowhere.BFloat16DataSetTensor2Array(ktt.GenDataSetFromArray(x))
        wide = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    else:
        rows = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        wide = rows.astype(np.float32)
    inner = FlatIndexNode(version=8)
    wrap = IndexNodeDataMockWrapper(inner)
    cfg = wrap.CreateConfig()
    Config.load(cfg, {"metric_type": "L2"}, Stage.TRAIN)
    assert wrap.Build(ktt.GenDataSetFromArray(rows), cfg) == ktt.Status.success
    assert inner._xb.dtype == np.float32
    np.testing.assert_array_equal(inner._xb, wide)
    scfg = wrap.CreateConfig()
    Config.load(scfg, {"metric_type": "L2", "k": 5}, Stage.SEARCH)
    got = wrap.Search(ktt.GenDataSetFromArray(rows[:7]), scfg, ktt.BitsetView()).value().ids.reshape(7, 5)
    np.testing.assert_array_equal(got, _exact_l2(wide, wide[:7], 5))


def test_threadpool_wrapper_serializes():
    """Four threads through one wrapper get the serial ids."""
    xb = _rows(400, 16, 42)
    inner = FlatIndexNode(version=8)
    wrap = IndexNodeThreadPoolWrapper(inner)
    cfg = wrap.CreateConfig()
    Config.load(cfg, {"metric_type": "L2"}, Stage.TRAIN)
    assert wrap.Build(ktt.GenDataSetFromArray(xb), cfg) == ktt.Status.success
    assert wrap.Count() == 400
    scfg = wrap.CreateConfig()
    Config.load(scfg, {"metric_type": "L2", "k": 5}, Stage.SEARCH)
    queries = [xb[i * 10 : i * 10 + 10] for i in range(4)]
    serial = [wrap.Search(ktt.GenDataSetFromArray(q), scfg, ktt.BitsetView()).value().ids for q in queries]
    got = [None] * 4

    def run(i):
        got[i] = wrap.Search(ktt.GenDataSetFromArray(queries[i]), scfg, ktt.BitsetView()).value().ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a, b)


# --- tests/test_compat.py::TestFeder on the port -------------------------------------


def test_feder_overview_and_visit():
    base = ktt.GenDataSetFromArray(_rows(500, 32, 115))
    idx = ktt.IndexFactory.Instance().Create("HNSW").value()
    idx.Build(base, {"metric_type": "L2", "M": 8, "efConstruction": 64})
    meta = idx.GetIndexMeta({"overview_levels": 2})
    assert meta.has_value(), meta.what()
    info = json.loads(meta.value().get("json_info"))
    assert info["type"] == "HNSW" and len(info["overview_levels"]) == 2
    cfg = idx.node.CreateConfig()
    Config.load(cfg, {"metric_type": "L2", "k": 5, "ef": 32}, Stage.SEARCH)
    visit = idx.node.GetFederVisit(ktt.GenDataSetFromArray(_rows(2, 32, 116)), cfg)
    assert visit.has_value(), visit.what()
    traces = json.loads(visit.value().get("json_id_set"))
    assert len(traces) == 2 and len(traces[0]) > 5
    assert all("id" in t and "distance" in t and "source" in t for t in traces[0])


def test_feder_ivf_overview_and_visit():
    idx = ktt.IndexFactory.Instance().Create("IVF_FLAT").value()
    idx.Build(ktt.GenDataSetFromArray(_rows(2000, 32, 117)), {"metric_type": "L2", "nlist": 16})
    meta = idx.GetIndexMeta({})
    assert meta.has_value(), meta.what()
    info = json.loads(meta.value().get("json_info"))
    assert info["nlist"] == 16 and sum(info["list_sizes"]) == 2000
    cfg = idx.node.CreateConfig()
    Config.load(cfg, {"metric_type": "L2", "k": 5, "nprobe": 4}, Stage.SEARCH)
    visit = idx.node.GetFederVisit(ktt.GenDataSetFromArray(_rows(3, 32, 118)), cfg)
    assert visit.has_value(), visit.what()
    traces = json.loads(visit.value().get("json_id_set"))
    assert len(traces) == 3 and len(traces[0]) == 4
    assert all("list_id" in t and "size" in t for t in traces[0])


# --- tests/test_compat.py::test_swig_surface_helpers on the port -------------------


def test_swig_surface_helpers(tmp_path):
    C = knowhere
    xb = _rows(128, 16, 9)
    idx = C.CreateIndex("FLAT")
    assert idx.Build(C.ArrayToDataSet(xb), '{"metric_type":"L2"}').name == "success"

    # BitSet: filter out row 0 -> its own query can't return it, also after
    # the view was taken (SetBit reaches every issued view)
    bs = C.BitSet(128)
    view = bs.GetBitSetView()
    ds, st = idx.Search(C.ArrayToDataSet(xb[:1]), '{"metric_type":"L2","k":3}', view)
    assert 0 in C.DataSet2Array(ds)[1][0].tolist()
    bs.SetBit(0)
    ds, st = idx.Search(C.ArrayToDataSet(xb[:1]), '{"metric_type":"L2","k":3}', view)
    assert st.name == "success"
    dis, ids = C.DataSet2Array(ds)
    assert 0 not in ids[0].tolist()

    its = C.GetAnnIterator(idx, C.ArrayToDataSet(xb[:1]), '{"metric_type":"L2"}')
    assert its[0].HasNext()
    i0, d0 = its[0].Next()
    assert i0 == 0 and abs(d0) < 1e-4

    t = C.DataSetTensor2Array(C.ArrayToDataSet(xb))
    assert t.shape == (128, 16)
    rr, st = idx.RangeSearch(C.ArrayToDataSet(xb[:2]), '{"metric_type":"L2","radius":1.0}')
    assert st.name == "success"
    lims = C.DumpRangeResultLimits(rr)
    assert lims[0] == 0 and len(C.DumpRangeResultIds(rr)) == lims[-1]
    assert len(C.DumpRangeResultDis(rr)) == lims[-1]

    bset = ktt.BinarySet()
    assert idx.Serialize(bset).name == "success"
    path = str(tmp_path / "flat.bin")
    C.WriteIndexToDisk(bset, idx.Type(), path)
    assert os.path.getsize(path) == bset.GetByName(idx.Type()).size
    assert C.default_json_str() == "{}"
    C.setOffsets(C.ArrayToDataSet(xb), [0, 64, 128])


# --- the port against the JAX package ----------------------------------------------


def test_type_objects():
    """_tag_of: torch.bfloat16 and any numpy type named "bfloat16" (here
    ml_dtypes') are bf16, as in the JAX package."""
    for t in (np.float32, np.float16, np.int8, np.uint8, ml_dtypes.bfloat16):
        assert knowhere._tag_of(t) == jcompat._tag_of(t)
    assert knowhere._tag_of(torch.bfloat16) == "bf16"
    assert knowhere._tag_of(ml_dtypes.bfloat16) == "bf16"


def test_typed_create_index_and_tensor_arrays():
    """CreateIndex with fp32, fp16 and bf16 type objects over IVF_FLAT: the
    JAX package's ids; BFloat16DataSetTensor2Array gives ml_dtypes' bits."""
    x = _rows(2000, 32, 7)
    q = x[:6]
    for t_port, t_jax, rows_port, rows_jax in (
        (np.float32, np.float32, x, x),
        (np.float16, np.float16, x.astype(np.float16), x.astype(np.float16)),
        (torch.bfloat16, ml_dtypes.bfloat16, knowhere.BFloat16DataSetTensor2Array(ktt.GenDataSetFromArray(x)),
         x.astype(ml_dtypes.bfloat16)),
    ):
        out = []
        for mod, t, rows in ((jcompat, t_jax, rows_jax), (knowhere, t_port, rows_port)):
            idx = mod.CreateIndex("IVF_FLAT", type=t)
            st = idx.Build(mod.ArrayToDataSet(rows), json.dumps({"metric_type": "L2", "nlist": 16}))
            assert st == mod.Status.success
            res, st = idx.Search(mod.ArrayToDataSet(rows[:6]), json.dumps({"metric_type": "L2", "k": 5, "nprobe": 16}))
            out.append(mod.DataSetToArray(res)[1])
        np.testing.assert_array_equal(out[1], out[0])
    bits = knowhere.BFloat16DataSetTensor2Array(ktt.GenDataSetFromArray(q))
    np.testing.assert_array_equal(bits, q.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(knowhere.DataSetTensor2Array(ktt.GenDataSetFromArray(bits)),
                                  q.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(knowhere.Float16DataSetTensor2Array(ktt.GenDataSetFromArray(q)),
                                  jcompat.Float16DataSetTensor2Array(kt.GenDataSetFromArray(q)))


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of it raises
sys.path.insert(0, {root!r})
import json
import numpy as np
import torch
import knowhere_tpu_torch as ktt
import knowhere_tpu_torch.compat as knowhere
ktt.set_device("cpu")
x = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)
rows = knowhere.BFloat16DataSetTensor2Array(ktt.GenDataSetFromArray(x))
idx = knowhere.CreateIndex("FLAT", type=torch.bfloat16)
assert idx.Build(knowhere.ArrayToDataSet(rows), json.dumps({{"metric_type": "L2"}})) == knowhere.Status.success
res, st = idx.Search(knowhere.ArrayToDataSet(rows[:4]), json.dumps({{"metric_type": "L2", "k": 2}}))
assert knowhere.DataSetToArray(res)[1][:, 0].tolist() == [0, 1, 2, 3]
assert knowhere._tag_of(np.float16) == "fp16"
assert sys.modules["ml_dtypes"] is None
print("ok")
"""


def test_bf16_without_ml_dtypes():
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES.format(root=ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
