"""The port's SCANN_DVR (the data-view refiner over SCANN) against the JAX
package: tests/test_emb_list.py::TestScannDvr's checks on the port, every
refine_type at every data type on the same seeded rows, the filtered
widening with its materialized-view hint, a loaded node (no refine copy),
and an Add after Build, where the JAX package is at fault.

Both packages build the same SCANN coarse stage from the same rows (EXACT
precision). Tolerance: ids equal except where the JAX distances of two
neighbours lie within the tolerance of each other; distances within 1e-5
relative + 1e-4 + 1e-6 of the largest |q|^2 + |x|^2 (the refine products
are f32 sums in other orders, and an L2 distance is a cancellation of those
norms: int8 rows at their natural scale reach 1e5).
bf16 rows are ml_dtypes arrays for the JAX package and their uint16 bit
patterns for the port (utils/bf16.py).
"""

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.utils.bf16 import as_f32, bf16_bits

from .torch_parity import cross_load, set_precision

NB, NQ, DIM, K = 1200, 8, 32, 5
BUILD = {"metric_type": "L2", "nlist": 16, "sub_dim": 4}
SEARCH = {"metric_type": "L2", "k": K, "nprobe": 8, "reorder_k": 50}
RTOL, ATOL = 1e-5, 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")
    set_precision(False)


class View:
    """A caller's rows, fetched by id (the data view)."""

    def __init__(self, rows):
        self.rows = rows

    def view_data(self, ids):
        return self.rows[ids]


def _typed(pkg, x, dtype_name):
    if dtype_name == "int8":
        return np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    if dtype_name == "fp16":
        return x.astype(np.float16)
    if dtype_name == "bf16":
        return x.astype(ml_dtypes.bfloat16) if pkg is kt else bf16_bits(x)
    return x


def _dvr(pkg, x, refine_type, dtype_name="fp32", view=True, build=BUILD):
    obj = View(x) if view else None
    idx = pkg.IndexFactory.Instance().Create("SCANN_DVR", data_type=dtype_name, object=obj).value()
    st = idx.Build(pkg.GenDataSetFromArray(x), dict(build, refine_type=refine_type))
    assert st == pkg.Status.success, st
    return idx


def _search(pkg, idx, q, cfg=SEARCH, bitset=None):
    res = idx.Search(pkg.GenDataSetFromArray(q), cfg, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    k = cfg["k"]
    return res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)


def _assert_near(got, want, scale=0.0):
    """``scale``: the largest |q|^2 + |x|^2 of the rows compared."""
    (ids_t, d_t), (ids_j, d_j) = got, want
    atol = ATOL + 1e-6 * scale
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=atol)
    diff = ids_t != ids_j
    if diff.any():
        gap = np.abs(np.diff(d_j, axis=1)) <= RTOL * np.abs(d_j[:, 1:]) + atol
        near = np.zeros_like(diff)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        assert (~diff | near).all()


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(95).standard_normal((NB, DIM)).astype(np.float32)


# --- tests/test_emb_list.py::TestScannDvr on the port ------------------------------


def test_data_view_refine(rows):
    idx = _dvr(ktt, rows, 0)
    assert not idx.HasRawData("L2")
    ids, _ = _search(ktt, idx, rows[:NQ])
    assert (ids[:, 0] == np.arange(NQ)).mean() >= 0.8


def test_quantized_refine(rows):
    ids, _ = _search(ktt, _dvr(ktt, rows, 1, view=False), rows[:NQ])
    assert (ids[:, 0] == np.arange(NQ)).mean() >= 0.8


# --- the port against the JAX package ------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["fp32", "fp16", "bf16", "int8"])
@pytest.mark.parametrize("refine_type", [0, 1, 2, 3], ids=["DATA_VIEW", "UINT8", "FP16", "BF16"])
def test_refine_types_equal_jax(rows, refine_type, dtype_name):
    q = rows[:NQ] + np.float32(0.05)
    out = []
    for pkg in (kt, ktt):
        x = _typed(pkg, rows, dtype_name)
        idx = _dvr(pkg, x, refine_type, dtype_name)
        out.append(_search(pkg, idx, _typed(pkg, q, dtype_name)))
    norms = [(as_f32(_typed(ktt, a, dtype_name)).astype(np.float64) ** 2).sum(1).max() for a in (rows, q)]
    _assert_near(out[1], out[0], scale=sum(norms))


@pytest.mark.parametrize("mv", [None, {"is_pure_and": True, "has_not": False,
                                       "field_id_to_touched_categories_cnt": {"101": 2}}], ids=["plain", "mv_hint"])
def test_filtered_widening_equals_jax(rows, mv):
    """A 50% bitset widens the coarse stage by 1 / (1 - 0.5), the MV hint of
    a pure-AND filter over <= 2 categories by 2 more: no filtered id, and
    the JAX package's ids."""
    filtered = np.zeros(NB, bool)
    filtered[::2] = True
    cfg = dict(SEARCH, reorder_k=20)
    if mv is not None:
        cfg["materialized_view_search_info"] = mv
    out = []
    for pkg in (kt, ktt):
        idx = _dvr(pkg, rows, 2)
        out.append(_search(pkg, idx, rows[:NQ], cfg, pkg.BitsetView.from_bool_array(filtered)))
    assert not filtered[out[1][0][out[1][0] >= 0]].any()
    _assert_near(out[1], out[0])
    assert ktt.IndexFactory.Instance().Create("SCANN_DVR").value().IsAdditionalScalarSupported()


def test_loaded_node_refines_through_the_view(rows):
    """Deserialize restores neither refine_type nor the refine copy (neither
    is in the blob): a loaded UINT8 node without a view answers
    invalid_args, and with one it refines through the view, in both
    packages alike."""
    q = rows[:NQ] + np.float32(0.05)
    views = []
    for src in (kt, ktt):
        blob = src.BinarySet()
        assert _dvr(src, rows, 1, view=False).Serialize(blob) == src.Status.success
        for dst in (kt, ktt):
            bs = dst.BinarySet()
            for name in blob:
                bs.Append(name, blob.GetByName(name).tobytes())
            bare = dst.IndexFactory.Instance().Create("SCANN_DVR").value()
            assert bare.Deserialize(bs) == dst.Status.success
            res = bare.Search(dst.GenDataSetFromArray(q), SEARCH, dst.BitsetView())
            assert res.error() == dst.Status.invalid_args
            viewed = dst.IndexFactory.Instance().Create("SCANN_DVR", object=View(rows)).value()
            assert viewed.Deserialize(bs) == dst.Status.success
            views.append(_search(dst, viewed, q))
    view_built = _search(kt, _dvr(kt, rows, 0), q)
    for got in views:
        _assert_near(got, view_built)


def test_no_raw_data_and_delegates(rows):
    idx = _dvr(ktt, rows, 2)
    assert idx.GetVectorByIds(ktt.GenIdsDataSet(np.array([0, 1]))).error() == ktt.Status.not_implemented
    assert not idx.HasRawData("L2") and idx.Count() == NB and idx.Dim() == DIM
    again = cross_load(idx, ktt)
    assert again.Count() == NB


@pytest.mark.parametrize("refine_type", [1, 2, 3], ids=["UINT8", "FP16", "BF16"])
def test_add_after_build_keeps_every_refine_row(refine_type):
    """Build 4,000 rows, Add 2,000, search near copies of rows 4000-4009.
    The port's refine copy holds every row (the added ones encoded with the
    first Add's codec), so each query finds its source row. The JAX package
    replaces the copy with the added rows only while the candidate ids stay
    global: it re-scores candidate i with added row i, and its rank-1 ids
    are rows of the first Add (on this corpus 762, 1558, 1939, 986, 656,
    1395, 501, 985, 1158, ... at distances 30-50), never a source row."""
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((4000, DIM)).astype(np.float32)
    extra = rng.standard_normal((2000, DIM)).astype(np.float32)
    q = (extra[:10] + 0.01 * rng.standard_normal((10, DIM))).astype(np.float32)
    cfg = {"metric_type": "L2", "k": K, "nprobe": 8}
    got = {}
    for pkg in (kt, ktt):
        idx = _dvr(pkg, xb, refine_type, view=False)
        assert idx.Add(pkg.GenDataSetFromArray(extra), {"metric_type": "L2"}) == pkg.Status.success
        assert idx.Count() == 6000
        got[pkg] = _search(pkg, idx, q, cfg)
    np.testing.assert_array_equal(got[ktt][0][:, 0], np.arange(4000, 4010))
    assert (got[ktt][1][:, 0] < 0.02).all()
    jax_top = got[kt][0][:, 0]
    assert (jax_top < 4000).all(), jax_top  # the JAX package's fault, recorded
    assert (got[kt][1][:, 0] > 10.0).all()


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of it raises
sys.path.insert(0, {root!r})
import numpy as np
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.utils.bf16 import as_f32, bf16_bits
ktt.set_device("cpu")
x = np.random.default_rng(0).standard_normal((1200, 32)).astype(np.float32)
bits = bf16_bits(x)

class View:
    def view_data(self, ids):
        return bits[ids]

for dtype_name, rows in (("bf16", bits), ("fp32", x)):
    for rt in (0, 3):
        idx = ktt.IndexFactory.Instance().Create("SCANN_DVR", data_type=dtype_name, object=View()).value()
        assert idx.Build(ktt.GenDataSetFromArray(rows), {{"metric_type": "L2", "nlist": 16, "refine_type": rt}}) == ktt.Status.success
        ids = idx.Search(ktt.GenDataSetFromArray(rows[:5]), {{"metric_type": "L2", "k": 3, "nprobe": 16}}).value().ids
        assert ids.reshape(5, 3)[:, 0].tolist() == [0, 1, 2, 3, 4], (dtype_name, rt, ids)
assert sys.modules["ml_dtypes"] is None
print("ok")
"""


def test_bf16_refine_without_ml_dtypes():
    """A bf16 corpus and the BF16 refine copy build and search in a process
    where ml_dtypes cannot load: the copy goes through bf16_bits."""
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES.format(root=ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
