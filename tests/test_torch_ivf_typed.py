"""Typed (fp16 / bf16 / int8) IVF stores, the host bf16 rows without
ml_dtypes, CalcDistByIDs on an SQ8 refine store, and the registry of the
FLAT and IVF names: the port against the JAX package.

The JAX package builds each index; the port loads its BinarySet and both
search the same queries at EXACT and at FAST (the typed raw store takes
the plain scan on both sides: no int8 sidecar and no kernel over non-f32
rows). The port's own builds cross-load into the JAX package. bf16 rows
are compared by their bit patterns: the port holds them as uint16.
"""

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.factory import IndexFactory as JFactory
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.utils.bf16 import bf16_bits, bf16_to_f32, rows_to_device

from .torch_parity import cross_load, interpret_env, recall, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K, NLIST, NPROBE = 3000, 20, 128, 10, 16, 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env(align_min=2048)  # aligned lists: the typed store still takes the plain scan


def _typed(dtype_name, seed=0):
    """(xb, xq) of the dtype (bf16 as ml_dtypes arrays, as a JAX user holds them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((NB, DIM)).astype(np.float32)
    q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    if dtype_name == "int8":
        return np.clip(x * 40, -127, 127).astype(np.int8), np.clip(q * 40, -127, 127).astype(np.int8)
    t = np.float16 if dtype_name == "fp16" else ml_dtypes.bfloat16
    return x.astype(t), q.astype(t)


def _bits_of(a):
    """Rows as raw bytes: bf16 (ml_dtypes or the port's uint16) compared by bits."""
    return np.ascontiguousarray(a).view(np.uint8)


def _search(idx, pkg, xq, cfg):
    res = idx.Search(pkg.GenDataSetFromArray(xq), cfg, pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(xq), -1), res.value().distance.reshape(len(xq), -1)


def _build(pkg, name, xb, cfg, dtype_name):
    idx = pkg.IndexFactory.Instance().Create(name, data_type=dtype_name).value()
    assert idx.Build(pkg.GenDataSetFromArray(xb), cfg) == pkg.Status.success
    return idx


# ---------------------------------------------------------------------------
# host bf16
# ---------------------------------------------------------------------------


def test_bf16_bits_equal_ml_dtypes():
    """Round to nearest even, as ml_dtypes: random values, values exactly
    between two bf16 neighbours (both parities), fp16 input, infinities,
    zeros and subnormals (NaN payloads are not compared: no corpus holds
    NaN)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    mid = (rng.integers(0, 1 << 16, 4000).astype(np.uint32) << 16 | 0x8000).view(np.float32)  # halfway cases
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e38], np.float32)
    x = np.concatenate([x, mid, specials])
    x = x[~np.isnan(x)]
    np.testing.assert_array_equal(bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    h = rng.standard_normal(5000).astype(np.float16)
    np.testing.assert_array_equal(bf16_bits(h), h.astype(ml_dtypes.bfloat16).view(np.uint16))
    b = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(bf16_bits(b), b.view(np.uint16))  # the caller's bf16 rows: their bits
    np.testing.assert_array_equal(bf16_to_f32(bf16_bits(x)), b.astype(np.float32))
    assert rows_to_device(bf16_bits(x)).dtype == torch.bfloat16
    np.testing.assert_array_equal(rows_to_device(bf16_bits(x)).float().numpy(), b.astype(np.float32))


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of it raises
sys.path.insert(0, {root!r})
import numpy as np
import knowhere_tpu_torch as ktt
ktt.set_device("cpu")
rng = np.random.default_rng(0)
x = rng.standard_normal((2000, 32)).astype(np.float32)
for name, dtype_name, cfg in (
    ("IVF_FLAT", "bf16", {{"metric_type": "L2", "nlist": 8}}),
    ("IVF_FLAT", "fp16", {{"metric_type": "COSINE", "nlist": 8}}),
    ("IVF_SQ8", "fp32", {{"metric_type": "L2", "nlist": 8, "sq_type": "BF16"}}),
    ("IVF_PQ", "fp32", {{"metric_type": "L2", "nlist": 8, "m": 8, "refine": True, "refine_type": "BF16"}}),
    ("HNSW_SQ", "fp32", {{"metric_type": "L2", "M": 8, "efConstruction": 32, "sq_type": "BF16"}}),
):
    rows = x.astype(np.float16) if dtype_name == "fp16" else x
    idx = ktt.IndexFactory.Instance().Create(name, data_type=dtype_name).value()
    assert idx.Build(ktt.GenDataSetFromArray(rows), cfg) == ktt.Status.success
    bs = ktt.BinarySet()
    assert idx.Serialize(bs) == ktt.Status.success
    back = ktt.IndexFactory.Instance().Create(name, data_type=dtype_name).value()
    assert back.Deserialize(bs) == ktt.Status.success
    q = ktt.GenDataSetFromArray(rows[:5])
    cfg = dict(cfg, k=5, nprobe=8, ef=32)
    a, b = idx.Search(q, cfg).value().ids, back.Search(q, cfg).value().ids
    assert np.array_equal(a, b), name
    assert b.reshape(5, 5)[:, 0].tolist() == [0, 1, 2, 3, 4], (name, b)
assert sys.modules["ml_dtypes"] is None
print("ok")
"""


def test_bf16_stores_work_without_ml_dtypes():
    """A bf16 IVF corpus, a typed cosine corpus (its bf16 copy), SQ BF16
    rows, a BF16 refine store and HNSW_SQ BF16 build, serialize,
    deserialize and search in a process where ml_dtypes cannot load."""
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES.format(root=ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# ---------------------------------------------------------------------------
# typed IVF stores
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["fp16", "bf16", "int8"])
def dtype_name(request):
    return request.param


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("name", ["IVF_FLAT", "IVF_SQ8"])
def test_typed_search_matches_jax(dtype_name, name, metric, monkeypatch):
    xb, xq = _typed(dtype_name)
    cfg = {"metric_type": metric, "nlist": NLIST, "k": K, "nprobe": NPROBE}
    jidx = _build(kt, name, xb, cfg, dtype_name)
    tidx = cross_load(jidx, ktt, dtype_name)
    if name == "IVF_FLAT":
        want = torch.int8 if dtype_name == "int8" and metric == "L2" else torch.bfloat16
        assert tidx.node._store["data"].dtype == want and "i8_nrm" not in tidx.node._store
        for kernel in ("_f32_search", "_int8_search"):  # the typed raw store takes the plain scan
            monkeypatch.setattr(tscan, kernel, lambda *a, **kw: pytest.fail("a kernel scanned a typed store"))
    for fast in (False, True):
        set_precision(fast)
        ids_j, d_j = _search(jidx, kt, xq, cfg)
        ids_t, d_t = _search(tidx, ktt, xq, cfg)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-6)
    # the port's own build: its BinarySet gives the JAX package the same answers
    set_precision(False)
    pidx = _build(ktt, name, xb, cfg, dtype_name)
    np.testing.assert_array_equal(_search(cross_load(pidx, kt, dtype_name), kt, xq, cfg)[0],
                                  _search(pidx, ktt, xq, cfg)[0])
    f32 = np.asarray(xb, np.float32)
    d2 = ((np.asarray(xq, np.float32)[:, None, :] - f32[None]) ** 2).sum(-1)
    if metric == "L2":
        assert recall(_search(pidx, ktt, xq, cfg)[0], np.argsort(d2, 1)[:, :K]) >= 0.5


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_typed_get_vector_by_ids_and_round_trip(dtype_name, metric):
    """GetVectorByIds in the index's own dtype (bf16 as its bit patterns),
    bit-equal to the JAX package's and to the input (L2); BinarySets
    cross-load both ways and round-trip."""
    xb, xq = _typed(dtype_name, seed=3)
    cfg = {"metric_type": metric, "nlist": NLIST, "k": K, "nprobe": NPROBE}
    jidx = _build(kt, "IVF_FLAT", xb, cfg, dtype_name)
    tidx = _build(ktt, "IVF_FLAT", xb, cfg, dtype_name)
    ids = np.array([5, 17, NB - 1], np.int64)
    got = np.asarray(tidx.GetVectorByIds(ktt.GenIdsDataSet(ids)).value().tensor)
    want = np.asarray(jidx.GetVectorByIds(kt.GenIdsDataSet(ids)).value().tensor)
    assert got.dtype == (np.uint16 if dtype_name == "bf16" else xb.dtype)
    np.testing.assert_array_equal(_bits_of(got), _bits_of(want))
    if metric == "L2":
        np.testing.assert_array_equal(_bits_of(got), _bits_of(xb[ids]))
    set_precision(False)
    from_j, from_t = cross_load(jidx, ktt, dtype_name), cross_load(tidx, kt, dtype_name)
    np.testing.assert_array_equal(_search(from_j, ktt, xq, cfg)[0], _search(jidx, kt, xq, cfg)[0])
    np.testing.assert_array_equal(_search(from_t, kt, xq, cfg)[0], _search(tidx, ktt, xq, cfg)[0])
    back = cross_load(tidx, ktt, dtype_name)
    np.testing.assert_array_equal(_search(back, ktt, xq, cfg)[0], _search(tidx, ktt, xq, cfg)[0])
    for key, arr in tidx.node._sorted_payload.items():
        np.testing.assert_array_equal(_bits_of(arr), _bits_of(jidx.node._sorted_payload[key]))


def test_typed_calc_dist_range_and_iterator_match_jax(dtype_name):
    xb, xq = _typed(dtype_name, seed=4)
    cfg = {"metric_type": "L2", "nlist": NLIST, "k": K, "nprobe": NPROBE}
    jidx = _build(kt, "IVF_FLAT", xb, cfg, dtype_name)
    tidx = cross_load(jidx, ktt, dtype_name)
    ids = np.arange(0, NB, 97)
    dj = jidx.CalcDistByIDs(kt.GenDataSetFromArray(xq), None, ids, None).value()
    dt = tidx.CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, ids, None).value()
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    set_precision(False)
    radius = float(np.median(_search(jidx, kt, xq, cfg)[1][:, -1]))
    rcfg = dict(cfg, radius=radius)
    rj = jidx.RangeSearch(kt.GenDataSetFromArray(xq), rcfg, kt.BitsetView()).value()
    rt = tidx.RangeSearch(ktt.GenDataSetFromArray(xq), rcfg, ktt.BitsetView()).value()
    np.testing.assert_array_equal(rt.lims, rj.lims)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.distance, rj.distance, rtol=1e-5)
    # the covering pass reads the host rows (an fp16 corpus: fp16 values, not the bf16 device copy)
    d_j, i_j = jidx.node._full_sorted(np.asarray(xq[:3], np.float32), kt.BitsetView())
    d_t, i_t = tidx.node._full_sorted(np.asarray(xq[:3], np.float32), ktt.BitsetView())
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)


# ---------------------------------------------------------------------------
# CalcDistByIDs on an SQ8 refine store (the reference scores the raw codes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refine_type", ["SQ8", "BF16", "FP16"])
def test_refine_store_calc_dist_by_ids_matches_jax(refine_type):
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((NB, 32)).astype(np.float32)
    xq = rng.standard_normal((NQ, 32)).astype(np.float32)
    jidx = _build(kt, "IVF_PQ", xb, {"metric_type": "L2", "nlist": NLIST, "m": 8, "refine": True,
                                      "refine_type": refine_type}, "fp32")
    tidx = cross_load(jidx, ktt)
    ids = np.array([0, 7, 100, NB - 1])
    dj = jidx.CalcDistByIDs(kt.GenDataSetFromArray(xq), None, ids, None).value()
    dt = tidx.CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, ids, None).value()
    np.testing.assert_allclose(dt, dj, rtol=1e-6)
    if refine_type == "SQ8":  # the codes as they are: distances to rows of values in [0, 255]
        codes = np.asarray(jidx.node._sorted_payload["refine"])[jidx.node._pos_of_row[ids]].astype(np.float64)
        ref = ((xq[:, None, :].astype(np.float64) - codes[None]) ** 2).sum(-1)
        np.testing.assert_allclose(dt, ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_matches_jax_for_flat_and_ivf_names():
    """Every name the JAX package's FLAT and IVF modules register, with the
    same data types and feature bits (EMB_LIST included: FLAT and IVF_FLAT
    carry it), and no other FLAT or IVF name."""
    def table(reg, modules):
        out = {}
        for (name, dt), (ctor, feats) in reg.items():
            cls = next((c for c in ctor.__defaults__ or () if isinstance(c, type)), ctor)  # register_index's make
            if cls.__module__ in modules:
                out.setdefault(name, [set(), feats])[0].add(dt)
        return out

    want = table(JFactory.Instance()._registry, ("knowhere_tpu.models.flat", "knowhere_tpu.models.ivf"))
    # SVS_FLAT: FLAT's node under an SVS name, registered by models/svs.py in both packages
    got = table(ktt.IndexFactory.Instance()._registry,
                ("knowhere_tpu_torch.models.flat", "knowhere_tpu_torch.models.ivf"))
    assert len(want) == 21 and "SVS_FLAT" in want
    assert got == want
    for name in want:
        for dt in want[name][0]:
            cfg_j = JFactory.Instance().Create(name, data_type=dt).value().node.CreateConfig()
            cfg_t = ktt.IndexFactory.Instance().Create(name, data_type=dt).value().node.CreateConfig()
            assert type(cfg_t).__name__ == type(cfg_j).__name__, name
