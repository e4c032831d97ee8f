"""The IVF family's host payloads spill to disk after every upload, as the
JAX package's do (knowhere_tpu/models/ivf.py, spill_dict after the upload).

With KNOWHERE_HOST_SPILL_THRESHOLD at 1 KiB, every payload array at or
above it must be a disk-backed memmap after Build and after a CC epoch
merge, and the readers of the host payloads must answer as an index built
with spilling off: GetVectorByIds, CalcDistByIDs, Serialize (the same
bytes), RangeSearch and the covering exact pass.
"""

import os

import numpy as np
import pytest
import torch

import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.utils import spill

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 6000, 6, 32, 10
THRESHOLD = 1024

CASES = {
    "IVF_FLAT": ("IVF_FLAT", {"nlist": 16}),
    "IVF_PQ_fp16_refine": ("IVF_PQ", {"nlist": 16, "m": 8, "nbits": 8, "refine": True, "refine_type": "FP16"}),
    "IVF_FLAT_CC_merged": ("IVF_FLAT_CC", {"nlist": 16}),
}


def _data():
    rng = np.random.default_rng(21)
    return rng.standard_normal((NB, DIM), dtype=np.float32), rng.standard_normal((NQ, DIM), dtype=np.float32)


def _build(monkeypatch, name, extra, xb, spill_on):
    """Build ``name`` with spilling on or off. The CC case builds on 1,500
    rows and Adds the rest 1,500 at a time: the third Add passes the merge
    threshold of 4,096 pending rows and swaps in a new epoch."""
    monkeypatch.setenv("KNOWHERE_HOST_SPILL", "1" if spill_on else "0")
    monkeypatch.setenv("KNOWHERE_HOST_SPILL_THRESHOLD", str(THRESHOLD))
    cfg = {"metric_type": "L2", **extra}
    idx = ktt.IndexFactory.Instance().Create(name).value()
    if name.endswith("_CC"):
        assert idx.Build(ktt.GenDataSetFromArray(xb[:1500]), cfg) == ktt.Status.success
        before = dict(idx.node._sorted_payload)
        for s in (1500, 3000, 4500):
            assert idx.Add(ktt.GenDataSetFromArray(xb[s : s + 1500]), cfg) == ktt.Status.success
        assert idx.node._row_ids is not None and idx.node._pending_count == 0  # the last Add merged an epoch
        if spill_on:  # the replaced epoch's files are gone
            files = [str(v.filename) for v in before.values() if isinstance(v, np.memmap)]
            assert files and not any(os.path.exists(f) for f in files)
    else:
        assert idx.Build(ktt.GenDataSetFromArray(xb), cfg) == ktt.Status.success
    return idx


def _readers(idx, xb, xq):
    pick = np.array([0, 7, 123, NB - 1])
    vec = idx.GetVectorByIds(ktt.GenIdsDataSet(pick))
    calc = idx.node.CalcDistByIDs(ktt.GenDataSetFromArray(xq), ktt.BitsetView(), pick, len(pick))
    assert calc.has_value(), calc.what()
    bs = ktt.BinarySet()
    assert idx.Serialize(bs) == ktt.Status.success
    d10 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    radius = float(np.median(np.sort(d10, 1)[:, 10]))
    rng = idx.RangeSearch(ktt.GenDataSetFromArray(xq), {"metric_type": "L2", "radius": radius, "nprobe": 16},
                          ktt.BitsetView())
    assert rng.has_value(), rng.what()
    full_d, full_i = idx.node._full_sorted(xq, ktt.BitsetView())
    return {
        "vectors": np.asarray(vec.value().tensor) if vec.has_value() else vec.error(),
        "calc": calc.value(),
        "blob": bs.GetByName(idx.Type()).tobytes(),
        "range": (rng.value().lims, rng.value().ids, rng.value().distance),
        "full": (full_d, full_i),
    }


@pytest.mark.parametrize("case", list(CASES))
def test_ivf_spills_host_payloads(monkeypatch, case):
    name, extra = CASES[case]
    xb, xq = _data()
    plain = _build(monkeypatch, name, extra, xb, spill_on=False)
    assert not any(isinstance(v, np.memmap) for v in plain.node._sorted_payload.values())
    want = _readers(plain, xb, xq)

    idx = _build(monkeypatch, name, extra, xb, spill_on=True)
    payload = idx.node._sorted_payload
    large = {k: v for k, v in payload.items() if v.nbytes >= THRESHOLD}
    assert large and all(isinstance(v, np.memmap) for v in large.values()), {k: type(v) for k, v in payload.items()}
    assert all(str(v.filename) in spill._files for v in large.values())
    got = _readers(idx, xb, xq)

    if isinstance(want["vectors"], np.ndarray):
        np.testing.assert_array_equal(got["vectors"], want["vectors"])
        np.testing.assert_array_equal(got["vectors"], xb[[0, 7, 123, NB - 1]])
    else:  # IVF_PQ holds no raw rows: the same Status
        assert got["vectors"] == want["vectors"]
    np.testing.assert_array_equal(got["calc"], want["calc"])
    assert got["blob"] == want["blob"]
    for a, b in zip(got["range"], want["range"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["full"], want["full"]):
        np.testing.assert_array_equal(a, b)
