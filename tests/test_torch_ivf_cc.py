"""Add after build and the IVF_*_CC epochs, against the JAX package.

Add on a built IVF index appends to a copy-on-write pending list; Search
merges an exact scan of the pending rows into its result; once the pending
rows pass max(4096, stored rows / 4) the writer builds the next epoch off the
read lock and swaps it in. The JAX package builds each index and the port
loads its BinarySet; both then take the same Adds, across the threshold,
and must answer alike after every one, and serialize to the same bytes.
tests/test_cc_concurrent.py's add-during-search check runs on the port.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt

from .torch_parity import cross_load, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

DIM, K = 32, 10


def _ds(pkg, x):
    return pkg.GenDataSetFromArray(x)


def _search(idx, pkg, xq, cfg, bitset=None):
    res = idx.Search(_ds(pkg, xq), cfg, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(len(xq), -1), res.value().distance.reshape(len(xq), -1)


def _blob(idx, pkg):
    bs = pkg.BinarySet()
    assert idx.Serialize(bs) == pkg.Status.success
    return bs.GetByName(idx.Type()).tobytes()


@pytest.mark.parametrize("name", ["IVF_FLAT_CC", "IVF_SQ_CC"])
def test_cc_add_during_search(name):
    """tests/test_cc_concurrent.py on the port: three searchers loop while
    six Adds cross the merge threshold several times; no search fails or
    comes back empty, every row is counted, and a freshly added row is
    found by its own vector. The interpreter switches threads every 10 us
    meanwhile, so a lost update between the writer and the readers shows."""
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((6000, DIM), dtype=np.float32)
    xq = rng.standard_normal((8, DIM), dtype=np.float32)
    cfg = {"metric_type": "L2", "k": K, "nlist": 16, "nprobe": 16}
    idx = ktt.IndexFactory.Instance().Create(name).value()
    assert idx.Build(_ds(ktt, xb), cfg) == ktt.Status.success
    stop, errors, searches = threading.Event(), [], [0]

    def searcher():
        while not stop.is_set():
            r = idx.Search(_ds(ktt, xq), cfg, ktt.BitsetView())
            if not r.has_value():
                errors.append(r.what())
                return
            ids = r.value().ids.reshape(8, -1)
            if (ids < 0).any() or ids.max() >= idx.Count():
                errors.append(f"bad ids {ids}")
                return
            searches[0] += 1

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        total = 6000
        for _ in range(6):
            batch = rng.standard_normal((1500, DIM), dtype=np.float32)
            assert idx.Add(_ds(ktt, batch), cfg) == ktt.Status.success
            total += 1500
            time.sleep(0.01)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert searches[0] > 0 and idx.Count() == total
    ids, dist = _search(idx, ktt, batch[:3], cfg)
    np.testing.assert_array_equal(ids[:, 0], total - 1500 + np.arange(3))
    if name == "IVF_FLAT_CC":  # raw rows: the distance to itself (IVF_SQ_CC's is the SQ8 grid's error)
        assert (dist[:, 0] <= 1e-4).all()


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("name", ["IVF_FLAT_CC", "IVF_SQ_CC", "IVF_FLAT"])
def test_pending_merge_matches_jax(name, metric):
    """The same Adds on both packages, across the merge threshold (4096
    pending rows: merges after the 5th and the 10th Add): after every Add
    the pending count, Count and the search (pending rows merged in, and
    under a bitset that reaches into them) agree, and the merged epochs
    serialize to the same bytes."""
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((6000, DIM), dtype=np.float32)
    xq = rng.standard_normal((12, DIM), dtype=np.float32)
    cfg = {"metric_type": metric, "k": K, "nlist": 16, "nprobe": 6}
    jidx = kt.IndexFactory.Instance().Create(name).value()
    assert jidx.Build(_ds(kt, x0), cfg) == kt.Status.success
    tidx = cross_load(jidx, ktt)
    set_precision(False)
    merges, count = 0, 6000
    for step in range(10):
        add = rng.standard_normal((900, DIM), dtype=np.float32)
        assert jidx.Add(_ds(kt, add), cfg) == kt.Status.success
        assert tidx.Add(_ds(ktt, add), cfg) == ktt.Status.success
        count += 900
        merges += tidx.node._pending_count == 0
        assert tidx.node._pending_count == jidx.node._pending_count
        assert tidx.Count() == jidx.Count() == count
        ids_t, d_t = _search(tidx, ktt, xq, cfg)
        ids_j, d_j = _search(jidx, kt, xq, cfg)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
        drop = np.random.default_rng(step).random(count) < 0.5
        ids_t, _ = _search(tidx, ktt, xq, cfg, ktt.BitsetView.from_bool_array(drop))
        ids_j, _ = _search(jidx, kt, xq, cfg, kt.BitsetView.from_bool_array(drop))
        np.testing.assert_array_equal(ids_t, ids_j)
        assert not drop[ids_t[ids_t >= 0]].any()
    assert merges == 2
    assert _blob(tidx, ktt) == _blob(jidx, kt)


def test_pending_rows_fold_before_range_iterator_and_serialize():
    """RangeSearch, AnnIterator and Serialize merge the pending rows first,
    as the reference does; Count includes them before."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((5000, DIM), dtype=np.float32)
    add = rng.standard_normal((700, DIM), dtype=np.float32)
    xq = add[:4]
    cfg = {"metric_type": "L2", "k": K, "nlist": 16, "nprobe": 16, "radius": 20.0}
    idx = {}
    for pkg in (kt, ktt):
        idx[pkg] = pkg.IndexFactory.Instance().Create("IVF_FLAT_CC").value()
        assert idx[pkg].Build(_ds(pkg, x0), cfg) == pkg.Status.success
    set_precision(False)
    for call in ("RangeSearch", "AnnIterator", "Serialize"):
        for pkg in (kt, ktt):
            assert idx[pkg].Add(_ds(pkg, add), cfg) == pkg.Status.success
            assert idx[pkg].node._pending_count == 700
        n = idx[ktt].Count()
        if call == "RangeSearch":
            rj = idx[kt].RangeSearch(_ds(kt, xq), cfg, kt.BitsetView()).value()
            rt = idx[ktt].RangeSearch(_ds(ktt, xq), cfg, ktt.BitsetView()).value()
            np.testing.assert_array_equal(rt.lims, rj.lims)
            np.testing.assert_array_equal(rt.ids, rj.ids)
            assert set(n - 700 + np.arange(4)) <= set(rt.ids.tolist())
        elif call == "AnnIterator":
            its_t = idx[ktt].AnnIterator(_ds(ktt, xq), cfg, ktt.BitsetView()).value()
            its_j = idx[kt].AnnIterator(_ds(kt, xq), cfg, kt.BitsetView()).value()
            for it_t, it_j in zip(its_t, its_j):
                ids_t = [i for i, _ in (it_t.Next() for _ in range(15))]
                assert ids_t == [i for i, _ in (it_j.Next() for _ in range(15))]
        else:
            assert _blob(idx[ktt], ktt) == _blob(idx[kt], kt)
        assert idx[ktt].node._pending_count == 0 and idx[ktt].Count() == n


@pytest.mark.parametrize("name,data_type", [("IVF_FLAT", "fp16"), ("IVF_FLAT", "bf16"), ("BIN_IVF_FLAT", "bin1"),
                                            ("SCANN", "fp32"), ("IVF_PQ", "fp32"), ("IVF_RABITQ", "fp32")])
def test_add_after_build_matches_jax(name, data_type):
    """Add on a built index of the other variants: typed and binary rows
    pend at their width, quantized stores re-merge from their decoded rows
    (faiss's reconstruct), as the reference does. The queries are stored
    rows: their distances to themselves cancel to within 1e-4 of 0 (|x|^2 is
    about 32), where the two packages' f32 sums may round apart."""
    import ml_dtypes

    rng = np.random.default_rng(6)
    cfg = {"metric_type": "HAMMING" if data_type == "bin1" else "L2", "k": K, "nlist": 8, "nprobe": 8, "m": 8}
    if data_type == "bin1":
        x = np.packbits(rng.random((9000, 128)) < 0.5, axis=1, bitorder="little")
        ds = {p: (lambda p: lambda a: p.GenDataSet(a.shape[0], 128, a))(p) for p in (kt, ktt)}
    else:
        x = rng.standard_normal((9000, DIM)).astype(np.float32)
        x = x.astype({"fp16": np.float16, "bf16": ml_dtypes.bfloat16}.get(data_type, np.float32))
        ds = {p: p.GenDataSetFromArray for p in (kt, ktt)}
    jidx = kt.IndexFactory.Instance().Create(name, data_type=data_type).value()
    assert jidx.Build(ds[kt](x[:4000]), cfg) == kt.Status.success
    tidx = cross_load(jidx, ktt, data_type)
    set_precision(False)
    for a, b in ((4000, 6000), (6000, 9000)):  # pending, then a merge
        for idx, p in ((jidx, kt), (tidx, ktt)):
            assert idx.Add(ds[p](x[a:b]), cfg) == p.Status.success
        rj = jidx.Search(ds[kt](x[:9000:400]), cfg, kt.BitsetView()).value()
        rt = tidx.Search(ds[ktt](x[:9000:400]), cfg, ktt.BitsetView()).value()
        np.testing.assert_array_equal(rt.ids, rj.ids)
        np.testing.assert_allclose(rt.distance, rj.distance, rtol=1e-5, atol=1e-4)
    assert tidx.node._pending_count == 0 and tidx.Count() == 9000
    if name != "IVF_RABITQ":
        assert _blob(tidx, ktt) == _blob(jidx, kt)
        return
    # the re-encode's r_norm and t: within rabitq_encode's tolerance
    # (tests/test_torch_ivf_rabitq.py), every other section bit-equal
    from knowhere_tpu_torch.io.serialize import read_sections

    (arr_t, meta_t), (arr_j, meta_j) = read_sections(_blob(tidx, ktt)), read_sections(_blob(jidx, kt))
    assert meta_t == meta_j and arr_t.keys() == arr_j.keys()
    for key in arr_t:
        if key in ("payload_r_norm", "payload_t"):
            np.testing.assert_allclose(arr_t[key], arr_j[key], rtol=1e-5)
        else:
            np.testing.assert_array_equal(arr_t[key], arr_j[key])
