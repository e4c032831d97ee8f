"""SCANN: 4-bit PQ (m = dim / sub_dim, ksub = 16) on the residuals plus the
raw rows for the reorder, against the JAX package.

The JAX package builds the index; the port loads its BinarySet. EXACT runs
the plain decode scan on both sides (ids equal); FAST runs the ADC scan in
the nibble layout (two codes a byte) on the port's side and the JAX
package's ADC kernel in interpret mode on the other, then both re-score
max(k, reorder_k) candidates from the raw rows: ids equal on at least 99% of
slots and distances within 1e-4 relative where they are, the tolerance of
tests/test_torch_ivf_pq.py.
"""

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.ops import ivf_scan as tscan

from .torch_parity import build, cross_load, interpret_env, ivf_corpus, recall, search, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K, NLIST, NPROBE = 4000, 32, 128, 10, 16, 8
BUILD = {"metric_type": "L2", "nlist": NLIST}
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE}


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env(align_min=2048)  # aligned lists at NB rows: the ADC kernel serves FAST


@pytest.fixture(scope="module")
def corpus():
    return ivf_corpus(NB, NQ, DIM, K)


@pytest.fixture(scope="module")
def jax_scann(corpus):
    return build(kt, "SCANN", corpus[0], BUILD)


@pytest.fixture(scope="module")
def port_scann(jax_scann):
    return cross_load(jax_scann, ktt)


def _assert_parity(ids_j, d_j, ids_t, d_t):
    same = ids_j == ids_t
    assert same.mean() >= 0.99
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-4)


def test_scann_config_and_store(port_scann):
    """sub_dim 2 -> m = 64 subspaces of 16 codewords, no OPQ, the codes two
    to a byte on the device, the raw rows as the refine store, and
    ensure_topk_full off by default."""
    node = port_scann.node
    assert node._pq.codebooks.shape == (DIM // 2, 16, 2) and node._opq_rot is None
    assert tscan._nib(node._store) and node._store["codes"].shape[1] == DIM // 4
    assert node._refine_store.kind == "raw" and node._refine_store.data.dtype == torch.float32
    from knowhere_tpu_torch.config import Config, Stage

    cfg = ktt.IndexFactory.Instance().Create("SCANN").value().node.CreateConfig()
    assert Config.load(cfg, {"metric_type": "L2", "k": K}, Stage.SEARCH)[0] == ktt.Status.success
    assert cfg.ensure_topk_full is False and cfg.reorder_k is None
    cfg = ktt.IndexFactory.Instance().Create("SCANN").value().node.CreateConfig()
    assert Config.load(cfg, {"metric_type": "L2"}, Stage.TRAIN)[0] == ktt.Status.success
    assert cfg.with_raw_data is True and cfg.sub_dim == 2


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("reorder_k", [None, 10, 40, 200])
def test_scann_search_matches_jax(corpus, jax_scann, port_scann, fast, reorder_k, monkeypatch):
    _, xq, gt = corpus
    hits = []
    orig = tscan._adc_search
    monkeypatch.setattr(tscan, "_adc_search", lambda *a, **kw: hits.append(1) or orig(*a, **kw))
    cfg = SEARCH if reorder_k is None else dict(SEARCH, reorder_k=reorder_k)
    set_precision(fast)
    ids_j, d_j = search(jax_scann, kt, xq, cfg)
    ids_t, d_t = search(port_scann, ktt, xq, cfg)
    assert bool(hits) == fast, "FAST must take the ADC scan, EXACT the decode scan"
    if fast:
        _assert_parity(ids_j, d_j, ids_t, d_t)
    else:
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-3)
    assert recall(ids_t, gt) >= (0.9 if (reorder_k or 0) >= 40 else 0.6)


def test_scann_reorder_widens_the_scan(port_scann, corpus, monkeypatch):
    """The scan keeps max(k, reorder_k) candidates for the reorder."""
    _, xq, _ = corpus
    seen = []
    orig = tscan.ivf_scan_search
    monkeypatch.setattr("knowhere_tpu_torch.models.ivf.ivf_scan_search",
                        lambda *a, **kw: seen.append(a[4]) or orig(*a, **kw))
    set_precision(True)
    for reorder_k, want in ((None, K), (5, K), (64, 64)):
        seen.clear()
        search(port_scann, ktt, xq, SEARCH if reorder_k is None else dict(SEARCH, reorder_k=reorder_k))
        assert seen == [want]


def test_scann_without_raw_data(corpus):
    xb, xq, _ = corpus
    jidx = build(kt, "SCANN", xb, dict(BUILD, with_raw_data=False))
    tidx = cross_load(jidx, ktt)
    assert not tidx.HasRawData("L2") and tidx.node._refine_store is None
    ids = ktt.GenIdsDataSet(np.array([1, 2]))
    assert tidx.GetVectorByIds(ids).error() == ktt.Status.not_implemented
    for fast in (False, True):
        set_precision(fast)
        ids_j, d_j = search(jidx, kt, xq, SEARCH)
        ids_t, d_t = search(tidx, ktt, xq, SEARCH)
        _assert_parity(ids_j, d_j, ids_t, d_t)


def test_scann_port_build_cross_loads(corpus, jax_scann, port_scann):
    """The port's own Build (recall at reorder_k=40), its BinarySet in the
    JAX package, the JAX package's in the port, GetVectorByIds bit-equal to
    the input rows and CalcDistByIDs equal to the reference's."""
    xb, xq, gt = corpus
    set_precision(True)
    cfg = dict(SEARCH, reorder_k=40)
    pidx = build(ktt, "SCANN", xb, BUILD)
    ids_t, _ = search(pidx, ktt, xq, cfg)
    assert recall(ids_t, gt) >= 0.9
    _assert_parity(*search(cross_load(pidx, kt), kt, xq, cfg), ids_t, search(pidx, ktt, xq, cfg)[1])
    want = np.array([0, 5, NB - 1])
    for idx in (pidx, port_scann):
        got = idx.GetVectorByIds(ktt.GenIdsDataSet(want)).value().tensor
        np.testing.assert_array_equal(got, xb.astype(np.float32)[want])
    dj = jax_scann.CalcDistByIDs(kt.GenDataSetFromArray(xq), None, want, None).value()
    dt = port_scann.CalcDistByIDs(ktt.GenDataSetFromArray(xq), None, want, None).value()
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    back = cross_load(port_scann, ktt)
    np.testing.assert_array_equal(search(back, ktt, xq, cfg)[0], search(port_scann, ktt, xq, cfg)[0])


def test_scann_range_and_iterator_match_jax(corpus, jax_scann, port_scann):
    _, xq, _ = corpus
    set_precision(False)
    radius = float(np.median(search(jax_scann, kt, xq, SEARCH)[1][:, -1]))
    cfg = dict(SEARCH, radius=radius)
    rj = jax_scann.RangeSearch(kt.GenDataSetFromArray(xq), cfg, kt.BitsetView()).value()
    rt = port_scann.RangeSearch(ktt.GenDataSetFromArray(xq), cfg, ktt.BitsetView()).value()
    np.testing.assert_array_equal(rt.lims, rj.lims)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    its_j = jax_scann.AnnIterator(kt.GenDataSetFromArray(xq[:2]), SEARCH, kt.BitsetView()).value()
    its_t = port_scann.AnnIterator(ktt.GenDataSetFromArray(xq[:2]), SEARCH, ktt.BitsetView()).value()
    for it_j, it_t in zip(its_j, its_t):
        a, b = [it_j.Next() for _ in range(20)], [it_t.Next() for _ in range(20)]
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([d for _, d in b], [d for _, d in a], rtol=1e-5)
