"""The port's emb_list family (tokenann, MUVERA and LEMUR over FLAT, HNSW
and IVF_FLAT; MAX_SIM and DTW) against the JAX package:
tests/test_emb_list.py's TestEmbList, TestAggregateOracles and module checks
on the port, and both packages on the same seeded documents.

Tolerances: scores within 1e-5 relative + 1e-5 (f32 products and sums in
other orders); ids equal except where two JAX scores lie within that
tolerance of each other. MUVERA's FDE within 1e-5 except the documents
holding a token within 1e-4 of a SimHash plane (its sign bit may flip
between the two products; those are counted). LEMUR: the JAX-trained MLP,
carried across in EMB_LIST_META, gives the JAX package's query encodings
within 1e-5 relative + 1e-6 and its ids; a LEMUR trained in the port (its
own seeded initialisation, torch.optim.Adam) lands within 0.2 of the
JAX-trained recall.
"""

import numpy as np
import pytest

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.models import emb_list as jel
from knowhere_tpu_torch.device import to_device
from knowhere_tpu_torch.models import emb_list as tel

from .torch_parity import set_precision

NDOCS, DIM = 120, 32
RTOL = ATOL = 1e-5
LEMUR = {"lemur_num_epochs": 2, "lemur_num_train_samples": 200, "lemur_hidden_dim": 32}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    ktt.set_device("cpu")
    set_precision(False)


def gen_emb_list(pkg, ndocs, dim, min_tok=3, max_tok=8, seed=0):
    rng = np.random.default_rng(seed)
    lims = [0]
    toks = []
    for _ in range(ndocs):
        n = rng.integers(min_tok, max_tok + 1)
        toks.append(rng.standard_normal((n, dim)).astype(np.float32))
        lims.append(lims[-1] + n)
    ds = pkg.DataSet()
    ds.set("tensor", np.concatenate(toks))
    ds.lims = np.asarray(lims, dtype=np.int64)
    ds.rows = lims[-1]
    ds.dim = dim
    return ds


def maxsim_oracle(base_ds, q_ds, metric="MAX_SIM_IP"):
    """Exact numpy MaxSim scores (queries x docs)."""
    xb, bl = np.asarray(base_ds.tensor, np.float64), base_ds.lims
    xq, ql = np.asarray(q_ds.tensor, np.float64), q_ds.lims
    nq, nd = len(ql) - 1, len(bl) - 1
    scores = np.zeros((nq, nd))
    for i in range(nq):
        q = xq[ql[i] : ql[i + 1]]
        for j in range(nd):
            d = xb[bl[j] : bl[j + 1]]
            if metric.endswith("_L2"):
                sim = -(((q[:, None, :] - d[None, :, :]) ** 2).sum(-1))
            elif metric.endswith("_IP"):
                sim = q @ d.T
            else:  # cosine
                qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
                dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
                sim = qn @ dn.T
            scores[i, j] = sim.max(axis=1).sum()
    return scores


def recall(gt_scores, ids, k):
    hits = 0
    for i in range(ids.shape[0]):
        gt = set(np.argsort(-gt_scores[i])[:k].tolist())
        hits += len(gt & set(ids[i].tolist()) - {-1})
    return hits / (ids.shape[0] * k)


def _build(pkg, name, cfg, base=None):
    idx = pkg.IndexFactory.Instance().Create(name).value()
    st = idx.Build(base if base is not None else gen_emb_list(pkg, NDOCS, DIM, seed=91), cfg)
    assert st == pkg.Status.success, st
    return idx


def _queries(pkg):
    return gen_emb_list(pkg, 5, DIM, min_tok=2, max_tok=4, seed=92)


def _search(pkg, idx, cfg, k=5, q=None, bitset=None):
    res = idx.Search(q if q is not None else _queries(pkg), dict(cfg, k=k), bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    return res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)


def _assert_near(got, want):
    (ids_t, d_t), (ids_j, d_j) = got, want
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL, atol=ATOL)
    diff = ids_t != ids_j
    if diff.any():
        gap = np.abs(np.diff(d_j, axis=1)) <= RTOL * np.abs(d_j[:, 1:]) + ATOL
        near = np.zeros_like(diff)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        assert (~diff | near).all()


def _cross_load(idx, dst, name):
    src = kt if isinstance(idx, kt.Index) else ktt
    bs = src.BinarySet()
    assert idx.Serialize(bs) == src.Status.success
    bs2 = dst.BinarySet()
    for n in bs:
        bs2.Append(n, bs.GetByName(n).tobytes())
    out = dst.IndexFactory.Instance().Create(name).value()
    assert out.Deserialize(bs2) == dst.Status.success
    return out


# --- tests/test_emb_list.py::TestEmbList on the port ----------------------------------


@pytest.mark.parametrize("strategy", ["tokenann", "muvera", "lemur"])
def test_max_sim_ip(strategy):
    cfg = {"metric_type": "MAX_SIM_IP", "emb_list_strategy": strategy, **(LEMUR if strategy == "lemur" else {})}
    idx = _build(ktt, "FLAT", cfg)
    assert idx.Count() == NDOCS
    ids, _ = _search(ktt, idx, {"metric_type": "MAX_SIM_IP", "retrieval_ann_ratio": 3.0})
    gt = maxsim_oracle(gen_emb_list(ktt, NDOCS, DIM, seed=91), _queries(ktt), "MAX_SIM_IP")
    assert recall(gt, ids, 5) >= 0.6, strategy


def test_max_sim_cosine_default():
    idx = _build(ktt, "FLAT", {"metric_type": "MAX_SIM"})
    ids, _ = _search(ktt, idx, {"metric_type": "MAX_SIM"})
    gt = maxsim_oracle(gen_emb_list(ktt, NDOCS, DIM, seed=91), _queries(ktt), "MAX_SIM_COSINE")
    assert recall(gt, ids, 5) >= 0.6


def test_dtw_equals_jax():
    """tests/test_emb_list.py::test_dtw on the port, and the JAX ids."""
    got = [_search(pkg, _build(pkg, "FLAT", {"metric_type": "DTW_IP"}), {"metric_type": "DTW_IP"}) for pkg in (kt, ktt)]
    assert (got[1][0] >= -1).all()
    _assert_near(got[1], got[0])


def test_doc_level_bitset():
    filtered = np.zeros(NDOCS, bool)
    filtered[::2] = True
    got = []
    for pkg in (kt, ktt):
        idx = _build(pkg, "FLAT", {"metric_type": "MAX_SIM_IP"})
        got.append(_search(pkg, idx, {"metric_type": "MAX_SIM_IP"}, bitset=pkg.BitsetView.from_bool_array(filtered)))
    ids = got[1][0]
    assert (ids[ids >= 0] % 2 == 1).all()
    _assert_near(got[1], got[0])


@pytest.mark.parametrize("src,dst", [(ktt, ktt), (kt, ktt), (ktt, kt)], ids=["round_trip", "jax_to_port", "port_to_jax"])
def test_serialize_roundtrip(src, dst):
    idx = _build(src, "FLAT", {"metric_type": "MAX_SIM_IP"})
    idx2 = _cross_load(idx, dst, "FLAT")
    assert idx2.Count() == NDOCS
    want = _search(src, idx, {"metric_type": "MAX_SIM_IP"})
    got = _search(dst, idx2, {"metric_type": "MAX_SIM_IP"}, q=_queries(dst))
    if src is dst:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        _assert_near(got, want) if dst is ktt else _assert_near(want, got)


@pytest.mark.parametrize("name,metric,cfg", [
    ("IVF_PQ", "MAX_SIM_IP", {"m": 8}),
    ("IVF_SQ8", "DTW_COSINE", {}),
    ("FLAT", "MAX_SIM_HAMMING", {}),
], ids=["ivf_pq", "ivf_sq8_dtw", "flat_hamming"])
def test_unsupported_rejected(name, metric, cfg):
    """Index types without the EMB_LIST feature answer invalid_metric_type
    (the reference's gate), in both packages; a binary token metric over
    float tokens fails the same way in both."""
    codes = []
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create(name).value()
        codes.append(idx.Build(gen_emb_list(pkg, NDOCS, DIM, seed=91), {"metric_type": metric, **cfg}))
    assert codes[1].name == codes[0].name
    if name != "FLAT":
        assert codes[1] == ktt.Status.invalid_metric_type


# --- TestAggregateOracles and the module checks on the port ------------------------------


def test_max_sim_hand_case():
    lims = np.array([0, 2, 4], np.int64)
    tokens = np.array([[1, 0], [0, 1], [1, 0], [1, 0]], np.float32)
    q = np.array([[1, 0], [0, 1]], np.float32)
    idx = ktt.IndexFactory.Instance().Create("FLAT").value()
    assert idx.Build(ktt.DataSet(tensor=tokens, lims=lims, rows=4, dim=2), {"metric_type": "MAX_SIM_IP"}) == ktt.Status.success
    qds = ktt.DataSet(tensor=q, lims=np.array([0, 2], np.int64), rows=2, dim=2)
    res = idx.Search(qds, {"metric_type": "MAX_SIM_IP", "k": 2})
    assert res.has_value(), res.what()
    ids, d = res.value().ids.reshape(1, 2), res.value().distance.reshape(1, 2)
    assert ids[0, 0] == 0 and ids[0, 1] == 1, ids
    np.testing.assert_allclose(d[0], [2.0, 1.0], atol=1e-5)


def test_dtw_monotone_alignment():
    assert tel.dtw_score(np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)) == 2.0
    assert tel.dtw_score(np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)) == 1.0


def test_dtw_batch_matches_scalar():
    """The wavefront over every segment at once equals the scalar DP, and
    the JAX package's batch bit for bit (the same f32 adds and maxima)."""
    rng = np.random.default_rng(3)
    seg_lens = [1, 3, 9, 4, 2]
    sim = rng.standard_normal((7, sum(seg_lens))).astype(np.float32)
    ends = np.cumsum(seg_lens)
    starts = ends - np.asarray(seg_lens)
    batch = tel.dtw_scores_batch(sim, starts, ends)
    np.testing.assert_allclose(batch, [tel.dtw_score(sim[:, a:b]) for a, b in zip(starts, ends)], rtol=1e-5)
    np.testing.assert_array_equal(batch, jel.dtw_scores_batch(sim, starts, ends))


def test_max_sim_batch_matches_scalar():
    rng = np.random.default_rng(4)
    seg_lens = [2, 5, 1, 8]
    sim = rng.standard_normal((6, sum(seg_lens))).astype(np.float32)
    ends = np.cumsum(seg_lens)
    starts = ends - np.asarray(seg_lens)
    batch = tel.max_sim_scores_batch(sim, starts, ends)
    np.testing.assert_allclose(batch, [tel.max_sim_score(sim[:, a:b]) for a, b in zip(starts, ends)], rtol=1e-6)
    empty = tel.max_sim_scores_batch(sim, np.array([0, 3]), np.array([0, 5]))
    assert empty[0] == -np.inf and np.isfinite(empty[1])


def test_muvera_num_projections_uncapped():
    ds, qds = gen_emb_list(ktt, 30, 16, seed=11), gen_emb_list(ktt, 2, 16, seed=12)
    dims = {}
    for npj in (4, 8):
        cfg = {"metric_type": "MAX_SIM_IP", "k": 3, "emb_list_strategy": "muvera",
               "muvera_num_projections": npj, "muvera_num_repeats": 2, "retrieval_ann_ratio": 2.0}
        idx = ktt.IndexFactory.Instance().Create("FLAT").value()
        assert idx.Build(ds, cfg) == ktt.Status.success
        assert idx.Search(qds, cfg, ktt.BitsetView()).has_value()
        dims[npj] = idx._emb._under.Dim()
    assert dims[8] > dims[4], dims
    assert dims[8] == 2 * 256 * 16


def test_muvera_refuses_above_2_22_dims():
    cfg = {"metric_type": "MAX_SIM_IP", "emb_list_strategy": "muvera", "muvera_num_projections": 16,
           "muvera_num_repeats": 8}
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create("FLAT").value()
        assert idx.Build(gen_emb_list(pkg, 10, 16, seed=1), cfg) == pkg.Status.invalid_args


# --- the port against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("name,extra,scfg", [
    ("FLAT", {}, {}),
    ("IVF_FLAT", {"nlist": 8}, {}),
], ids=["flat", "ivf_flat"])
@pytest.mark.parametrize("metric", ["MAX_SIM_IP", "MAX_SIM_COSINE", "MAX_SIM_L2"])
def test_tokenann_equals_jax(name, extra, scfg, metric):
    cfg = {"metric_type": metric, **extra}
    got = [_search(pkg, _build(pkg, name, cfg), {"metric_type": metric, **scfg}, k=8) for pkg in (kt, ktt)]
    _assert_near(got[1], got[0])


def test_tokenann_hnsw_cross_loaded_equals_jax():
    """tokenann over HNSW (MAX_SIM_COSINE): the JAX-built BinarySet loaded
    in the port answers with the JAX ids; the port's own HNSW build too,
    ties aside, on this corpus."""
    cfg = {"metric_type": "MAX_SIM_COSINE", "M": 8, "efConstruction": 64}
    jidx = _build(kt, "HNSW", cfg)
    want = _search(kt, jidx, {"metric_type": "MAX_SIM_COSINE"}, k=8)
    _assert_near(_search(ktt, _cross_load(jidx, ktt, "HNSW"), {"metric_type": "MAX_SIM_COSINE"}, k=8), want)
    _assert_near(_search(ktt, _build(ktt, "HNSW", cfg), {"metric_type": "MAX_SIM_COSINE"}, k=8), want)


def test_muvera_fde_equals_jax():
    """The same planes and projections from np.random.default_rng(seed):
    document and query FDEs equal the JAX package's within 1e-5, except the
    documents holding a token within 1e-4 of a plane (counted)."""
    base = gen_emb_list(ktt, NDOCS, DIM, seed=91)
    tokens, lims = np.asarray(base.tensor), base.lims
    params = {"num_projections": 8, "num_repeats": 10, "seed": 3}
    j, t = jel.EmbListIndex(None, "FLAT"), tel.EmbListIndex(None, "FLAT")
    j._fde_params = t._fde_params = params
    rng = np.random.default_rng(params["seed"])
    margin = np.full(tokens.shape[0], np.inf)
    d_proj = min(DIM, max(8, 64 // max(params["num_repeats"] // 4, 1)))
    for _ in range(params["num_repeats"]):
        plane = rng.standard_normal((DIM, params["num_projections"])).astype(np.float32)
        rng.standard_normal((DIM, d_proj))
        margin = np.minimum(margin, np.abs(tokens.astype(np.float64) @ plane.astype(np.float64)).min(1))
    prone_docs = np.unique(np.searchsorted(lims, np.nonzero(margin < 1e-4)[0], side="right") - 1)
    for query in (False, True):
        fj = j._muvera_fde(tokens, lims, query=query)
        ft = t._muvera_fde(to_device(tokens), lims, query=query)
        assert ft.shape == fj.shape == (NDOCS, 10 * 256 * d_proj)
        keep = np.setdiff1d(np.arange(NDOCS), prone_docs)
        np.testing.assert_allclose(ft[keep], fj[keep], rtol=1e-5, atol=1e-5)
        flipped = [d for d in prone_docs if not np.allclose(ft[d], fj[d], rtol=1e-5, atol=1e-5)]
        assert len(prone_docs) <= 2 and len(flipped) <= len(prone_docs), (prone_docs, flipped)


def test_muvera_equals_jax():
    cfg = {"metric_type": "MAX_SIM_IP", "emb_list_strategy": "muvera"}
    got = [_search(pkg, _build(pkg, "FLAT", cfg), {"metric_type": "MAX_SIM_IP", "retrieval_ann_ratio": 3.0})
           for pkg in (kt, ktt)]
    _assert_near(got[1], got[0])


def test_lemur_carried_across_equals_jax():
    """The JAX-trained MLP loaded from EMB_LIST_META: the port's query
    encodings are the JAX package's within 1e-5 relative + 1e-6, and its
    ids too; a LEMUR trained in the port (its own initialisation) lands
    within 0.2 of the JAX-trained recall, at 0.6 or more."""
    cfg = {"metric_type": "MAX_SIM_IP", "emb_list_strategy": "lemur", **LEMUR}
    scfg = {"metric_type": "MAX_SIM_IP", "retrieval_ann_ratio": 3.0}
    jidx = _build(kt, "FLAT", cfg)
    tidx = _cross_load(jidx, ktt, "FLAT")
    q = _queries(ktt)
    qt, ql = np.asarray(q.tensor), q.lims
    enc_j = jidx._emb._lemur_encode_queries(qt, ql)
    enc_t = tidx._emb._lemur_encode_queries(to_device(qt), ql)
    np.testing.assert_allclose(enc_t, enc_j, rtol=1e-5, atol=1e-6)
    want = _search(kt, jidx, scfg)
    _assert_near(_search(ktt, tidx, scfg), want)
    back = _cross_load(tidx, kt, "FLAT")  # the weights travel back unchanged
    np.testing.assert_array_equal(_search(kt, back, scfg)[0], want[0])
    gt = maxsim_oracle(gen_emb_list(ktt, NDOCS, DIM, seed=91), q, "MAX_SIM_IP")
    r_jax = recall(gt, want[0], 5)
    r_port = recall(gt, _search(ktt, _build(ktt, "FLAT", cfg), scfg)[0], 5)
    assert r_port >= 0.6 and abs(r_port - r_jax) <= 0.2, (r_port, r_jax)


def test_get_emb_list_by_ids_equals_jax():
    got = []
    for pkg in (kt, ktt):
        idx = _build(pkg, "FLAT", {"metric_type": "MAX_SIM_IP"})
        r = idx.GetEmbListByIds(pkg.GenIdsDataSet(np.array([5, 0, 119])))
        assert r.has_value(), r.what()
        got.append((np.asarray(r.value().tensor), np.asarray(r.value().lims)))
        assert idx.GetEmbListByIds(pkg.GenIdsDataSet(np.array([NDOCS]))).error() == pkg.Status.invalid_args
        plain = pkg.IndexFactory.Instance().Create("FLAT").value()
        plain.Build(pkg.GenDataSetFromArray(np.zeros((4, DIM), np.float32)), {"metric_type": "L2"})
        assert plain.GetEmbListByIds(pkg.GenIdsDataSet(np.array([0]))).error() == pkg.Status.not_implemented
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1], got[0][1])


def test_dataset_without_lims():
    """A dataset without lims: invalid_args in the port; the JAX package
    raises a TypeError there (internal_error)."""
    rows = np.random.default_rng(0).standard_normal((20, DIM)).astype(np.float32)
    codes = {}
    for pkg in (kt, ktt):
        idx = pkg.IndexFactory.Instance().Create("FLAT").value()
        codes[pkg] = idx.Build(pkg.GenDataSetFromArray(rows), {"metric_type": "MAX_SIM_IP"})
    assert codes[ktt] == ktt.Status.invalid_args
    assert codes[kt] == kt.Status.internal_error
    idx = _build(ktt, "FLAT", {"metric_type": "MAX_SIM_IP"})
    res = idx.Search(ktt.GenDataSetFromArray(rows[:3]), {"metric_type": "MAX_SIM_IP", "k": 3})
    assert res.error() == ktt.Status.invalid_args
