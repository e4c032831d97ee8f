"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the same
public-API calls on the JAX package and the port, BinarySets cross-loaded
between them, and the per-task top-k comparison of a kernel's plain version
with its Pallas kernel run in interpret mode."""

import os

import numpy as np

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops.distances import DistancePrecision as JP
from knowhere_tpu.ops.distances import set_distance_precision as jset_prec
from knowhere_tpu_torch.ops.distances import DistancePrecision as TP
from knowhere_tpu_torch.ops.distances import set_distance_precision as tset_prec


def interpret_env(align_min: int = 4096):
    """Body of a module fixture: the JAX package's IVF searches run their
    Pallas kernels in interpret mode and lists are aligned at test scale
    (corpora of at least ``align_min`` rows); the environment and both
    packages' precision are restored after."""
    saved = {k: os.environ.get(k) for k in ("KNOWHERE_PALLAS_INTERPRET", "KNOWHERE_IVF_ALIGN_MIN")}
    os.environ["KNOWHERE_PALLAS_INTERPRET"] = "1"
    os.environ["KNOWHERE_IVF_ALIGN_MIN"] = str(align_min)  # aligned lists at test scale
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    set_precision(False)


def set_precision(fast: bool) -> None:
    """FAST (the kernels' serving scans) or EXACT in both packages."""
    jset_prec(JP.FAST if fast else JP.EXACT)
    tset_prec(TP.FAST if fast else TP.EXACT)


def ivf_corpus(nb, nq, dim, k, seed=0):
    """The generator of tests/test_pallas_interpret_e2e.py, with more
    queries: (xb, xq, exact top-k ids)."""
    rng = np.random.default_rng(seed)
    nc, intr = 64, 32
    centers = rng.standard_normal((nc, dim)).astype(np.float32)
    W = rng.standard_normal((intr, dim)).astype(np.float32) * np.sqrt(dim / intr) / np.sqrt(intr)
    xb = centers[rng.integers(0, nc, nb)] + rng.standard_normal((nb, intr)).astype(np.float32) @ W
    xq = centers[rng.integers(0, nc, nq)] + rng.standard_normal((nq, intr)).astype(np.float32) @ W
    return xb, xq, exact_topk(xb, xq, k)


def exact_topk(xb, xq, k):
    d2 = (xq**2).sum(1)[:, None] - 2.0 * xq @ xb.T + (xb**2).sum(1)[None, :]
    return np.argsort(d2, 1, kind="stable")[:, :k]


def build(pkg, name, xb, cfg):
    idx = pkg.IndexFactory.Instance().Create(name).value()
    assert idx.Build(pkg.GenDataSetFromArray(xb), cfg) == pkg.Status.success
    return idx


def search(idx, pkg, xq, cfg, bitset=None):
    """(ids, distances), each (nq, k)."""
    res = idx.Search(pkg.GenDataSetFromArray(xq), cfg, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    k = cfg["k"]
    return res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)


def cross_load(src_idx, dst_pkg, data_type="fp32"):
    """Load src_idx's BinarySet bytes into a fresh index of the same name
    (and ``data_type``) in dst_pkg (the same package gives a
    Serialize/Deserialize round trip)."""
    src_pkg = kt if isinstance(src_idx, kt.Index) else ktt
    bs = src_pkg.BinarySet()
    assert src_idx.Serialize(bs) == src_pkg.Status.success
    bs2 = dst_pkg.BinarySet()
    for name in bs:
        bs2.Append(name, bs.GetByName(name).tobytes())
    idx = dst_pkg.IndexFactory.Instance().Create(src_idx.Type(), data_type=data_type).value()
    assert idx.Deserialize(bs2) == dst_pkg.Status.success
    return idx


def recall(ids, gt):
    return np.mean([len(set(ids[i]) & set(gt[i])) / gt.shape[1] for i in range(len(gt))])


def assert_same_topk(s_j, p_j, s_t, p_t, rtol, atol):
    """Per-task top-k of the port against the JAX kernel: scores within
    rtol/atol; positions identical except where two candidate scores lie
    within the tolerance of each other (the order of near-ties may flip)."""
    np.testing.assert_allclose(s_t, s_j, rtol=rtol, atol=atol)
    diff = p_t != p_j
    if diff.any():
        gap = np.abs(np.diff(s_j, axis=-1))
        near = np.zeros_like(diff)
        near[..., 1:] |= gap <= atol + rtol * np.abs(s_j[..., 1:])
        near[..., :-1] |= gap <= atol + rtol * np.abs(s_j[..., :-1])
        assert (~diff | near).all()


# ---------------------------------------------------------------------------
# Sparse (tests/test_torch_sparse_*.py)
# ---------------------------------------------------------------------------

SPARSE_RTOL = 1e-5  # scores: f32 sums of the same products in other orders
SPARSE_ATOL = 1e-6


def sparse_ds(pkg, rows, dim):
    """The same {dim: value} rows as a sparse DataSet of ``pkg``."""
    return pkg.GenSparseDataSet(list(rows), dim)


def sparse_index(pkg, name, rows, dim, cfg, data_type="sparse"):
    idx = pkg.IndexFactory.Instance().Create(name, data_type=data_type).value()
    assert idx.Build(sparse_ds(pkg, rows, dim), cfg) == pkg.Status.success
    return idx


def sparse_search(pkg, idx, rows, dim, cfg, bitset=None):
    """(ids, distances) of a sparse Search, each (nq, k)."""
    res = idx.Search(sparse_ds(pkg, rows, dim), cfg, bitset or pkg.BitsetView())
    assert res.has_value(), res.what()
    k = cfg["k"]
    return res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)


def assert_sparse_parity(ids_j, d_j, ids_t, d_t, rtol=SPARSE_RTOL, atol=SPARSE_ATOL):
    """Sparse top-k of the port against the JAX package: scores within
    rtol; ids equal except where the JAX scores tie within that tolerance
    (a neighbour in the row, or the row's last filled slot, whose tie may lie
    just past k)."""
    np.testing.assert_allclose(d_t, d_j, rtol=rtol, atol=atol)
    diff = ids_t != ids_j
    if not diff.any():
        return
    gap = np.abs(np.diff(d_j, axis=-1))
    near = np.zeros_like(diff)
    near[..., 1:] |= gap <= atol + rtol * np.abs(d_j[..., 1:])
    near[..., :-1] |= gap <= atol + rtol * np.abs(d_j[..., :-1])
    last = (ids_j >= 0).sum(axis=-1) - 1
    rows_ = np.arange(ids_j.shape[0])
    near[rows_[last >= 0], last[last >= 0]] = True
    assert (~diff | near).all(), np.argwhere(diff & ~near)[:5]
