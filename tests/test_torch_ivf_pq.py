"""IVF_PQ: the port against the JAX package, kernel by kernel and end to end.

The same numpy inputs go through the JAX functions and their counterparts in
the port (on the CPU, so the ADC wrapper runs its plain PyTorch version). The
Pallas ADC kernels run in interpret mode, as tests/test_adc_pallas.py and
tests/test_adc_mc.py run them, fed the transposed code layout they take; the
port gets its own row-major layout. End to end, the JAX package builds the
index and the port loads it through the KWTPU bytes (and the other way);
both search the same queries through the public API. The ensure_topk_full
repair is held for IVF_FLAT and IVF_PQ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import quant as jquant
from knowhere_tpu.ops.ivf_pallas import (
    LIST_ALIGN,
    adc_mc_geometry,
    adc_s_stack,
    pallas_adc_tasks,
    pallas_adc_tasks_mc,
)
from knowhere_tpu.ops.ivf_scan import compute_qlut as jcompute_qlut
from knowhere_tpu_torch.ops import adc_cuda, ivf_cuda
from knowhere_tpu_torch.ops import ivf_scan as tscan
from knowhere_tpu_torch.ops import quant as tquant

from .torch_parity import build, cross_load, interpret_env, ivf_corpus, recall, search, set_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, NQ, DIM, K, NLIST, NPROBE = 8192, 64, 128, 10, 16, 12
BUILD = {"metric_type": "L2", "nlist": NLIST, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"}
SEARCH = {"metric_type": "L2", "k": K, "nprobe": NPROBE, "refine_k": 8}
# ADC kernel tolerance: scores within 1e-3 relative + 1e-2 (a LUT entry may
# round to the neighbouring bf16 value where the f32 sums run in another
# order), positions equal on >= 99% of slots. Measured worst case over the
# cases below: max |score diff| 3.1e-05 (LUT entries agree exactly here),
# positions 100% equal.
ADC_RTOL, ADC_ATOL, ADC_POS_AGREE = 1e-3, 1e-2, 0.99
NEG_INF = np.float32(-1e38)  # the empty slot's score


@pytest.fixture(scope="module", autouse=True)
def _interpret_env():
    yield from interpret_env()


@pytest.fixture(scope="module")
def corpus():
    return ivf_corpus(NB, NQ, DIM, K)


def _residuals(xb, n=4096):
    """Residual-like training rows: the corpus minus its nearest of 16 rows."""
    x = xb[:n]
    c = xb[-16:]
    a = np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), 1)
    return np.ascontiguousarray(x - c[a], dtype=np.float32)


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


def test_pq_encode_identical_codes(corpus):
    x = _residuals(corpus[0])
    codec = jquant.pq_train(x, 16, 8, n_iters=4)
    codes_j = jquant.pq_encode(codec, x)
    codes_t = tquant.pq_encode(tquant.PQCodec(codec.codebooks, 16, 8), x)
    np.testing.assert_array_equal(codes_t, codes_j)


def test_pq_lloyd_step_matches_jax(corpus):
    x = _residuals(corpus[0])
    m, ksub, s = 16, 256, DIM // 16
    xs = np.ascontiguousarray(x.reshape(-1, m, s).transpose(1, 0, 2))
    c0 = xs[:, np.random.default_rng(3).choice(xs.shape[1], ksub, replace=False), :]
    kw = dict(ksub=ksub, n_iters=1, nc=2048)
    c_j = np.asarray(jquant._pq_lloyd_batched(jnp.asarray(xs), jnp.asarray(c0), **kw))
    c_t = tquant._pq_lloyd_batched(T(xs), T(c0), **kw).numpy()
    np.testing.assert_allclose(c_t, c_j, atol=1e-5)


def test_pq_lloyd_fixed_order(corpus):
    """PQ's Lloyd sums add each codeword's rows in row order
    (kmeans.cluster_sums over the m * ksub codewords): one step within 1e-5
    of the same step summed with index_add_, and two iterations give the
    same bits on a second call."""
    x = _residuals(corpus[0])
    m, ksub, s = 16, 256, DIM // 16
    xs = T(np.ascontiguousarray(x.reshape(-1, m, s).transpose(1, 0, 2)))
    c0 = xs[:, np.random.default_rng(3).choice(xs.shape[1], ksub, replace=False), :]
    got = tquant._pq_lloyd_batched(xs, c0, ksub=ksub, n_iters=1, nc=2048)
    # the same step with index_add_ sums
    a = torch.argmin((c0 * c0).sum(2)[:, None, :] - 2.0 * torch.bmm(xs, c0.transpose(1, 2)), 2)
    flat = (a + (torch.arange(m) * ksub)[:, None]).reshape(-1)
    sums = torch.zeros((m * ksub, s)).index_add_(0, flat, xs.reshape(-1, s)).view(m, ksub, s)
    counts = torch.bincount(flat, minlength=m * ksub).float().view(m, ksub)
    want = torch.where((counts == 0)[..., None], c0, sums / counts.clamp(min=1.0)[..., None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    runs = [tquant._pq_lloyd_batched(xs, c0, ksub=ksub, n_iters=2, nc=2048) for _ in range(2)]
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))


def test_opq_train_matches_jax(corpus):
    """Same seed, same numpy subsample and SVD, codebooks equal to ~1e-6 per
    PQ step; but the corpus has intrinsic dimension 32, so x^T dec is rank
    deficient (singular values 1e-6 .. 2.5e5) and its polar factor is free in
    the near-null space: the f32 sum order moves the rotation there (measured
    max |R_t - R_j| 0.30). The rotation is held by what it is for instead:
    orthogonal, and PQ reconstruction error within 1% of the JAX one
    (measured: 0.0006% apart)."""
    x = _residuals(corpus[0])
    R_j, pq_j = jquant.opq_train(x, 16, 6, n_iter=2)
    R_t, pq_t = tquant.opq_train(x, 16, 6, n_iter=2)
    np.testing.assert_allclose(R_t @ R_t.T, np.eye(DIM), atol=1e-4)

    def recon_err(R, codec):
        xr = x @ R.T
        return float(((xr - tquant.pq_decode(codec, tquant.pq_encode(codec, xr))) ** 2).sum())

    err_j = recon_err(R_j, tquant.PQCodec(pq_j.codebooks, 16, 6))
    err_t = recon_err(R_t, pq_t)
    assert abs(err_t - err_j) <= 0.01 * err_j


def test_compute_qlut_matches_jax():
    """The port's QLUT is the kernels' hi/lo bf16 product; the reference's is
    full f32: they agree to the hi/lo residual (~2^-16 relative)."""
    rng = np.random.default_rng(4)
    m, ksub, sub = 16, 256, 8
    books = T(rng.standard_normal((m, ksub, sub)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    q = rng.standard_normal((32, m * sub)).astype(np.float32)
    for is_l2 in (True, False):
        want = np.asarray(jcompute_qlut(jnp.asarray(q), jnp.asarray(books), is_l2=is_l2))
        got = adc_cuda.compute_qlut(T(q), T(books), is_l2=is_l2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the ADC kernel's plain version vs the Pallas ADC kernels
# ---------------------------------------------------------------------------


def _adc_inputs(rng, m, ksub, is_l2, nlist=4, d=DIM, Qg=16, nq=40):
    sub = d // m  # m * sub may fall short of d (the run-time width): columns past it are unused
    nb = nlist * LIST_ALIGN
    books = rng.standard_normal((m, ksub, sub)).astype(np.float32) * 0.3
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(nb, m)).astype(np.uint8)
    if is_l2:
        c3 = cents[:, : m * sub].reshape(nlist, m, sub).astype(np.float64)
        b64 = books.astype(np.float64)
        clut = (2.0 * np.einsum("lms,mvs->lmv", c3, b64) + np.sum(b64**2, -1)[None]).astype(np.float32)
    else:
        clut = np.zeros((nlist, m, ksub), np.float32)
    # two query groups per list block; ragged valid-row counts
    Tc = 2 * nlist
    blk = np.tile(np.arange(nlist, dtype=np.int32), 2)
    nrows = rng.integers(LIST_ALIGN // 2, LIST_ALIGN + 1, Tc).astype(np.int32)
    nrows[0] = LIST_ALIGN
    q = rng.standard_normal((nq, d)).astype(np.float32)
    qids = rng.integers(0, nq, (Tc, Qg))
    return books, cents, codes, clut.reshape(nlist, m * ksub), blk, nrows, q[qids]


def _books_bd(books, d=DIM):
    """The reference's (d, m * ksub) block-diagonal codebooks, zero rows past m * sub."""
    m, ksub, sub = books.shape
    bd = np.zeros((d, m * ksub), np.float32)
    for i in range(m):
        bd[i * sub : (i + 1) * sub, i * ksub : (i + 1) * ksub] = books[i].T
    return jnp.asarray(bd).astype(jnp.bfloat16)


def _stored_codes(codes, m, nib):
    """The port's row-major code layout (nibble-packed for nib)."""
    return T(np.ascontiguousarray(codes[:, : m // 2] | (codes[:, m // 2 :] << 4) if nib else codes))


def _port_adc(books, cents, codes, clut, blk, nrows, q_task, keep, *, kk, is_l2, nib):
    """The port's scan of the pre-gathered groups q_task: its rows as the
    batch's queries, each task naming its own, one table for all."""
    m = books.shape[0]
    Tc, Qg, d = q_task.shape
    q = T(np.ascontiguousarray(q_task.reshape(Tc * Qg, d)))
    qtab = adc_cuda.adc_qtable(q, T(books).to(torch.bfloat16), is_l2=is_l2)
    s, p = adc_cuda.adc_scan_tasks(
        T(blk), T(nrows), T(blk.copy()), torch.arange(Tc * Qg).reshape(Tc, Qg), q, qtab,
        T(clut).to(torch.bfloat16), T(cents), _stored_codes(codes, m, nib),
        None if keep is None else T(keep), m=m, B=LIST_ALIGN, kk=kk, is_l2=is_l2, nib=nib,
    )
    return s.numpy(), p.numpy()


def _assert_adc_agree(s_j, p_j, s_t, p_t):
    np.testing.assert_allclose(s_t, s_j, rtol=ADC_RTOL, atol=ADC_ATOL)
    assert (p_t == p_j).mean() >= ADC_POS_AGREE


def _jax_adc(books, cents, codes, clut, blk, nrows, q_task, keep, *, kk, is_l2, nib):
    """pallas_adc_tasks in interpret mode, fed the transposed code layout it
    takes (nibble-packed for nib)."""
    m, ksub, _ = books.shape
    nb = codes.shape[0]
    codes_t = np.zeros((32, nb), np.uint8)  # Mosaic's 32-row u8 tile
    if nib:
        half = m // 2
        codes_t[:half] = (codes[:, :half] | (codes[:, half:] << 4)).T
    else:
        codes_t[:m] = codes.T
    s_j, p_j = pallas_adc_tasks(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(blk), jnp.asarray(q_task), _books_bd(books),
        jnp.asarray(clut).astype(jnp.bfloat16), jnp.asarray(cents), jnp.asarray(codes_t),
        None if keep is None else jnp.asarray(keep.astype(np.int32).reshape(-1, 1, LIST_ALIGN)),
        B=LIST_ALIGN, Qg=q_task.shape[1], kk=kk, m=m, ksub=ksub, s_stack=adc_s_stack(m, ksub),
        is_l2=is_l2, nib=nib, interpret=True,
    )
    return np.asarray(s_j), np.asarray(p_j)


@pytest.mark.parametrize(
    "is_l2,masked,m,ksub,nib,kk",
    [
        (True, False, 16, 256, False, 10),
        (True, True, 16, 256, False, 32),
        (False, False, 16, 256, False, 32),
        (False, True, 16, 256, False, 10),
        # 4-bit nibble layout: byte j = subspace j (low) | j + m/2 (high)
        (True, True, 16, 16, True, 10),
        (False, False, 16, 16, True, 32),
        # the kernel's other compiled widths (sub 4 and 16) and its run-time
        # width (sub 6: m * sub = 120 of the 128 columns)
        (True, True, 32, 256, False, 16),
        (True, True, 8, 256, False, 16),
        (True, True, 20, 256, False, 16),
        (False, False, 20, 256, False, 32),
    ],
)
def test_adc_plain_matches_pallas_adc(is_l2, masked, m, ksub, nib, kk):
    rng = np.random.default_rng(11)
    books, cents, codes, clut, blk, nrows, q_task = _adc_inputs(rng, m, ksub, is_l2)
    keep = rng.random(codes.shape[0]) < 0.5 if masked else None
    s_j, p_j = _jax_adc(books, cents, codes, clut, blk, nrows, q_task, keep, kk=kk, is_l2=is_l2, nib=nib)
    s_t, p_t = _port_adc(books, cents, codes, clut, blk, nrows, q_task, keep, kk=kk, is_l2=is_l2, nib=nib)
    _assert_adc_agree(s_j, p_j, s_t, p_t)
    if keep is not None:
        assert not (~keep[p_t[p_t >= 0]]).any()


def _grid_adc_inputs(rng, m, ksub, is_l2):
    """ADC inputs on a power-of-two grid: queries in {-1/2, 0, 1/2},
    centroids in halves, codebooks in {-1/4, 0, 1/4} (4 in 5 of them 0),
    codes from 2 codewords a subspace. Every LUT entry is a multiple of 1/16
    below 9 in magnitude (exact in bf16), and every sum of them and every
    base is exact in f32, so the hi/lo split, the bf16 rounding and the sum
    order change nothing, and 40-60% of neighbouring top-kk slots tie: the
    result is fixed, ties included."""
    books, cents, codes, clut, blk, nrows, q_task = _adc_inputs(rng, m, ksub, is_l2)
    nlist, d = cents.shape
    sub = d // m
    books = (rng.integers(-1, 2, books.shape) * (rng.random(books.shape) < 0.2) * 0.25).astype(np.float32)
    cents = (rng.integers(-2, 3, cents.shape) * 0.5).astype(np.float32)
    codes = rng.integers(0, 2, codes.shape).astype(np.uint8)
    q_task = (rng.integers(-1, 2, q_task.shape) * 0.5).astype(np.float32)
    if is_l2:
        c3 = cents.reshape(nlist, m, sub).astype(np.float64)
        b64 = books.astype(np.float64)
        clut = (2.0 * np.einsum("lms,mvs->lmv", c3, b64) + np.sum(b64**2, -1)[None]).astype(np.float32)
        clut = clut.reshape(nlist, m * ksub)
    return books, cents, codes, clut, blk, nrows, q_task


@pytest.mark.parametrize("kk", [16, 32])
@pytest.mark.parametrize("is_l2", [True, False])
@pytest.mark.parametrize("m,ksub,nib", [(16, 256, False), (16, 16, True)])
@pytest.mark.parametrize("data", ["empty", "ties"])
def test_adc_plain_matches_pallas_adc_contract(data, m, ksub, nib, is_l2, kk):
    """The result contract on the inputs where a selection goes wrong first.
    empty: a quarter of the tasks have nrows = 0 and one task keeps fewer
    unmasked rows than kk; scores -1e38 and positions -1 exactly where the
    Pallas kernel has them. ties: the exact grid, where scores and positions
    equal the Pallas kernel's slot for slot (the leftmost of equal scores
    first)."""
    rng = np.random.default_rng(13)
    if data == "empty":
        books, cents, codes, clut, blk, nrows, q_task = _adc_inputs(rng, m, ksub, is_l2)
        nrows[::4] = 0
        nrows[1] = 2 * kk // 3  # about kk / 3 rows pass the mask
        keep = rng.random(codes.shape[0]) < 0.5
    else:
        books, cents, codes, clut, blk, nrows, q_task = _grid_adc_inputs(rng, m, ksub, is_l2)
        keep = rng.random(codes.shape[0]) < 0.5 if kk == 32 else None
    s_j, p_j = _jax_adc(books, cents, codes, clut, blk, nrows, q_task, keep, kk=kk, is_l2=is_l2, nib=nib)
    s_t, p_t = _port_adc(books, cents, codes, clut, blk, nrows, q_task, keep, kk=kk, is_l2=is_l2, nib=nib)
    empty = p_j == -1
    np.testing.assert_array_equal(p_t == -1, empty)
    assert (s_j[empty] == NEG_INF).all() and (s_t[empty] == NEG_INF).all()
    if data == "empty":
        assert empty[::4].all() and empty[1].any() and not empty[1, :, 0].any()
        _assert_adc_agree(s_j, p_j, s_t, p_t)
    else:
        # many neighbouring slots hold equal scores: the tie rule orders them
        assert (s_j[..., 1:] == s_j[..., :-1]).mean() > 0.35
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(p_t, p_j)


@pytest.mark.parametrize("is_l2,masked", [(True, False), (False, True)])
def test_adc_plain_matches_pallas_adc_mc(is_l2, masked):
    """The m-chunked Pallas kernel (m * ksub > 8192) against the same plain
    version: one port kernel serves both."""
    rng = np.random.default_rng(12)
    m, ksub, kk = 64, 256, 8
    m_c, MC = adc_mc_geometry(m, ksub, DIM)
    books, cents, codes, clut, blk, nrows, q_task = _adc_inputs(rng, m, ksub, is_l2, nlist=2, Qg=8)
    keep = rng.random(codes.shape[0]) < 0.5 if masked else None
    s_j, p_j = pallas_adc_tasks_mc(
        jnp.asarray(blk), jnp.asarray(nrows), jnp.asarray(blk), jnp.asarray(q_task), _books_bd(books),
        jnp.asarray(clut).astype(jnp.bfloat16), jnp.asarray(cents),
        jnp.asarray(np.ascontiguousarray(codes.T.astype(np.int32))),
        None if keep is None else jnp.asarray(keep.astype(np.int32).reshape(-1, 1, LIST_ALIGN)),
        B=LIST_ALIGN, Qg=q_task.shape[1], kk=kk, m_c=m_c, ksub=ksub, MC=MC, is_l2=is_l2, interpret=True,
    )
    s_t, p_t = _port_adc(books, cents, codes, clut, blk, nrows, q_task, keep, kk=kk, is_l2=is_l2, nib=False)
    _assert_adc_agree(np.asarray(s_j), np.asarray(p_j), s_t, p_t)


def _per_task_adc(blk, nrows, lids, q_task, books, clut, cents, codes, keep, *, kk, is_l2, nib):
    """The scan with each task's table built from its own query rows
    (compute_qlut a task), less its list's clut row, rounded to bf16."""
    m, ksub, _ = books.shape
    B, Tc, Qg = LIST_ALIGN, q_task.shape[0], q_task.shape[1]
    lut = adc_cuda.compute_qlut(q_task, books, is_l2=is_l2)
    if is_l2:
        lut = lut - clut[lids.long()].float()[:, None, :]
    lut = lut.to(torch.bfloat16).float()
    rows = blk.long()[:, None] * B + torch.arange(B)[None, :]
    idx = (adc_cuda.unpack_codes(codes[rows], m, nib) + torch.arange(m) * ksub).reshape(Tc, 1, B * m)
    acc = torch.gather(lut, 2, idx.expand(-1, Qg, -1)).view(Tc, Qg, B, m).sum(-1)
    c = cents[lids.long()]
    qc = (q_task * c[:, None, :]).sum(-1)
    base = 2.0 * qc - (c * c).sum(-1)[:, None] if is_l2 else qc
    return ivf_cuda._finish(base[..., None] + acc, blk, nrows, keep, B, kk)


@pytest.mark.parametrize(
    "m,ksub,d,nib,is_l2,masked",
    [
        (16, 256, 128, False, True, False),  # SIFT: sub 8
        (96, 256, 1024, False, True, False),  # GIST: sub 10
        (64, 16, 128, True, True, False),  # nibbles: sub 2
        (16, 256, 128, False, False, False),  # IP
        (16, 256, 128, False, True, True),  # keep-mask
    ],
)
def test_adc_search_table_matches_per_task_tables(m, ksub, d, nib, is_l2, masked):
    """One table a search (adc_qtable) read by query id gives the scores and
    positions of a table built a task from the task's gathered queries:
    every entry of P depends on its query alone. Queries repeat across and
    within tasks."""
    rng = np.random.default_rng(21)
    books, cents, codes, clut, blk, nrows, _ = _adc_inputs(rng, m, ksub, is_l2, d=d)
    nq, Tc, Qg, kk = 24, blk.shape[0], 16, 10
    q = T(rng.standard_normal((nq, d)).astype(np.float32))
    qids = torch.from_numpy(rng.integers(0, nq, (Tc, Qg)))
    keep = T(rng.random(codes.shape[0]) < 0.5) if masked else None
    books_t, clut_t, stored = T(books).to(torch.bfloat16), T(clut).to(torch.bfloat16), _stored_codes(codes, m, nib)
    s, p = adc_cuda.adc_scan_tasks(
        T(blk), T(nrows), T(blk.copy()), qids, q, adc_cuda.adc_qtable(q, books_t, is_l2=is_l2), clut_t, T(cents),
        stored, keep, m=m, B=LIST_ALIGN, kk=kk, is_l2=is_l2, nib=nib,
    )
    s_t, p_t = _per_task_adc(T(blk), T(nrows), T(blk.copy()), q[qids], books_t, clut_t, T(cents), stored, keep,
                             kk=kk, is_l2=is_l2, nib=nib)
    np.testing.assert_array_equal(s.numpy(), s_t.numpy())
    np.testing.assert_array_equal(p.numpy(), p_t.numpy())
    assert (p >= 0).all()


def test_adc_available_drops_the_lut_cap():
    """The port's ADC kernel takes m * ksub past the TPU's 8192 cap (GIST
    m=96), and declines unaligned stores, d % 128 != 0 and shapes whose
    block does not fit the shared memory. adc_smem_bytes is the kernel's
    figure: 8 warps' two buffers of a 512-entry chunk of their query pair's
    table rows (64 KB, the selection's scratch over them), then the code
    rows at an odd-word stride and the task's bf16 clut row. The queries do
    not sit in shared memory, so d does not bound it."""
    aligned = np.arange(0, 5 * LIST_ALIGN, LIST_ALIGN)
    store = {"books": torch.zeros((96, 256, 10), dtype=torch.bfloat16), "codes": torch.zeros((8, 96), dtype=torch.uint8)}
    assert tscan.adc_available(store, 1024, 10, aligned)
    assert not tscan.adc_available(store, 960, 10, aligned)
    assert not tscan.adc_available(store, 1024, 10, aligned + 1)
    assert tscan.adc_available(store, 2048, 10, aligned)
    assert tscan.adc_available(store, 3072, 10, aligned)  # 165,888 bytes at any d
    wide = {"books": torch.zeros((448, 256, 2), dtype=torch.bfloat16), "codes": torch.zeros((8, 448), dtype=torch.uint8)}
    assert not tscan.adc_available(wide, 1024, 10, aligned)  # 512 x 452 code bytes + a 224 KB clut row
    # SIFT: 16 code bytes a row at a 20-byte stride
    assert adc_cuda.adc_smem_bytes(16, 256, False) == 65536 + 512 * 20 + 16 * 256 * 2
    # GIST: 96 code bytes at 100, a 48 KB clut row
    assert adc_cuda.adc_smem_bytes(96, 256, False) == 65536 + 512 * 100 + 96 * 256 * 2
    # 4-bit nibbles: 32 code bytes at 36
    assert adc_cuda.adc_smem_bytes(64, 16, True) == 65536 + 512 * 36 + 64 * 16 * 2
    # a small table (m=8, ksub=16): the buffers alone hold the selection's 24 KB scratch
    assert adc_cuda.adc_smem_bytes(8, 16, False) == 65536 + 512 * 12 + 8 * 16 * 2


# ---------------------------------------------------------------------------
# end to end through the public API
# ---------------------------------------------------------------------------


def _assert_parity(ids_j, d_j, ids_t, d_t):
    same = ids_j == ids_t
    assert same.mean() >= 0.99
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-4)


@pytest.fixture(scope="module")
def jax_pq(corpus):
    return build(kt, "IVF_PQ", corpus[0], BUILD)


@pytest.fixture(scope="module")
def port_from_jax(jax_pq):
    return cross_load(jax_pq, ktt)


@pytest.fixture(scope="module")
def port_pq(corpus):
    return build(ktt, "IVF_PQ", corpus[0], BUILD)


@pytest.mark.parametrize("fast", [True, False])
def test_jax_built_index_cross_loads(corpus, jax_pq, port_from_jax, fast, monkeypatch):
    _, xq, gt = corpus
    hits = []
    orig = tscan._adc_search
    monkeypatch.setattr(tscan, "_adc_search", lambda *a, **kw: hits.append(1) or orig(*a, **kw))
    set_precision(fast)
    ids_j, d_j = search(jax_pq, kt, xq, SEARCH)
    ids_t, d_t = search(port_from_jax, ktt, xq, SEARCH)
    assert bool(hits) == fast, "FAST must take the ADC scan, EXACT the decode scan"
    _assert_parity(ids_j, d_j, ids_t, d_t)
    assert recall(ids_t, gt) >= 0.9


@pytest.mark.parametrize("fast", [True, False])
def test_nibble_codes_cross_load(corpus, fast):
    """nbits=4 (ksub=16): the port stores the 4-bit nibble layout."""
    xb, xq, _ = corpus
    jidx = build(kt, "IVF_PQ", xb, dict(BUILD, nbits=4))
    tidx = cross_load(jidx, ktt)
    assert tidx.node._store["codes"].shape[1] == 8
    set_precision(fast)
    _assert_parity(*search(jidx, kt, xq, SEARCH), *search(tidx, ktt, xq, SEARCH))


@pytest.mark.parametrize("refine_type", ["DATA_VIEW", "BF16", "SQ8"])
def test_refine_stores_cross_load(corpus, refine_type):
    """The raw f32, bf16 and SQ8 refine stores, built by JAX, re-score the
    same candidates in the port."""
    xb, xq, _ = corpus
    jidx = build(kt, "IVF_PQ", xb, dict(BUILD, refine_type=refine_type, opq=False))
    tidx = cross_load(jidx, ktt)
    assert tidx.node._refine_store.kind == ("sq8" if refine_type == "SQ8" else "raw")
    set_precision(True)
    _assert_parity(*search(jidx, kt, xq, SEARCH), *search(tidx, ktt, xq, SEARCH))


def test_port_build_recall_and_jax_loads_it(corpus, jax_pq, port_pq):
    xb, xq, gt = corpus
    set_precision(True)
    ids_t, d_t = search(port_pq, ktt, xq, SEARCH)
    ids_jb, _ = search(jax_pq, kt, xq, SEARCH)
    assert recall(ids_t, gt) >= recall(ids_jb, gt) - 0.02
    ids_j, d_j = search(cross_load(port_pq, kt), kt, xq, SEARCH)
    _assert_parity(ids_j, d_j, ids_t, d_t)


def test_serialize_round_trip_identical(corpus, port_pq):
    set_precision(True)
    xq = corpus[1]
    np.testing.assert_array_equal(search(cross_load(port_pq, ktt), ktt, xq, SEARCH)[0], search(port_pq, ktt, xq, SEARCH)[0])


def test_filtered_search_matches_jax(corpus, jax_pq, port_from_jax):
    _, xq, _ = corpus
    drop = np.random.default_rng(1).random(NB) < 0.5
    set_precision(True)
    ids_j, d_j = search(jax_pq, kt, xq, SEARCH, bitset=kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = search(port_from_jax, ktt, xq, SEARCH, bitset=ktt.BitsetView.from_bool_array(drop))
    assert (ids_t >= 0).all() and not drop[ids_t].any()
    _assert_parity(ids_j, d_j, ids_t, d_t)


@pytest.fixture(scope="module")
def jax_flat(corpus):
    return build(kt, "IVF_FLAT", corpus[0], {"metric_type": "L2", "nlist": NLIST})


@pytest.mark.parametrize("name", ["IVF_FLAT", "IVF_PQ"])
def test_ensure_topk_full_widens(corpus, jax_flat, jax_pq, name):
    """A 95% bitset at nprobe=1 leaves each probed list ~25 valid rows for
    k=40: the first pass comes back short, and the widening retry (nprobe x4
    per round, short queries only) fills every row with the JAX package's
    ids."""
    _, xq, _ = corpus
    jidx = jax_flat if name == "IVF_FLAT" else jax_pq
    tidx = cross_load(jidx, ktt)
    drop = np.random.default_rng(2).random(NB) < 0.95
    cfg = {"metric_type": "L2", "k": 40, "nprobe": 1, "refine_k": 2}
    set_precision(False)
    short, _ = search(tidx, ktt, xq, dict(cfg, ensure_topk_full=False), ktt.BitsetView.from_bool_array(drop))
    assert (short < 0).any()
    ids_j, d_j = search(jidx, kt, xq, cfg, kt.BitsetView.from_bool_array(drop))
    ids_t, d_t = search(tidx, ktt, xq, cfg, ktt.BitsetView.from_bool_array(drop))
    assert (ids_t >= 0).all() and not drop[ids_t].any()
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
