"""The single-pass fused kNN scan: the port against the JAX package.

``knowhere_tpu_torch.ops.fused_topk`` on the CPU runs the plain PyTorch
version of the CUDA kernel; the JAX side is ``pallas_knn`` with
``interpret=True`` (as tests/test_pallas.py runs it). The corpus and queries
are snapped to a 1/8 grid in [-8, 8], so every value is bf16-exact and every
dot and norm is exact in f32: the port's bf16 pass and the interpret-mode
f32 dot give the same bits, and ids and distances must be identical (equal
scores included: both give the smaller id). The CUDA kernel is held against
the same plain version on the GPU by chip_smoke.py.

On the card the scan is three launches per block of queries (the
single-pass group max, FLAT's group select, the rescore of the winning
groups' rows); ``fused_topk.fused_knn_blocks`` runs the same steps on CPU
tensors through their plain versions (``cuda_flat.fused_group_scan_plain``,
``cuda_flat.fused_rescore_plain``), which the tests below hold to the JAX
kernel slot for slot: on the grid data, on a corpus of duplicated rows, at
several query blocks, and where slots are empty.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import knowhere_tpu_torch as ktt
from knowhere_tpu.ops.pallas_topk import fused_knn_scan as jfused_knn_scan
from knowhere_tpu.ops.pallas_topk import pallas_knn
from knowhere_tpu_torch.ops import cuda_flat, fused_topk

torch.set_num_threads(2)
ktt.set_device("cpu")


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xb = _grid(rng.standard_normal((4096 + 100, 64)))  # ragged against both packages' tiles
    xq = _grid(rng.standard_normal((10, 64)))
    return xb, xq


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("k", [10, 64])
def test_fused_knn_matches_pallas_knn(data, metric, k):
    xb, xq = data
    d_j, i_j = pallas_knn(xq, jax.device_put(xb), k, metric, tile=1024, interpret=True)
    d_t, i_t = fused_topk.fused_knn(xq, torch.from_numpy(xb), k, metric)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert i_t.dtype == np.int64


def test_k_larger_than_real_results(data):
    """k > nb: the empty slots are id -1 with distance inf, as in the reference."""
    xb, xq = data
    d_j, i_j = pallas_knn(xq[:2], jax.device_put(xb[:5]), 10, "L2", tile=1024, interpret=True)
    d_t, i_t = fused_topk.fused_knn(xq[:2], torch.from_numpy(xb[:5]), 10, "L2")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert (i_t[:, 5:] == -1).all() and np.isinf(d_t[:, 5:]).all()


@pytest.mark.parametrize("is_l2", [True, False])
def test_scan_matches_pallas_kernel(data, is_l2):
    """The kernel-level function on a padded corpus: (scores, ids) equal to
    the Pallas kernel's, pad rows (norm 1e38) never winning."""
    xb, xq = data
    nb_pad = -(-len(xb) // 1024) * 1024
    base = np.zeros((nb_pad, xb.shape[1]), np.float32)
    base[: len(xb)] = xb
    norms = np.full(nb_pad, 1e38, np.float32)
    norms[: len(xb)] = (xb.astype(np.float64) ** 2).sum(1) if is_l2 else 0.0
    q = np.concatenate([xq, np.zeros((6, xq.shape[1]), np.float32)])  # 16 rows
    s_j, i_j = jfused_knn_scan(jnp.asarray(q), jnp.asarray(base), jnp.asarray(norms), k=16, is_l2=is_l2,
                               tile=1024, interpret=True)
    s_t, i_t = fused_topk.fused_knn_scan(torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(norms),
                                         k=16, is_l2=is_l2)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_pad_base_rows_never_win(data):
    xb, xq = data
    b = torch.from_numpy(xb[:70])
    base, norms = fused_topk.pad_base(b, (b * b).sum(1))
    assert base.shape == (128, 128) and (norms[70:] == 1e38).all()
    q = torch.nn.functional.pad(torch.from_numpy(xq), (0, base.shape[1] - xq.shape[1]))
    _, ids = fused_topk.fused_knn_scan(q, base, norms, k=80, is_l2=True)
    assert ((ids[:, :70] >= 0) & (ids[:, :70] < 70)).all() and (ids[:, 70:] == -1).all()


def _padded(xb, xq, is_l2):
    """The corpus as fused_knn pads it, and the queries padded to its width."""
    b = torch.from_numpy(xb)
    base, norms = fused_topk.pad_base(b, (b * b).sum(1) if is_l2 else torch.zeros(len(xb)))
    q = torch.nn.functional.pad(torch.from_numpy(xq), (0, base.shape[1] - xb.shape[1]))
    return base, norms, q


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("k", [10, 64])
def test_group_scan_then_rescore_matches_pallas_knn(data, metric, k):
    """The card's three steps, as plain versions: the top kg groups of the
    single pass, then their rows rescored, equal pallas_knn and
    fused_knn_scan_plain (ids and distances identical)."""
    xb, xq = data
    is_l2 = metric == "L2"
    a = 2.0 if is_l2 else 1.0
    base, norms, q = _padded(xb, xq, is_l2)
    kg = min(k, base.shape[0] // cuda_flat.GROUP)
    _, gids = cuda_flat.fused_group_scan_plain(base, norms, q, kg, a)
    s, i = cuda_flat.fused_rescore_plain(q, base, norms, gids, k, a)
    s_p, i_p = fused_topk.fused_knn_scan_plain(q, base, norms, k=k, is_l2=is_l2)
    np.testing.assert_array_equal(i.numpy(), i_p.numpy())
    np.testing.assert_array_equal(s.numpy(), s_p.numpy())
    d_t, i_t = fused_topk.host_result(s, i, xq, len(xb), is_l2)
    d_j, i_j = pallas_knn(xq, jax.device_put(xb), k, metric, tile=1024, interpret=True)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("is_l2", [True, False])
def test_tie_corpus_matches_pallas_kernel(monkeypatch, is_l2):
    """24 distinct grid rows, each repeated 25 times across 16-row groups and
    128-row tiles, queries repeated across query blocks of 16, k=30 cutting
    through the second-best row's copies: (scores, ids) equal to the JAX
    kernel's slot for slot (the lower row id wins every tie)."""
    rng = np.random.default_rng(5)
    distinct = _grid(rng.standard_normal((24, 64)))
    xb = distinct[rng.permutation(600) % 24]
    xq = np.tile(_grid(rng.standard_normal((16, 64))), (3, 1))[:40]
    base, norms, q = _padded(xb, xq, is_l2)
    monkeypatch.setattr(cuda_flat, "NQ_BLOCK", 16)
    s_t, i_t = fused_topk.fused_knn_blocks(q, base, norms, k=30, is_l2=is_l2)
    s_j, i_j = jfused_knn_scan(jnp.asarray(q[:, :64].numpy()), jnp.asarray(base[:, :64].numpy()),
                               jnp.asarray(norms.numpy()), k=30, is_l2=is_l2, tile=128, interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (i_t.numpy()[16:32] == i_t.numpy()[:16]).all()


def test_query_blocks_give_the_same_bits(data, monkeypatch):
    """40 queries in blocks of 16 give the same bits as one block."""
    xb, xq = data
    q = np.concatenate([xq, xq[::-1], xq, xq[:10]])  # 40 rows
    base, norms, qt = _padded(xb, q, True)
    one = fused_topk.fused_knn_blocks(qt, base, norms, k=20, is_l2=True)
    monkeypatch.setattr(cuda_flat, "NQ_BLOCK", 16)
    blocks = fused_topk.fused_knn_blocks(qt, base, norms, k=20, is_l2=True)
    assert torch.equal(one[0], blocks[0]) and torch.equal(one[1], blocks[1])


def test_query_block_bounds_the_group_maxima(data, monkeypatch):
    """The query block shrinks with the corpus so that a block's (queries,
    nb/16) f32 group maxima stay under GMAX_BYTES, in whole 128-query tiles
    and at least one; 1,024 at the 1M-row table shape. A budget forced down
    to one tile gives the same bits as one block over 300 queries."""
    assert fused_topk.query_block(1_000_064) == 1024
    assert fused_topk.query_block(10_000_000) == 128
    for nb_pad in (1 << 20, 3_000_064, 1 << 22):
        block = fused_topk.query_block(nb_pad)
        assert block % 128 == 0 and block * (nb_pad // 16) * 4 <= fused_topk.GMAX_BYTES
    xb, xq = data
    q = np.tile(xq, (30, 1))  # 300 rows
    base, norms, qt = _padded(xb, q, False)
    one = fused_topk.fused_knn_blocks(qt, base, norms, k=10, is_l2=False)
    monkeypatch.setattr(fused_topk, "GMAX_BYTES", 128 * (base.shape[0] // 16) * 4)
    assert fused_topk.query_block(base.shape[0]) == 128
    blocks = fused_topk.fused_knn_blocks(qt, base, norms, k=10, is_l2=False)
    assert torch.equal(one[0], blocks[0]) and torch.equal(one[1], blocks[1])


def test_rescore_empty_groups_and_slots_match_jax(data):
    """20 real rows padded to 48 (the last group all padding, so its group
    id is -1) at k=50 > kg * 16 = 48: the real rows, then (-1e38, -1)
    exactly where the JAX kernel has them."""
    xb, xq = data
    base = np.zeros((48, 64), np.float32)
    base[:20] = xb[:20]
    norms = np.full(48, 1e38, np.float32)
    norms[:20] = (xb[:20].astype(np.float64) ** 2).sum(1)
    q, b, n = torch.from_numpy(xq[:8]), torch.from_numpy(base), torch.from_numpy(norms)
    _, gids = cuda_flat.fused_group_scan_plain(b, n, q, 3, 2.0)
    assert (gids[:, 2] == -1).all()
    s_t, i_t = cuda_flat.fused_rescore_plain(q, b, n, gids, 50, 2.0)
    s_j, i_j = jfused_knn_scan(jnp.asarray(xq[:8]), jnp.asarray(base), jnp.asarray(norms), k=50, is_l2=True,
                               tile=48, interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (i_t[:, 20:] == -1).all() and (s_t[:, 20:] == -1e38).all()


def test_query_operand_hi_is_the_bf16_queries():
    """The single pass's query image holds bf16(q) (round to nearest even)
    bit for bit, zero rows past nq, and equals the hi half of FLAT's
    hi/lo image."""
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((200, 256)).astype(np.float32))
    op = cuda_flat.query_operand_hi(q)
    assert op.shape == (2, 2, 16, 128, 8) and op.dtype == torch.bfloat16
    back = op.permute(0, 3, 1, 2, 4).reshape(256, 256)
    assert torch.equal(back[:200].view(torch.int16), q.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(back[:200].float(), cuda_flat.bf16_round(q)) and (back[200:] == 0).all()
    assert torch.equal(op.view(torch.int16), cuda_flat.query_operand(q)[:, :, :16].contiguous().view(torch.int16))
