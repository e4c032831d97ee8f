"""The graph walks' membership kernel (csrc/graph_walk.cu) on a CUDA card.

Each test is marked ``card`` and skips without a CUDA device, deciding inside
the test. The file imports no JAX: the kernel is held bit for bit to its
plain PyTorch version (``graph.fresh_step_plain``), which
tests/test_torch_graph.py holds on the CPU to a per-row loop and, through
both walks, to the JAX package. On a machine with a card, from the root
of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=card" -q tests/test_torch_graph_walk_card.py
"""

import numpy as np
import pytest
import torch

from knowhere_tpu_torch.device import scoped_device
from knowhere_tpu_torch.ops import cuda_build
from knowhere_tpu_torch.ops import graph as G
from knowhere_tpu_torch.ops import graph_inline as GI

pytestmark = pytest.mark.card

W_GRID, DEG_GRID, EF_GRID, SEED_GRID = (1, 6, 8), (16, 32, 64), (16, 48, 512, 4096), (0, 8, 64)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ring_width(W, deg, n_seed):
    """The walk's visited width V = n_seed + ring_slots * G."""
    G = W * deg
    return n_seed + max(1, 256 // G) * G


def _step_inputs(rng, nq, W, deg, ef, n_seed, dev):
    """One step's operands as the walk gives them, ids drawn from a range
    about twice the ring and beam, so candidates repeat across parents and
    sit in the ring and the beam; a fifth of the parents masked to -1; the
    ring slot of a wrapped step."""
    G = W * deg
    ring_slots = max(1, 256 // G)
    V = _ring_width(W, deg, n_seed)
    hi = 2 * (V + ef)
    nbrs = rng.integers(0, hi, (nq, G)).astype(np.int32)
    nbrs.reshape(nq, W, deg)[rng.random((nq, W)) < 0.2] = -1
    visited = np.where(rng.random((nq, V)) < 0.25, -1, rng.integers(0, hi, (nq, V))).astype(np.int32)
    bids = np.where(rng.random((nq, ef)) < 0.1, -1, rng.integers(0, hi, (nq, ef))).astype(np.int32)
    scores = rng.standard_normal((nq, G)).astype(np.float32)
    off = n_seed + ((ring_slots + 1) % ring_slots) * G
    t = [torch.from_numpy(a).to(dev) for a in (nbrs, visited, bids, scores)]
    return (*t, off)


def _hold_one_launch(W, deg, ef, n_seed):
    """fresh, the written ring slot, the rest of the ring, the masked scores
    and new_p of one launch, bit for bit those of the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(W * 100_000 + deg * 1_000 + ef + n_seed)
    nbrs, visited, bids, scores, off = _step_inputs(rng, 300, W, deg, ef, n_seed, dev)
    Gw = W * deg
    vis_k, vis_p = visited.clone(), visited.clone()
    launches = G.fresh_step.launches
    fk, sk, pk = G.fresh_step(nbrs, vis_k, bids, scores.clone(), off, W > 1)
    fp, sp, pp = G.fresh_step_plain(nbrs, vis_p, bids, scores.clone(), off, W > 1)
    torch.cuda.synchronize()
    assert G.fresh_step.launches == launches + 1
    assert fk.dtype == torch.bool and torch.equal(fk, fp)
    assert torch.equal(vis_k[:, off : off + Gw], vis_p[:, off : off + Gw])
    assert torch.equal(vis_k, vis_p) and torch.equal(vis_k[:, :off], visited[:, :off])
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
    assert torch.equal(pk, pp)
    live = nbrs >= 0
    assert fp.any() and (live & ~fp).any()


@pytest.mark.parametrize("n_seed", SEED_GRID)
@pytest.mark.parametrize("ef", EF_GRID)
@pytest.mark.parametrize("deg", DEG_GRID)
@pytest.mark.parametrize("W", W_GRID)
def test_fresh_kernel_matches_plain(W, deg, ef, n_seed):
    """One launch at the inline walk's shapes (n_seed routed seeds)."""
    _hold_one_launch(W, deg, ef, n_seed)


@pytest.mark.parametrize("ef", (128, 1024))
@pytest.mark.parametrize("n_entry", (64, 1024))
@pytest.mark.parametrize("W", (1, 8))
def test_fresh_kernel_matches_plain_general_walk(W, n_entry, ef):
    """One launch at the general walk's shapes: an unrouted entry set of 64
    or 1,024 seeds in front of the ring (DISKANN's min(max(64, n / 500),
    1,024)), deg 64, W 1 and 8; the ring and beam take one staged chunk at
    64 seeds and ef 128, several otherwise."""
    _hold_one_launch(W, 64, ef, n_entry)


def test_fresh_grid_covers_chunked_staging():
    """Both grids above hold shapes whose ring and beam fit one staged chunk
    (the HNSW cell's 200 + 48) and shapes that take several."""
    _cuda()
    chunk = cuda_build.lib().kw_graph_fresh_chunk_ids()
    widths = [_ring_width(W, deg, s) + ef for W in W_GRID for deg in DEG_GRID for ef in EF_GRID for s in SEED_GRID]
    assert min(widths) <= chunk < max(widths)
    assert _ring_width(6, 32, 8) + 48 <= chunk
    general = [_ring_width(W, 64, e) + ef for W in (1, 8) for e in (64, 1024) for ef in (128, 1024)]
    assert min(general) <= chunk < max(general)


@pytest.mark.parametrize("masked", [False, True])
def test_walk_on_kernel_matches_plain_walk(masked, monkeypatch):
    """beam_search_inline at the HNSW cell's shape (10,240 rows, deg 32, W 6,
    ef 48, 8 seeds, 14 steps): the kernel's walk returns the plain walk's ids
    and scores bit for bit, and launches once a step run."""
    dev = _cuda()
    rng = np.random.default_rng(23)
    nb, d, deg, nq, ef, W = 200_000, 128, 32, 10_240, 48, 6
    x = torch.from_numpy(rng.standard_normal((nb, d), dtype=np.float32)).to(dev)
    graph = rng.integers(0, nb, (nb, deg)).astype(np.int32)
    graph[rng.random((nb, deg)) < 0.05] = -1
    with scoped_device(dev):
        store = GI.make_inline_store(graph, "raw", {"data": x}, bits=4)
    entry = torch.from_numpy(rng.choice(nb, 256, replace=False).astype(np.int32)).to(dev)
    keep = torch.from_numpy(rng.random(nb) < 0.5).to(dev) if masked else None
    q = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
    args = (store.table, q, store.rerank0, store.rerank1, store.rerank2, entry, x[entry.long()], store.vmin,
            store.vdiff, keep)
    kw = dict(W=W, ef=ef, deg=deg, n_steps=ef // W + 6, ring_slots=max(1, 256 // (W * deg)), n_seed=8, k=10,
              is_l2=True, has_mask=masked, rerank_kind="raw", bits=store.bits)

    steps = []
    plain = G.fresh_step_plain
    monkeypatch.setattr(GI, "fresh_step", lambda *a: (steps.append(1), plain(*a))[1])
    s_p, i_p = GI.beam_search_inline(*args, **kw)
    monkeypatch.undo()

    launches = G.fresh_step.launches
    s_k, i_k = GI.beam_search_inline(*args, **kw)
    torch.cuda.synchronize()
    assert steps and G.fresh_step.launches - launches == len(steps)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))


@pytest.mark.parametrize("kind", ["bf16", "pq"])
def test_general_walk_on_kernel_matches_plain_walk(kind, monkeypatch):
    """beam_search (the general walk) on the card over a bf16-held HNSW
    store (routed from 8 of 256 centroids, W 6) and a DISKANN-like
    kind="pq" store (1,024 unrouted entries, W 8, under a bitset): the
    kernel's walk returns the plain walk's ids and scores bit for bit, and
    launches once a step run."""
    dev = _cuda()
    rng = np.random.default_rng(26)
    nb, d, deg, nq = 100_000, 128, 32, 4_096
    x = torch.from_numpy(rng.standard_normal((nb, d), dtype=np.float32)).to(dev)
    graph = rng.integers(0, nb, (nb, deg)).astype(np.int32)
    graph[rng.random((nb, deg)) < 0.05] = -1
    graph = torch.from_numpy(graph).to(dev)
    q = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
    if kind == "bf16":
        entry = torch.from_numpy(rng.choice(nb, 256, replace=False).astype(np.int32)).to(dev)
        store, keep = {"data": x.to(torch.bfloat16)}, None
        kw = dict(kind="raw", ef=48, k=10, beam_width=6, max_iters=(2 * 48) // 6 + 32,
                  route_cents=x[entry.long()], n_seed=8)
    else:
        m, ksub = 16, 256
        entry = torch.from_numpy(rng.choice(nb, 1024, replace=False).astype(np.int32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, ksub, (nb, m)).astype(np.uint8)).to(dev)
        books = torch.from_numpy(rng.standard_normal((m, ksub, d // m), dtype=np.float32)).to(dev)
        store, keep = {"codes": codes, "codebooks": books}, torch.from_numpy(rng.random(nb) < 0.5).to(dev)
        kw = dict(kind="pq", ef=128, k=32, beam_width=8, max_iters=(2 * 128) // 8 + 32)
    kw.update(deg=deg, is_l2=True, has_mask=keep is not None)

    steps = []
    plain = G.fresh_step_plain
    monkeypatch.setattr(G, "fresh_step", lambda *a: (steps.append(1), plain(*a))[1])
    s_p, i_p = G.beam_search(q, store, graph, entry, keep, **kw)
    monkeypatch.undo()

    launches = G.fresh_step.launches
    s_k, i_k = G.beam_search(q, store, graph, entry, keep, **kw)
    torch.cuda.synchronize()
    assert steps and G.fresh_step.launches - launches == len(steps)
    assert (i_k >= 0).any()
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
