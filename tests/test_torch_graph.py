"""Graph build and walks: knowhere_tpu_torch/ops/graph.py and graph_inline.py
against the JAX package (knowhere_tpu/ops/graph.py, graph_inline.py), and
the walks' shared membership test (ops/graph.fresh_step).

The same seeded numpy inputs go through both. The corpus and queries are
snapped to a 1/8 grid in [-8, 8] (two rows pin every dimension's range to
[-8, 8]), so every product, norm and sum below is exact in f32 in both
packages, whatever the order of the sums: pruned ids, adjacency, inline
tables and walk results must then be identical. PQ and PRQ decodes are not
on the grid; their walks are held to an id agreement of 99%.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import knowhere_tpu_torch as ktt
from knowhere_tpu.ops import graph as jgraph
from knowhere_tpu.ops import graph_inline as jinline
from knowhere_tpu.ops import quant as jquant
from knowhere_tpu_torch.ops import graph as tgraph
from knowhere_tpu_torch.ops import graph_inline as tinline
from knowhere_tpu_torch.ops.distances import DistancePrecision, set_distance_precision

torch.set_num_threads(2)
ktt.set_device("cpu")

T = torch.from_numpy
NB, D, NQ, DEG = 2048, 64, 32, 16


def _grid(a):
    return np.clip(np.round(a * 8) / 8, -8, 8).astype(np.float32)


def grid_corpus(nb, d, nq, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((16, d)) * 2.0
    xb = _grid(cents[rng.integers(0, 16, nb)] + rng.standard_normal((nb, d)))
    xq = _grid(cents[rng.integers(0, 16, nq)] + rng.standard_normal((nq, d)))
    xb[0], xb[1] = -8.0, 8.0
    return xb, xq


@pytest.fixture(scope="module")
def corpus():
    return grid_corpus(NB, D, NQ)


@pytest.fixture(scope="module", params=["L2", "IP"])
def built(request, corpus):
    """The JAX package's graph and entries on the grid corpus, per metric."""
    xb, _ = corpus
    graph = jgraph.build_graph(xb, DEG, request.param, intermediate_deg=32)
    entry = jgraph.pick_entry_points(xb, n_entry=64)
    return request.param, graph, entry


def _cands(xb, K, is_l2):
    """Best-first exact candidate lists (self excluded)."""
    x = xb.astype(np.float64)
    dd = (x**2).sum(1)[:, None] - 2 * x @ x.T + (x**2).sum(1)[None] if is_l2 else -(x @ x.T)
    np.fill_diagonal(dd, np.inf)
    return np.argsort(dd, 1, kind="stable")[:, :K].astype(np.int32)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_l2,alpha", [(True, 1.0), (True, 1.2), (False, 1.0)])
def test_prune_chunk_identical(corpus, is_l2, alpha):
    xb, _ = corpus
    cand = _cands(xb, 32, is_l2)[256:768]
    cand[::7, -3:] = -1  # short candidate lists
    j = jgraph._prune_chunk(jnp.asarray(xb), jnp.asarray(cand), jnp.int32(256), deg=DEG, is_l2=is_l2, alpha=alpha)
    t = tgraph._prune_chunk(T(xb), T(cand), 256, deg=DEG, is_l2=is_l2, alpha=alpha)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("is_l2", [True, False])
def test_prune_candidates_ids_identical(corpus, is_l2):
    """Unsorted pools with repeats, -1 slots and the node itself."""
    xb, _ = corpus
    rng = np.random.default_rng(3)
    nodes = rng.choice(NB, 300, replace=False).astype(np.int32)
    pool = _cands(xb, 24, is_l2)[nodes]
    pool = np.concatenate([pool, pool[:, :6], rng.integers(0, NB, (300, 6)).astype(np.int32)], axis=1)
    pool = np.take_along_axis(pool, rng.permuted(np.tile(np.arange(36), (300, 1)), axis=1), axis=1)
    pool[::5, :4] = -1
    pool[::9, 5] = nodes[::9]
    j = jgraph.prune_candidates_ids(jnp.asarray(xb), jnp.asarray(pool), jnp.asarray(nodes), deg=DEG, is_l2=is_l2)
    t = tgraph.prune_candidates_ids(T(xb), T(pool), T(nodes), deg=DEG, is_l2=is_l2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_build_graph_identical(corpus, built):
    """Exact-kNN branch (nb <= KNN_EXACT_MAX_ROWS), prune, reverse edges and
    the numpy long edges: the same adjacency."""
    xb, _ = corpus
    metric, graph_j, entry_j = built
    graph_t = tgraph.build_graph(xb, DEG, metric, intermediate_deg=32)
    np.testing.assert_array_equal(graph_t, graph_j)
    np.testing.assert_array_equal(tgraph.pick_entry_points(xb, n_entry=64), entry_j)


@pytest.mark.parametrize("fast", [False, True])
def test_ivf_knn_branch_keeps_exact_lists(corpus, monkeypatch, fast):
    """The IVF branch of _approx_knn_graph (k-means + coarse probe + the raw
    scan over a LIST_ALIGN-padded store; FAST takes the f32 scan kernel's
    plain version), run at nb=4096 by lowering the threshold: >= 90% of the
    exact kNN lists are kept."""
    xb, _ = grid_corpus(4096, 128, 1, seed=5)
    monkeypatch.setattr(tgraph, "KNN_EXACT_MAX_ROWS", 1024)
    set_distance_precision(DistancePrecision.FAST if fast else DistancePrecision.EXACT)
    try:
        got = tgraph._approx_knn_graph(xb, 16, "L2")
    finally:
        set_distance_precision(DistancePrecision.EXACT)
    exact = _cands(xb, 16, True)
    kept = np.mean([len(set(got[i]) & set(exact[i])) / 16 for i in range(len(xb))])
    assert got.shape == (4096, 16) and not (got == np.arange(4096)[:, None]).any()
    assert kept >= 0.90, kept


# ---------------------------------------------------------------------------
# inline table
# ---------------------------------------------------------------------------


def _sq_store(xb):
    codec = jquant.sq_train(xb, "SQ8")
    return jquant.sq_encode(codec, xb), codec.vmin, codec.vdiff


@pytest.mark.parametrize("kind", ["raw", "sq"])
@pytest.mark.parametrize("bits", [4, 8])
def test_inline_table_bit_identical(corpus, built, kind, bits):
    xb, _ = corpus
    graph = built[1]
    if kind == "raw":
        js = jinline.make_inline_store(graph, "raw", {"data": jnp.asarray(xb)}, x_host=xb, bits=bits)
        ts = tinline.make_inline_store(graph, "raw", {"data": T(xb)}, x_host=xb, bits=bits)
    else:
        codes, vmin, vdiff = _sq_store(xb)
        js = jinline.make_inline_store(graph, "sq", {"codes": jnp.asarray(codes), "vmin": jnp.asarray(vmin),
                                                     "vdiff": jnp.asarray(vdiff)}, bits=bits)
        ts = tinline.make_inline_store(graph, "sq", {"codes": T(codes), "vmin": T(vmin), "vdiff": T(vdiff)}, bits=bits)
    assert ts.bits == js.bits == bits and ts.table.dtype == torch.int32
    assert ts.table.shape[1] == tinline.inline_row_words(DEG, D, bits)
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    np.testing.assert_array_equal(ts.vmin.numpy(), np.asarray(js.vmin))
    np.testing.assert_array_equal(ts.vdiff.numpy(), np.asarray(js.vdiff))


def test_sq4_pack_round_trip():
    codes = np.random.default_rng(4).integers(0, 16, (33, 64)).astype(np.int32)
    words = tinline.sq4_pack_words(T(codes))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jinline.sq4_pack_words(jnp.asarray(codes))))
    np.testing.assert_array_equal(tinline.sq4_unpack_planes(words).numpy(), codes)
    u8 = codes.astype(np.uint8) * 16 + 3
    np.testing.assert_array_equal(tinline.sq8_pack_words(T(u8)).numpy(),
                                  np.asarray(jinline.sq8_pack_words(jnp.asarray(u8))))


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------


def _stores(xb, kind):
    """(JAX store, port store) of one decode kind, codecs from the JAX package."""
    if kind == "raw":
        arrays = {"data": xb}
    elif kind in ("sq", "sq6", "sq4"):
        codec = jquant.sq_train(xb, {"sq": "SQ8", "sq6": "SQ6", "sq4": "SQ4"}[kind])
        arrays = {"codes": jquant.sq_encode(codec, xb), "vmin": codec.vmin, "vdiff": codec.vdiff}
    elif kind == "pq":
        pq = jquant.pq_train(xb, 16, 4)
        arrays = {"codes": jquant.pq_encode(pq, xb), "codebooks": pq.codebooks}
    else:  # prq: two residual PQ stages
        pq1 = jquant.pq_train(xb, 8, 4, seed=1000)
        c1 = jquant.pq_encode(pq1, xb)
        resid = xb - np.asarray(jquant.pq_decode_dev(jnp.asarray(pq1.codebooks), jnp.asarray(c1)))
        pq2 = jquant.pq_train(resid, 8, 4, seed=1001)
        arrays = {"codes": np.concatenate([c1, jquant.pq_encode(pq2, resid)], axis=1),
                  "codebooks": np.stack([pq1.codebooks, pq2.codebooks])}
    return {k: jnp.asarray(v) for k, v in arrays.items()}, {k: T(np.array(v)) for k, v in arrays.items()}


def _agree(a, b):
    return float(np.mean([len(set(a[i]) & set(b[i])) / a.shape[1] for i in range(len(a))]))


@pytest.mark.parametrize(
    "kind,W,masked,routed",
    [("raw", 1, False, False), ("raw", 4, False, True), ("raw", 1, True, True), ("raw", 4, True, False),
     ("raw", 4, True, True), ("sq", 2, False, True), ("sq6", 2, True, False), ("sq4", 2, False, True),
     ("pq", 2, False, True), ("prq", 2, True, True)],
)
def test_beam_search_matches_jax(corpus, built, kind, W, masked, routed):
    xb, xq = corpus
    metric, graph, entry = built
    is_l2 = metric == "L2"
    js, ts = _stores(xb, kind)
    keep = np.random.default_rng(6).random(NB) >= 0.3
    kw = dict(kind=kind, ef=48, k=10, deg=DEG, max_iters=60, is_l2=is_l2, has_mask=masked, beam_width=W,
              n_seed=8 if routed else 0)
    cents = xb[entry]  # routing "centroids": each entry's own row
    sj, ij = jgraph.beam_search(jnp.asarray(xq), js, jnp.asarray(graph), jnp.asarray(entry),
                                jnp.asarray(keep) if masked else None,
                                route_cents=jnp.asarray(cents) if routed else None, **kw)
    st, it = tgraph.beam_search(T(xq), ts, T(graph), T(entry), T(keep) if masked else None,
                                route_cents=T(cents) if routed else None, **kw)
    ij, it = np.asarray(ij), it.numpy()
    if masked:
        assert not (~keep[it[it >= 0]]).any()
    if kind in ("raw", "sq", "sq6", "sq4"):  # exact on the grid
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    else:
        assert _agree(it, ij) >= 0.99


@pytest.mark.parametrize(
    "kind,bits,W,masked", [("raw", 4, 1, False), ("raw", 4, 3, True), ("raw", 8, 3, False), ("sq", 4, 2, True),
                           ("sq", 8, 1, False), ("pq", 4, 3, False), ("prq", 8, 2, True)],
)
def test_beam_search_inline_matches_jax(corpus, built, kind, bits, W, masked):
    """The same JAX-built graph and inline store in both packages."""
    xb, xq = corpus
    metric, graph, entry = built
    is_l2 = metric == "L2"
    js, ts = _stores(xb, kind)
    jst = jinline.make_inline_store(graph, kind, js, x_host=xb if kind == "raw" else None, bits=bits)
    tst = tinline.make_inline_store(graph, kind, ts, x_host=xb if kind == "raw" else None, bits=bits)
    keep = np.random.default_rng(7).random(NB) >= 0.4
    cents = xb[entry]
    kw = dict(W=W, ef=48, deg=DEG, n_steps=48 // W + 6, ring_slots=max(1, 256 // (W * DEG)), n_seed=8, k=10,
              is_l2=is_l2, has_mask=masked, rerank_kind=kind, bits=bits)
    sj, ij = jinline.beam_search_inline(jst.table, jnp.asarray(xq), jst.rerank0, jst.rerank1, jst.rerank2,
                                        jnp.asarray(entry), jnp.asarray(cents), jst.vmin, jst.vdiff,
                                        jnp.asarray(keep) if masked else None, **kw)
    st, it = tinline.beam_search_inline(tst.table, T(xq), tst.rerank0, tst.rerank1, tst.rerank2, T(entry),
                                        T(cents), tst.vmin, tst.vdiff, T(keep) if masked else None, **kw)
    ij, it = np.asarray(ij), it.numpy()
    if masked:
        assert not (~keep[it[it >= 0]]).any()
    if kind in ("raw", "sq"):  # walk codes, queries and decodes exact on the grid
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    else:
        assert _agree(it, ij) >= 0.99


def _reverse_edges_numpy(graph):
    """The JAX package's reverse-edge backfill (knowhere_tpu/ops/graph.py,
    build_graph's add_reverse step), in numpy as it is there."""
    graph = graph.copy()
    nb, deg = graph.shape
    slots_used = (graph >= 0).sum(axis=1)
    src = np.repeat(np.arange(nb, dtype=np.int32), deg)
    dst = graph.reshape(-1)
    ok = (dst >= 0) & (src != dst)
    src, dst = src[ok], dst[ok]
    if dst.size:
        fwd_node = np.repeat(np.arange(nb, dtype=np.int64), deg)
        fwd_nbr = graph.reshape(-1).astype(np.int64)
        fwd_keys = fwd_node[fwd_nbr >= 0] * nb + fwd_nbr[fwd_nbr >= 0]
        rev_keys = dst.astype(np.int64) * nb + src.astype(np.int64)
        fresh = ~np.isin(rev_keys, fwd_keys, kind="sort")
        src, dst = src[fresh], dst[fresh]
    if dst.size:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        change = np.empty(dst.size, bool)
        change[0] = True
        change[1:] = dst[1:] != dst[:-1]
        grp_start = np.nonzero(change)[0]
        rank = np.arange(dst.size) - grp_start[np.cumsum(change) - 1]
        keep = rank < (deg - slots_used)[dst]
        graph[dst[keep], slots_used[dst[keep]] + rank[keep]] = src[keep]
    return graph


@pytest.mark.parametrize("seed", [0, 1])
def test_add_reverse_edges_matches_numpy(seed):
    """The device reverse-edge backfill against the JAX package's numpy
    steps, on compact rows (edges first, then -1) with self edges, repeated
    edges, rows full and rows empty."""
    rng = np.random.default_rng(seed)
    nb, deg = 3000, 12
    graph = rng.integers(0, 400, (nb, deg)).astype(np.int32)  # few targets: big groups
    fill = rng.integers(0, deg + 1, nb)
    graph[np.arange(deg)[None, :] >= fill[:, None]] = -1
    graph[:50, 0] = np.arange(50)  # self edges
    graph[100:110] = -1
    want = _reverse_edges_numpy(graph)
    got = tgraph.add_reverse_edges(graph, torch.device("cpu"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (want != graph).any()


def _fresh_loop(nbrs, visited, bids, scores, off, dedup):
    """The walk step's membership test, row by row and column by column."""
    nq, G = nbrs.shape
    fresh = np.zeros((nq, G), bool)
    vis, sc = visited.copy(), scores.copy()
    new_p = np.full((nq, G), -1, np.int32)
    for r in range(nq):
        ring, beam, earlier = set(visited[r].tolist()), set(bids[r].tolist()), set()
        for j in range(G):
            v = int(nbrs[r, j])
            before = v >= 0 and v not in ring and v not in beam
            fresh[r, j] = before and not (dedup and v in earlier)
            if before:
                earlier.add(v)
            vis[r, off + j] = v if fresh[r, j] else -1
            if fresh[r, j]:
                new_p[r, j] = v << 1
            else:
                sc[r, j] = -np.inf
    return fresh, vis, sc, new_p


@pytest.mark.parametrize(
    "case,W,deg,ef,n_seed,ring_slots,step",
    [("one_parent_repeats", 1, 8, 8, 4, 2, 0), ("several_parents", 3, 4, 6, 2, 2, 0),
     ("ring_wrapped", 2, 4, 8, 3, 3, 4), ("no_seeds", 4, 4, 16, 0, 1, 5)],
)
def test_fresh_step_plain_matches_loop(case, W, deg, ef, n_seed, ring_slots, step):
    """fresh_step on CPU tensors (the plain version) bit for bit against a
    per-row loop: ids from a small range, so one id arrives from several
    parents, sits in the ring or in the beam; whole parents masked to -1;
    the ring slot of a wrapped step; with W = 1 a repeated id of one
    adjacency row stays fresh twice."""
    rng = np.random.default_rng(len(case))
    nq, G = 64, W * deg
    V = n_seed + ring_slots * G
    nbrs = rng.integers(0, 3 * G, (nq, G)).astype(np.int32)
    nbrs.reshape(nq, W, deg)[rng.random((nq, W)) < 0.2] = -1
    nbrs[0, :2] = 7  # a repeat inside one row's first parent
    visited = np.where(rng.random((nq, V)) < 0.3, -1, rng.integers(0, 3 * G, (nq, V))).astype(np.int32)
    bids = np.where(rng.random((nq, ef)) < 0.2, -1, rng.integers(0, 3 * G, (nq, ef))).astype(np.int32)
    visited[0], bids[0] = -1, -1
    scores = rng.standard_normal((nq, G)).astype(np.float32)
    off = n_seed + (step % ring_slots) * G
    want = _fresh_loop(nbrs, visited, bids, scores, off, W > 1)
    vis_t = T(visited.copy())
    launches = tgraph.fresh_step.launches
    fresh, sc, new_p = tgraph.fresh_step(T(nbrs), vis_t, T(bids), T(scores.copy()), off, W > 1)
    assert tgraph.fresh_step.launches == launches  # CPU tensors: no kernel
    for got, exp in zip((fresh, vis_t, sc, new_p), want):
        np.testing.assert_array_equal(got.numpy(), exp)
    assert fresh.numpy()[0, :2].tolist() == [True, W == 1]
    dup = [(r, j) for r in range(nq) for j in range(G) if nbrs[r, j] >= 0 and nbrs[r, j] in nbrs[r, :j]]
    assert dup and all(not want[0][r, j] for r, j in dup) == (W > 1)
    assert (want[0] & (nbrs >= 0)).any() and ((nbrs >= 0) & ~want[0]).any()


def test_general_walk_takes_fresh_step(corpus, monkeypatch):
    """An HNSW Search on the general walk (a corpus under the inline walk's
    row floor) makes its membership test through ops/graph.fresh_step, at
    beam widths 1 and 6 and under a bitset, with the ids and scores of the
    same Search without the counting wrapper."""
    xb, xq = corpus
    idx = ktt.IndexFactory.Instance().Create("HNSW").value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), {"metric_type": "L2", "M": 8, "efConstruction": 64}).name == "success"
    assert idx.node._inline is None  # the general walk
    keep = np.random.default_rng(8).random(NB) >= 0.3
    bits = ktt.BitsetView(np.packbits(~keep, bitorder="little"), NB, int((~keep).sum()))

    def search():
        out = []
        for ef, bs in ((10, None), (48, None), (48, bits)):
            args = (ktt.GenDataSetFromArray(xq), {"k": 10, "ef": ef}) + ((bs,) if bs is not None else ())
            res = idx.Search(*args).value()
            out.append((np.array(res.ids), np.array(res.distance)))
        return out

    want = search()
    real, widths = tgraph.fresh_step, []

    def counted(nbrs, visited, bids, scores, off, dedup):
        widths.append(nbrs.shape[1] // idx.node._graph.shape[1])
        return real(nbrs, visited, bids, scores, off, dedup)

    monkeypatch.setattr(tgraph, "fresh_step", counted)
    got = search()
    assert {1, 6} <= set(widths)
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    masked_ids = want[2][0]
    assert keep[masked_ids[masked_ids >= 0]].all()
