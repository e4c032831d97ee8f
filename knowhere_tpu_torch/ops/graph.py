"""Graph ANN engine in PyTorch: kNN-graph construction and batched beam search
(counterpart of knowhere_tpu/ops/graph.py).

BUILD is batched, not a sequential per-insert HNSW build. A high-degree
approximate kNN graph comes from the batched kNN engines (every row is a
query): the exact tiled scan (ops/topk.py) up to KNN_EXACT_MAX_ROWS rows,
above that k-means + coarse probe + the IVF raw scan (ops/ivf_scan.py, the
f32 scan kernel under FAST) over a LIST_ALIGN-padded store. Each node's list
is then pruned with the HNSW / Vamana diversification rule
(select_neighbors_heuristic / RobustPrune with alpha), vectorized over node
chunks; the keep loop over candidate ranks is a Python loop of tensor ops.
Reverse edges backfill spare slots (on the device: a set membership and a
stable sort, the reference's numpy steps), and a few random long edges
(numpy ``default_rng(97)``) keep multi-modal corpora connected.

Binary corpora arrive as {0,1} f32 rows under HAMMING or JACCARD. The exact
scan ranks them under that metric; the IVF route ranks every metric but L2
by IP (``is_l2 = metric == "L2"``) and the prune takes the L2 rule for every
metric but IP, as the reference does.

SEARCH is a batched best-first beam search: per query a beam of ef
candidates; each step expands the W best unexpanded nodes, gathers their
neighbors, scores them (L2, IP, or Jaccard over {0,1} rows), drops those
already in the visited ring or the beam (and, for W > 1, repeats within the
step) and merges the rest into the beam with one stable sort on
(-score, payload). That membership test is ``fresh_step``, shared with the
inline walk (ops/graph_inline.py): the CUDA kernel csrc/graph_walk.cu for
CUDA tensors, ``fresh_step_plain`` for CPU tensors. Filtered-out nodes are
walked but never surface (a second, masked result set). The reference's
``lax.while_loop`` stops once every query's beam holds no unexpanded node;
here the loop tests that every 8 steps (one device sync each): a finished
query's further steps leave its beam and result set unchanged, so the
results are the same.

Every product is full f32 (TF32 is off, ``device.py``); ties follow the
reference: ``topk_leftmost`` for ``lax.top_k``, ``torch.argmax`` (first
maximum) for ``jnp.argmax`` and stable sorts for ``lax.sort``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..utils import tracing
from . import cuda_build
from . import distances as D
from . import topk as T
from .topk import topk_leftmost

NEG_INF = -float("inf")
KNN_EXACT_MAX_ROWS = 65536  # above this the kNN graph comes from the IVF scan
DONE_CHECK_STEPS = 8  # the walks test "every query finished" this often
_INT32_MAX = np.iinfo(np.int32).max


def phase_timer(tag: str):
    """``mark(phase)`` prints the seconds since the last mark when
    KNOWHERE_BUILD_TIMING=1 (after a device sync); a no-op otherwise."""
    if os.environ.get("KNOWHERE_BUILD_TIMING") != "1":
        return lambda phase: None
    t0 = [time.perf_counter()]

    def mark(phase: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[{tag}] {phase}: {now - t0[0]:.3f}s", flush=True)
        t0[0] = now

    return mark


def sort_desc(scores: torch.Tensor, payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.sort((-scores, payload), num_keys=1)`` along dim 1, negated back:
    larger scores first, equal scores in their original order."""
    ns, order = torch.sort(-scores, dim=1, stable=True)
    return -ns, torch.gather(payload, 1, order)


def fresh_step_plain(nbrs, visited, bids, scores, off: int, dedup: bool):
    """Plain PyTorch version of ``fresh_step``: the broadcast compares of the
    torch walk. Returns (fresh, scores masked to -inf where not fresh,
    new_p); writes the ring slot ``visited[:, off:off + G]``."""
    G = nbrs.shape[1]
    seen = (nbrs[:, :, None] == visited[:, None, :]).any(dim=2)
    in_beam = (nbrs[:, :, None] == bids[:, None, :]).any(dim=2)
    fresh = (nbrs >= 0) & ~seen & ~in_beam
    if dedup:  # one node may arrive from several parents in a step
        tri = torch.tril(torch.ones((G, G), dtype=torch.bool, device=nbrs.device), -1)
        fresh &= ~((nbrs[:, :, None] == nbrs[:, None, :]) & (fresh[:, None, :] & tri[None])).any(dim=2)
    visited[:, off : off + G] = torch.where(fresh, nbrs, torch.full_like(nbrs, -1))
    scores = torch.where(fresh, scores, torch.full_like(scores, NEG_INF))
    new_p = torch.where(fresh, nbrs << 1, torch.full_like(nbrs, -1))
    return fresh, scores, new_p


def fresh_step(
    nbrs: torch.Tensor,  # (nq, G) int32 candidate ids, -1 where masked
    visited: torch.Tensor,  # (nq, V) int32 visited ids; slot [off, off + G) is written
    bids: torch.Tensor,  # (nq, ef) int32 beam ids
    scores: torch.Tensor,  # (nq, G) f32 candidate scores
    off: int,
    dedup: bool,  # beam width > 1: keep the first column of a repeated fresh id
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One walk step's membership test, in both walks (``beam_search`` and
    graph_inline's ``beam_search_inline``): (fresh (nq, G) bool, scores with
    -inf where not fresh, new beam words nbrs << 1 or -1), the ring slot
    written with the fresh ids (-1 elsewhere). For CUDA tensors the kernel
    (csrc/graph_walk.cu) masks ``scores`` in place and counts the launch;
    for CPU tensors ``fresh_step_plain`` runs."""
    if not nbrs.is_cuda:
        return fresh_step_plain(nbrs, visited, bids, scores, off, dedup)
    nq, G = nbrs.shape
    V, E = visited.shape[1], bids.shape[1]
    if any(t.dtype != torch.int32 for t in (nbrs, visited, bids)) or scores.dtype != torch.float32:
        raise TypeError("fresh_step takes int32 ids and f32 scores")
    if visited.shape[0] != nq or bids.shape[0] != nq or scores.shape != (nq, G) or not 0 <= off <= V - G:
        raise ValueError(f"fresh_step: nbrs {tuple(nbrs.shape)}, visited {tuple(visited.shape)}, "
                         f"bids {tuple(bids.shape)}, scores {tuple(scores.shape)}, off {off}")
    if any(t.device != nbrs.device or not t.is_contiguous() for t in (nbrs, visited, bids, scores)):
        raise ValueError("fresh_step takes contiguous tensors on one CUDA device")
    fresh = torch.empty((nq, G), dtype=torch.bool, device=nbrs.device)
    new_p = torch.empty_like(nbrs)
    p = cuda_build.ptr
    code = cuda_build.lib().kw_graph_fresh(
        p(nbrs), p(visited), p(bids), p(scores), p(fresh), p(new_p), nq, G, V, E, off, int(dedup),
        cuda_build.stream_of(nbrs),
    )
    cuda_build.check(code, "graph_fresh")
    fresh_step.launches += 1
    return fresh, scores, new_p


fresh_step.launches = 0


# ---------------------------------------------------------------------------
# Build: batched kNN graph + heuristic prune
# ---------------------------------------------------------------------------


def _approx_knn_graph(
    x: np.ndarray,
    k: int,
    metric: str,
    centroids: Optional[np.ndarray] = None,
    assign: Optional[np.ndarray] = None,
    x_dev: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """(nb, k) int32 neighbor ids (self excluded, -1 padded) via the exact
    scan or the IVF scan."""
    from .ivf_cuda import LIST_ALIGN
    from .ivf_scan import coarse_probe, ivf_scan_search
    from .kmeans import assign_rows, kmeans

    nb, d = x.shape
    metric = metric.upper()
    if nb <= KNN_EXACT_MAX_ROWS:
        base_dev = x_dev if x_dev is not None else to_device(np.asarray(x, np.float32))
        ids, _ = T.knn_search(x, base_dev, k + 1, metric, aux=D.base_aux(metric, base_dev), query_chunk=4096)
    else:
        # IVF-accelerated all-pairs kNN: cluster, then probe a few lists of a
        # store whose lists are padded to LIST_ALIGN rows (the scan kernels'
        # block); pow2 nlist as in the reference
        nlist = 1 << int(round(np.log2(max(64, int(np.sqrt(nb))))))
        if centroids is None or centroids.shape[0] != nlist:
            centroids, assign = kmeans(x, nlist, n_iters=8)
        elif assign is None:
            assign = assign_rows(x, centroids)
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=nlist).astype(np.int64)
        align = LIST_ALIGN if d % 128 == 0 else 0
        pad_counts = (counts + align - 1) // align * align if align else counts
        offsets = np.zeros(nlist + 1, np.int64)
        np.cumsum(pad_counts, out=offsets[1:])
        nb_pad = int(offsets[-1])
        true_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        dst = np.arange(nb, dtype=np.int64) + np.repeat(offsets[:-1] - true_starts, counts)
        row_ids = np.full(nb_pad, -1, dtype=np.int64)
        row_ids[dst] = order
        if x_dev is None:
            x_dev = to_device(np.asarray(x, np.float32))
        # the sorted store is made on the device from the resident corpus,
        # with 2048 zero rows of slack after it
        dst_dev, order_dev = to_device(dst), to_device(order)
        data = torch.zeros((nb_pad + 2048, d), dtype=torch.float32, device=x_dev.device)
        data[dst_dev] = x_dev[order_dev].float()
        norms = (data.double() ** 2).sum(1).float()
        store = {
            "data": data,
            "norms": norms,
            "centroids": to_device(np.asarray(centroids, np.float32)),
            "offsets_dev": to_device(offsets.astype(np.int32)),
            "lens_dev": to_device(counts.astype(np.int32)),
        }
        del dst_dev, order_dev
        is_l2 = metric == "L2"
        row_ids_dev = to_device(row_ids)
        parts = []
        # query chunks slice the resident corpus; probes and tasks stay on
        # the device, one host copy at the end
        chunk = 32768
        for s in range(0, nb, chunk):
            q_dev = x_dev[s : s + chunk].float()
            probes = coarse_probe(q_dev, store["centroids"], nprobe=12, is_l2=is_l2)
            _, pos = ivf_scan_search(q_dev, store, probes, offsets, k + 1, is_l2, list_lengths=counts)
            pos = pos.long()
            parts.append(torch.where(pos >= 0, row_ids_dev[pos.clamp(0, nb_pad - 1)], torch.full_like(pos, -1)))
        ids = torch.cat(parts).cpu().numpy()
        del store, data, norms
    # drop self edges (stable-sort self hits to the end, cut to k)
    ids = np.asarray(ids, dtype=np.int64)
    is_self = ids == np.arange(nb, dtype=np.int64)[:, None]
    order = np.argsort(is_self, axis=1, kind="stable")
    cleaned = np.take_along_axis(ids, order, axis=1)
    cleaned = np.where(np.take_along_axis(is_self, order, axis=1), -1, cleaned)
    return cleaned[:, :k].astype(np.int32)


def _keep_loop(pair: torch.Tensor, d_node: torch.Tensor, valid: torch.Tensor, deg: int, alpha: float):
    """The greedy keep rule over candidate ranks: keep j iff no kept s has
    alpha * pair[j, s] < d_node[j], j is valid and fewer than deg are kept.
    Returns the (C, K) kept mask."""
    C, K = d_node.shape
    kept = torch.zeros((C, K), dtype=torch.bool, device=d_node.device)
    for j in range(K):
        conflict = kept & (alpha * pair[:, j, :] < d_node[:, j][:, None])
        ok = ~conflict.any(dim=1) & valid[:, j]
        ok &= kept.sum(dim=1) < deg
        kept[:, j] = ok
    return kept


def _compact_kept(cand_ids: torch.Tensor, kept: torch.Tensor, deg: int) -> torch.Tensor:
    """Kept ids in rank order, -1 padded to (C, deg)."""
    K = cand_ids.shape[1]
    key = torch.where(kept, torch.arange(K, device=kept.device)[None, :], torch.full_like(kept, K + 1, dtype=torch.long))
    order = torch.sort(key, dim=1, stable=True).indices[:, :deg]
    sel_ids = torch.gather(cand_ids, 1, order)
    sel_valid = torch.gather(kept, 1, order)
    return torch.where(sel_valid, sel_ids, torch.full_like(sel_ids, -1))


def _pairs(vecs: torch.Tensor, is_l2: bool) -> torch.Tensor:
    """(C, K, K) candidate-candidate distances (L2, clamped at 0) or negated
    similarities."""
    dots = torch.bmm(vecs, vecs.transpose(1, 2))
    if is_l2:
        nrm = (vecs * vecs).sum(-1)
        return torch.clamp(nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots, min=0.0)
    return -dots


def _node_dists(x_nodes: torch.Tensor, vecs: torch.Tensor, is_l2: bool) -> torch.Tensor:
    """(C, K) node-candidate distances (L2, clamped at 0) or negated
    similarities."""
    nd = torch.bmm(vecs, x_nodes[:, :, None])[:, :, 0]
    if is_l2:
        return torch.clamp((x_nodes * x_nodes).sum(-1)[:, None] + (vecs * vecs).sum(-1) - 2.0 * nd, min=0.0)
    return -nd


def _prune_chunk(
    x_all: torch.Tensor,  # (nb, d) device-resident base
    cand_ids: torch.Tensor,  # (C, K) int32, sorted best-first
    start: int,  # first node of the chunk
    *,
    deg: int,
    is_l2: bool,
    alpha: float = 1.0,
) -> torch.Tensor:
    """HNSW select_neighbors_heuristic / Vamana RobustPrune(alpha) over a
    chunk of consecutive nodes; candidates must be sorted best-first.
    Returns (C, deg) int32 kept ids, -1 padded."""
    C = cand_ids.shape[0]
    x_nodes = x_all[start : start + C].float()
    vecs = x_all[cand_ids.clamp(min=0).long()].float()  # (C, K, d)
    kept = _keep_loop(_pairs(vecs, is_l2), _node_dists(x_nodes, vecs, is_l2), cand_ids >= 0, deg, alpha)
    return _compact_kept(cand_ids, kept, deg)


def prune_candidates_ids(
    x_all: torch.Tensor,  # (nb, d) device-resident base (old + new rows)
    cand_ids: torch.Tensor,  # (C, K) candidate pool, -1 padded, may hold dups
    node_ids: torch.Tensor,  # (C,) the nodes being (re)pruned
    *,
    deg: int,
    is_l2: bool,
    alpha: float = 1.0,
) -> torch.Tensor:
    """``_prune_chunk`` for a non-contiguous node set with an unsorted pool
    (the incremental insert: new nodes' neighbor selection and the re-prune of
    touched old nodes). Candidates are distance-sorted and deduped here (a
    candidate keeps its best-ranked occurrence)."""
    C, K = cand_ids.shape
    x_nodes = x_all[node_ids.clamp(min=0).long()].float()
    vecs = x_all[cand_ids.clamp(min=0).long()].float()
    d_node = _node_dists(x_nodes, vecs, is_l2)
    valid = (cand_ids >= 0) & (cand_ids != node_ids[:, None])
    key = torch.where(valid, d_node, torch.full_like(d_node, 3.0e38))
    dn, order = torch.sort(key, dim=1, stable=True)
    cid = torch.gather(cand_ids, 1, order)
    cvecs = torch.gather(vecs, 1, order[:, :, None].expand_as(vecs))
    vv = torch.gather(valid, 1, order)
    ar = torch.arange(K, device=cand_ids.device)
    tri = ar[None, :, None] > ar[None, None, :]
    vv &= ~((cid[:, :, None] == cid[:, None, :]) & tri).any(dim=2)
    kept = _keep_loop(_pairs(cvecs, is_l2), dn, vv, deg, alpha)
    return _compact_kept(cid, kept, deg)


def build_graph(
    x: np.ndarray,
    deg: int,
    metric: str,
    intermediate_deg: Optional[int] = None,
    add_reverse: bool = True,
    alpha: float = 1.0,
    n_long_edges: int = 2,
    centroids: Optional[np.ndarray] = None,
    assign: Optional[np.ndarray] = None,
    x_dev: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """(nb, deg) int32 adjacency, -1 padded. The last ``n_long_edges`` slots
    of every node hold random long-range edges (NSW-style shortcuts that the
    HNSW hierarchy gives implicitly)."""
    mark = phase_timer("build_graph")
    nb, d = x.shape
    inter = intermediate_deg or min(max(2 * deg, 32), max(nb - 1, 1))
    inter = min(inter, nb - 1)
    if x_dev is None:  # resident once; every build phase slices / gathers it
        x_dev = to_device(np.asarray(x, np.float32))
    knn = _approx_knn_graph(x, inter, metric, centroids=centroids, assign=assign, x_dev=x_dev)
    mark("approx-knn")
    is_l2 = metric.upper() != "IP"  # cosine rows come normalized; the L2 rule holds

    graph = np.full((nb, deg), -1, dtype=np.int32)
    # chunk sized by the prune's (chunk, K, K) pair matrix + (chunk, K, d)
    # gathers (~256 MB), the reference's rule
    K_c = knn.shape[1]
    chunk = min(nb, max(1024, int((256 << 20) // max(K_c * (K_c + d) * 4, 1)) // 512 * 512))
    knn_dev = to_device(np.ascontiguousarray(knn))
    starts = list(range(0, max(nb - chunk, 0) + 1, chunk))
    if starts[-1] + chunk < nb:
        starts.append(nb - chunk)  # overlapping tail, as in the reference
    outs = [_prune_chunk(x_dev, knn_dev[s : s + chunk], s, deg=deg, is_l2=is_l2, alpha=alpha) for s in starts]
    for s, out in zip(starts, torch.stack(outs).cpu().numpy()):
        graph[s : s + chunk] = out
    del knn_dev, outs
    mark("prune")

    if add_reverse:
        graph = add_reverse_edges(graph, x_dev.device)
    mark("reverse-edges")

    if n_long_edges > 0 and nb > deg * 4:
        # small-world shortcuts overwrite the last n_long_edges slots
        rng = np.random.default_rng(97)
        for j in range(1, min(n_long_edges, deg) + 1):
            targets = rng.integers(0, nb, nb).astype(np.int32)
            targets = np.where(targets == np.arange(nb, dtype=np.int32), (targets + 1) % nb, targets)
            graph[:, deg - j] = targets
    mark("long-edges")
    return graph


def add_reverse_edges(graph: np.ndarray, device) -> np.ndarray:
    """Backfill each node's spare slots with reverse edges: every (src ->
    dst) edge whose reverse dst -> src is not already a forward edge of dst,
    grouped by dst in src order (a stable sort), the first ``free`` of each
    group kept. On ``device``: a set membership (torch.isin) and a stable
    sort over nb * deg edges, the reference's numpy steps one for one, so
    the graph is the same bit for bit. ``graph`` rows hold their edges
    first, then -1."""
    nb, deg = graph.shape
    g = torch.from_numpy(np.ascontiguousarray(graph)).to(device, copy=True)
    slots_used = (g >= 0).sum(dim=1)
    node = torch.arange(nb, device=device, dtype=torch.int64).repeat_interleave(deg)
    nbr = g.reshape(-1).long()
    ok = (nbr >= 0) & (node != nbr)
    src, dst = node[ok], nbr[ok]
    if dst.numel():
        # drop reverse edges that already exist as forward edges of dst
        fwd = nbr >= 0
        fresh = ~torch.isin(dst * nb + src, node[fwd] * nb + nbr[fwd])
        src, dst = src[fresh], dst[fresh]
    del node, nbr
    if dst.numel():
        dst, order = torch.sort(dst, stable=True)
        src = src[order]
        change = torch.ones_like(dst, dtype=torch.bool)
        change[1:] = dst[1:] != dst[:-1]
        grp_start = torch.nonzero(change).squeeze(1)
        rank = torch.arange(dst.numel(), device=device) - grp_start[torch.cumsum(change.long(), 0) - 1]
        keep = rank < (deg - slots_used)[dst]
        d2 = dst[keep]
        g[d2, slots_used[d2] + rank[keep]] = src[keep].int()
    return g.cpu().numpy()


def pick_entry_points(
    x: np.ndarray,
    n_entry: int = 64,
    seed: int = 7,
    centroids: Optional[np.ndarray] = None,
    base_dev: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Entry points (the replacement of the HNSW top-level descent): random
    rows for corpora up to 100,000 rows, else the nearest row of each k-means
    centroid."""
    nb = x.shape[0]
    n_entry = min(n_entry, nb)
    if nb <= 100_000:
        rng = np.random.default_rng(seed)
        return np.unique(rng.choice(nb, size=n_entry, replace=nb < n_entry)).astype(np.int32)
    from .kmeans import kmeans

    if centroids is None:
        centroids, _ = kmeans(x, n_entry, n_iters=6, seed=seed)
    if base_dev is None:
        base_dev = to_device(np.asarray(x, np.float32))
    ids, _ = T.knn_search(centroids, base_dev, 1, "L2", aux=D.base_aux("L2", base_dev))
    return np.unique(ids.reshape(-1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Search: batched best-first beam
# ---------------------------------------------------------------------------


def decode_rows(kind: str, store: Dict[str, torch.Tensor], ids_flat: torch.Tensor) -> torch.Tensor:
    """(N,) node ids -> (N, d) f32 stored values: raw rows (f32, or bf16 /
    int8 rows widened a gather at a time), SQ8/SQ6 byte grids, SQ4 nibbles
    (low nibble first), LVQ's per-row grids, PQ codewords or PRQ stage sums."""
    from .quant import lvq_decode, sq_decode

    safe = ids_flat.clamp(min=0).long()
    if kind == "raw":
        return store["data"][safe].float()
    if kind == "lvq":
        return lvq_decode(store["codes"][safe], store["off"][safe], store["scale"][safe], store["mean"])
    if kind in ("sq", "sq6", "sq4"):
        levels = {"sq": 256, "sq6": 64, "sq4": 16}[kind]
        return sq_decode(store["codes"][safe], store["vmin"], store["vdiff"], levels, kind == "sq4",
                         store["vmin"].shape[0])
    if kind == "pq":
        books = store["codebooks"]
        m, ksub, sub = books.shape
        idx = store["codes"][safe].long() + (torch.arange(m, device=safe.device) * ksub)[None, :]
        return books.reshape(m * ksub, sub)[idx].reshape(-1, m * sub)
    if kind == "prq":
        books = store["codebooks"]  # (nrq, m, ksub, sub)
        nrq, m, ksub, sub = books.shape
        codes = store["codes"][safe].long()
        off = (torch.arange(m, device=safe.device) * ksub)[None, :]
        acc = None
        for s in range(nrq):
            dec = books[s].reshape(m * ksub, sub)[codes[:, s * m : (s + 1) * m] + off].reshape(-1, m * sub)
            acc = dec if acc is None else acc + dec
        return acc
    raise ValueError(kind)


def beam_search(
    q: torch.Tensor,  # (nq, d) f32
    store: Dict[str, torch.Tensor],  # 'data' (nb, d) or codes + codec tensors
    graph: torch.Tensor,  # (nb, deg) int32
    entry: torch.Tensor,  # (E,) int32
    keep_mask: Optional[torch.Tensor],  # (nb,) bool or None
    *,
    kind: str,
    ef: int,
    k: int,
    deg: int,
    max_iters: int,
    is_l2: bool,
    is_jaccard: bool = False,
    has_mask: bool = False,
    beam_width: int = 1,
    route_cents: Optional[torch.Tensor] = None,  # (E, d) k-means centroids
    n_seed: int = 0,
    ring_cap: int = 256,  # visited-ring slots
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores (nq,k) larger-is-better, ids (nq,k) int32, -1 pad);
    requires k <= ef. ``is_jaccard`` scores {0,1} rows by their Jaccard
    similarity inter / max(|q| + |v| - inter, 1e-9)."""
    nq, d = q.shape
    dev = q.device
    E = entry.shape[0]
    pq_like = kind in ("pq", "prq")

    def decode(ids_flat: torch.Tensor) -> torch.Tensor:
        if pq_like and ids_flat.shape[0] > 16384:  # bound the codeword gathers
            return torch.cat([decode_rows(kind, store, ids_flat[s : s + 16384])
                              for s in range(0, ids_flat.shape[0], 16384)])
        return decode_rows(kind, store, ids_flat)

    def score_nodes(ids: torch.Tensor) -> torch.Tensor:
        """(nq, C) node ids -> (nq, C) larger-is-better scores."""
        C = ids.shape[1]
        vecs = decode(ids.reshape(-1)).reshape(nq, C, -1)
        dots = torch.bmm(vecs, q[:, :, None])[:, :, 0]
        if is_jaccard:
            union = torch.clamp(q.sum(1, keepdim=True) + vecs.sum(2) - dots, min=1e-9)
            return dots / union
        if is_l2:
            return 2.0 * dots - (vecs * vecs).sum(2)  # dist = |q|^2 - score
        return dots

    # entries: per-query k-means routing (score the routing centroids, seed
    # with each top centroid's resident node), else the global entry set
    if route_cents is not None and n_seed > 0:
        cs = q @ route_cents.T
        if is_l2:
            cs = 2.0 * cs - (route_cents * route_cents).sum(1)[None, :]
        _, top_c = topk_leftmost(cs, min(n_seed, E))
        ids0 = entry[top_c].int()
    else:
        ids0 = entry[None, :].int().expand(nq, E).contiguous()
    E_eff = ids0.shape[1]
    s0 = score_nodes(ids0)

    # the beam payload packs (id << 1) | expanded into one int32, so a merge
    # is one sort; id -1 is all ones, so padding is born expanded
    n0 = min(ef, E_eff)
    pad = ef - n0
    beam_p = torch.cat([ids0[:, :n0] << 1, torch.full((nq, pad), -1, dtype=torch.int32, device=dev)], dim=1)
    beam_s = torch.cat([s0[:, :n0], torch.full((nq, pad), NEG_INF, device=dev)], dim=1)
    beam_s, beam_p = sort_desc(beam_s, beam_p)

    # visited ring: each step's fresh ids are appended (recent-window once it
    # wraps); fresh_step tests the candidates against it and the beam
    W = max(1, min(beam_width, ef))
    G_full = W * deg
    n_slots = max(1, min(max_iters, max(ring_cap, G_full) // G_full))
    visited = torch.cat([ids0, torch.full((nq, n_slots * G_full), -1, dtype=torch.int32, device=dev)], dim=1)

    # result top-k (bitset-valid only)
    beam_ids = beam_p >> 1
    if has_mask:
        valid0 = keep_mask[beam_ids.clamp(min=0).long()] & (beam_ids >= 0)
    else:
        valid0 = beam_ids >= 0
    res_s, res_ids = sort_desc(
        torch.where(valid0, beam_s, torch.full_like(beam_s, NEG_INF)),
        torch.where(valid0, beam_ids, torch.full_like(beam_ids, -1)),
    )
    res_s, res_ids = res_s[:, :k], res_ids[:, :k]
    res_ids = torch.where(res_s == NEG_INF, torch.full_like(res_ids, -1), res_ids)

    with tracing.span("graph.walk"):
        done = torch.zeros(nq, dtype=torch.bool, device=dev)
        cols_ef = torch.arange(ef, device=dev)
        for i in range(max_iters):
            if i and i % DONE_CHECK_STEPS == 0:
                with tracing.span("graph.done_check", wait=True):
                    finished = bool(done.all())
                if finished:
                    break
            expanded = (beam_p & 1) == 1
            beam_ids = beam_p >> 1
            cand_s = torch.where(expanded, torch.full_like(beam_s, NEG_INF), beam_s)
            if W == 1:
                sel_pos = torch.argmax(cand_s, dim=1)[:, None]
                sel_score = torch.gather(cand_s, 1, sel_pos)
            else:
                sel_score, sel_pos = topk_leftmost(cand_s, W)
            done = done | (sel_score[:, 0] == NEG_INF)
            sel_valid = (sel_score != NEG_INF) & ~done[:, None]
            sel_id = torch.gather(beam_ids, 1, sel_pos)
            hit = (cols_ef[None, :, None] == sel_pos[:, None, :]).any(dim=2)
            beam_p = torch.where(hit, beam_p | 1, beam_p)

            nbrs = graph[sel_id.reshape(-1).clamp(min=0).long()].reshape(nq, G_full)
            live = torch.repeat_interleave(sel_valid & (sel_id >= 0), deg, dim=1)
            nbrs = torch.where(live, nbrs, torch.full_like(nbrs, -1))
            # visited filter: ring membership + exact membership in the beam (the
            # beam check keeps a node evicted from the wrapped ring out); a
            # masked lane scores row 0 (decode_rows clamps -1) and is dropped
            fresh, nb_scores, new_p = fresh_step(
                nbrs, visited, beam_ids, score_nodes(nbrs), E_eff + (i % n_slots) * G_full, W > 1
            )
            if has_mask:
                res_valid = fresh & keep_mask[nbrs.clamp(min=0).long()]
                rs, ri = sort_desc(
                    torch.cat([res_s, torch.where(res_valid, nb_scores, torch.full_like(nb_scores, NEG_INF))], dim=1),
                    torch.cat([res_ids, torch.where(res_valid, nbrs, torch.full_like(nbrs, -1))], dim=1),
                )
                res_s, res_ids = rs[:, :k], ri[:, :k]
            ns, npk = sort_desc(torch.cat([beam_s, nb_scores], dim=1), torch.cat([beam_p, new_p], dim=1))
            beam_s, beam_p = ns[:, :ef], npk[:, :ef]

    if not has_mask:
        # unmasked: the sorted beam's k-prefix is the result set
        ke = min(k, ef)
        res_s = beam_s[:, :ke]
        res_ids = torch.where(res_s == NEG_INF, torch.full_like(res_s, -1, dtype=torch.int32), (beam_p >> 1)[:, :ke])
        if ke < k:
            res_s = torch.nn.functional.pad(res_s, (0, k - ke), value=NEG_INF)
            res_ids = torch.nn.functional.pad(res_ids, (0, k - ke), value=-1)
    return dedup_topk(res_s, res_ids, k)


def dedup_topk(res_s: torch.Tensor, res_ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep each id's best copy (sort by id, drop consecutive repeats), then
    the top-k by score; -1 for empty slots."""
    key = torch.where(res_ids < 0, torch.full_like(res_ids, _INT32_MAX), res_ids)
    order = torch.sort(key, dim=1, stable=True).indices
    sid = torch.gather(res_ids, 1, order)
    ss = torch.gather(res_s, 1, order)
    dup = torch.cat([torch.zeros_like(sid[:, :1], dtype=torch.bool), sid[:, 1:] == sid[:, :-1]], dim=1)
    ss = torch.where(dup | (sid < 0), torch.full_like(ss, NEG_INF), ss)
    res_s, sel = topk_leftmost(ss, k)
    res_ids = torch.gather(sid, 1, sel)
    return res_s, torch.where(res_s == NEG_INF, torch.full_like(res_ids, -1), res_ids)
