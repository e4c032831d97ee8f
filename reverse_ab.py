"""Time the graph build's reverse-edge backfill on one card, on the host and
on the device.

Builds DISKANN's graph over chip_smoke's seeded SIFT-like corpus (1M x 128;
max_degree 56, intermediate degree 128, alpha 1.2, k-means routed as
models/diskann.py builds it) without its reverse edges, then backfills them
two ways:

- ``numpy``: the JAX package's steps (knowhere_tpu/ops/graph.py,
  build_graph's add_reverse block) on the host, as the port ran them before
  it moved them onto the device;
- ``device``: ``knowhere_tpu_torch.ops.graph.add_reverse_edges`` on the
  card (torch.isin and a stable torch.sort).

Prints each one's seconds (host clock; the device one ends in its copy back
to the host) and whether the graphs are equal bit for bit, then the same
at HNSW's shape (degree 32, intermediate degree 50) on the same corpus.
Exits 1 if they differ.

Run from the repository root on the card:

    python3 reverse_ab.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def reverse_edges_numpy(graph: np.ndarray) -> np.ndarray:
    """The JAX package's reverse-edge backfill, in numpy as it is there."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("reverse_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops import graph as G
    from knowhere_tpu_torch.ops.kmeans import kmeans

    kt.set_device("cuda")
    kt.KnowhereConfig.SetSimdType("AUTO")
    card = cs.card_line()
    print("card:", card)
    xb, _ = cs.gen_corpus(1_000_000, 1, 128, seed=0)
    nb = len(xb)
    nlist = 1 << int(round(np.log2(max(64, int(np.sqrt(nb))))))
    cents, assign = kmeans(xb, nlist, n_iters=8)
    x_dev = torch.from_numpy(xb).cuda()
    ok = True
    for name, deg, inter, alpha in (("diskann", 56, 128, 1.2), ("hnsw", 32, 50, 1.0)):
        t0 = time.perf_counter()
        graph = G.build_graph(xb, deg, "L2", intermediate_deg=inter, alpha=alpha, add_reverse=False,
                              n_long_edges=0, centroids=cents, assign=assign, x_dev=x_dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = reverse_edges_numpy(graph)
        numpy_s = time.perf_counter() - t0
        G.add_reverse_edges(graph, x_dev.device)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = G.add_reverse_edges(graph, x_dev.device)
        device_s = time.perf_counter() - t0
        equal = bool(np.array_equal(got, want))
        ok &= equal
        print(json.dumps({"shape": name, "nb": nb, "deg": deg, "intermediate_deg": inter,
                          "graph_without_reverse_s": build_s, "numpy_s": numpy_s, "device_s": device_s,
                          "edges_added": int((got != graph).sum()), "bit_equal": equal}), flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
