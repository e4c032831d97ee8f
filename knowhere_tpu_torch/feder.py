"""Feder: the index-structure dumps of the visualizer (counterpart of
knowhere_tpu/feder.py; numpy only).

Parity target: reference include/knowhere/feder/{HNSW,IVFFlat}.h.
GetIndexMeta returns a JSON overview; GetFederVisit records the visit order
of a search. The batched device walk keeps no per-step trace, so a host
replay walks the same graph from the same entry points with the same ef
for the (typically few) visualized queries and records its visits.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def hnsw_overview(graph: np.ndarray, entry: np.ndarray, overview_levels: int = 3) -> Dict:
    """Degree-stratified overview (the flat graph's analog of HNSW levels)."""
    nb, deg = graph.shape
    degrees = (graph >= 0).sum(axis=1)
    # sample nodes per "level": level 0 = all (summarized), upper levels =
    # progressively smaller random strata, mirroring the level pyramid
    rng = np.random.default_rng(0)
    levels = []
    size = min(nb, 256)
    for lv in range(overview_levels):
        sample = rng.choice(nb, size=max(size >> lv, 1), replace=False)
        levels.append(
            {
                "level": lv,
                "nodes": sample.tolist(),
                "edges": {int(n): graph[n][graph[n] >= 0].tolist()[:8] for n in sample[:64]},
            }
        )
    return {
        "type": "HNSW",
        "ntotal": int(nb),
        "max_degree": int(deg),
        "avg_degree": float(degrees.mean()),
        "entry_points": entry.tolist(),
        "overview_levels": levels,
    }


def instrumented_walk(
    x: np.ndarray,  # decoded vectors (host)
    graph: np.ndarray,
    entry: np.ndarray,
    query: np.ndarray,
    ef: int,
    is_l2: bool = True,
) -> List[Dict]:
    """Host replay of the beam search recording (id, distance) visit order."""
    import heapq

    def dist(i):
        d = query - x[i]
        v = float(np.dot(d, d)) if is_l2 else -float(np.dot(query, x[i]))
        return v

    visited = set()
    trace: List[Dict] = []
    heap = []  # (dist, id) min-heap candidates
    results = []  # (-dist, id) max-heap of size ef
    for e in entry.tolist():
        d = dist(e)
        visited.add(e)
        trace.append({"id": int(e), "distance": d, "source": -1})
        heapq.heappush(heap, (d, int(e)))
        heapq.heappush(results, (-d, int(e)))
        if len(results) > ef:
            heapq.heappop(results)
    while heap:
        d, node = heapq.heappop(heap)
        if results and d > -results[0][0] and len(results) >= ef:
            break
        for nbr in graph[node]:
            nbr = int(nbr)
            if nbr < 0 or nbr in visited:
                continue
            visited.add(nbr)
            nd = dist(nbr)
            trace.append({"id": nbr, "distance": nd, "source": int(node)})
            if len(results) < ef or nd < -results[0][0]:
                heapq.heappush(heap, (nd, nbr))
                heapq.heappush(results, (-nd, nbr))
                if len(results) > ef:
                    heapq.heappop(results)
    return trace


def ivf_overview(centroids: np.ndarray, offsets: np.ndarray) -> Dict:
    return {
        "type": "IVF_FLAT",
        "nlist": int(centroids.shape[0]),
        "dim": int(centroids.shape[1]),
        "list_sizes": np.diff(offsets).tolist(),
        "centroids_norm": np.linalg.norm(centroids, axis=1).round(4).tolist(),
    }


def to_json(obj: Dict) -> str:
    return json.dumps(obj, separators=(",", ":"))
