"""Why SHARDED_HNSW's recall sits below the single HNSW's on one card.

Builds SHARDED_HNSW over chip_smoke's SIFT-like 1M x 128 corpus on four
shards of one card (M 16, efConstruction 200: chip_smoke's HNSW_BUILD),
once at each scan precision (``AUTO``: FAST, the f32 scan kernel, as
chip_smoke runs; ``GENERIC``: EXACT, the port's default, the plain scan in
the kNN-graph build), and searches its 10,000 queries at ef 48, k 10, with
each shard's walk changed in one way at a time:

- ``as_built``: the reference's walk (each 250,000-row shard routes its
  8 seeds from 64 k-means centroids and walks ef // W + 6 steps);
- ``cents_512`` / ``cents_1024``: each shard routes from 512 centroids (the
  single HNSW's rule, 2^round(log2(sqrt(rows))), at 250,000 rows) or 1,024;
- ``steps_x2``: twice the steps, 64 centroids;
- ``seeds_ef``: ef seeds (48) instead of 8, one a centroid;
- ``general_walk``: the non-inline walk over the same graphs
  (ops/graph.beam_search, 2 ef + 32 iterations).

For each: recall@10 of the merged answer against FLAT's over the 1M rows,
the mean recall@10 of the shards' own answers against each shard's exact
top-10 over its rows, and the search's wall ms. A changed walk that brings
the merged recall near the single HNSW's says the gap lies in the walk's
routing or length, not in the graphs. Prints one JSON line a variant and
the card's name and power limit.

Run from the repository root on the card:

    python3 sharded_hnsw_walk.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHARDS, EF, K = 4, 48, 10


def local_truth(x_local, xq, k, block=2000):
    """Each query's exact top-k over one shard's rows (f32 on the card)."""
    import torch

    b = torch.from_numpy(x_local).cuda()
    bn = (b * b).sum(1)
    out = []
    for s in range(0, len(xq), block):
        q = torch.from_numpy(xq[s : s + block]).cuda()
        d2 = bn[None, :] - 2.0 * (q @ b.T)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def reroute(eng, n_cents):
    """Give every shard's inline walk n_cents routing centroids (the
    engine's own k-means, 6 iterations) and each one's nearest node."""
    from knowhere_tpu_torch.device import scoped_device, to_device
    from knowhere_tpu_torch.ops import distances as D
    from knowhere_tpu_torch.ops import kmeans as KM
    from knowhere_tpu_torch.ops import topk as T

    for sh in eng._shards:
        x_local = eng._xb[sh["row0"] : sh["row0"] + sh["rows"]]
        with scoped_device(sh["device"]):
            cents, _ = KM.kmeans(x_local, n_cents, n_iters=6)
            data = sh["store"]["data"]
            eids, _ = T.knn_search(cents, data, 1, "L2", aux=D.base_aux("L2", data))
            sh["inline_entry"] = to_device(eids.reshape(-1).astype(np.int32))
            sh["inline_cents"] = to_device(cents.astype(np.float32))


def run(eng, xq, gt, truths, prec, name, over=None, general=False):
    """One search of every query through the engine with each shard's walk
    changed by ``over`` (kwargs of beam_search_inline, from the engine's)
    or replaced by the general walk; prints and returns its line."""
    import torch

    from knowhere_tpu_torch.ops import graph as G
    from knowhere_tpu_torch.ops import graph_inline as GI

    import chip_smoke

    real_inline, real_general = GI.beam_search_inline, G.beam_search
    per_shard = []

    def inline(*a, **kw):
        s, ids = real_inline(*a, **dict(kw, **(over(kw) if over else {})))
        per_shard.append(ids.cpu().numpy())
        return s, ids

    def general_walk(*a, **kw):
        s, ids = real_general(*a, **kw)
        per_shard.append(ids.cpu().numpy())
        return s, ids

    saved = [sh.pop("inline") for sh in eng._shards] if general else None
    GI.beam_search_inline, G.beam_search = inline, general_walk
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = eng.search(xq, K, ef=EF)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        GI.beam_search_inline, G.beam_search = real_inline, real_general
        if saved:
            for sh, inl in zip(eng._shards, saved):
                sh["inline"] = inl
    line = {"precision": prec, "variant": name, "ef": EF, "recall_at_10": chip_smoke.recall_at(ids, gt),
            "shard_recall_at_10": float(np.mean([chip_smoke.recall_at(p, t) for p, t in zip(per_shard, truths)])),
            "ms": ms}
    print("sharded_hnsw_walk", json.dumps(line), flush=True)
    return ids, line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_hnsw_walk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import knowhere_tpu_torch as kt

    kt.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    xb, xq = chip_smoke.gen_corpus(1_000_000, 10_000, 128, seed=0)
    flat, gt = chip_smoke._flat_truth(kt, xb, xq)
    del flat
    torch.cuda.empty_cache()
    for prec in ("AUTO", "GENERIC"):
        kt.KnowhereConfig.SetSimdType(prec)
        idx = kt.IndexFactory.Instance().Create("SHARDED_HNSW", object=[torch.device("cuda", 0)] * SHARDS).value()
        if idx.Build(kt.GenDataSetFromArray(xb), chip_smoke.HNSW_BUILD) != kt.Status.success:
            raise RuntimeError("SHARDED_HNSW Build failed")
        eng = idx.node._engine
        truths = [local_truth(xb[sh["row0"] : sh["row0"] + sh["rows"]], xq, K) for sh in eng._shards]

        ids_api = chip_smoke._search(idx, kt, xq, dict(chip_smoke.GRAPH_SEARCH, ef=EF))[0]
        ids, _ = run(eng, xq, gt, truths, prec, "as_built")
        if not np.array_equal(ids, ids_api):
            raise AssertionError("the engine's search gave other ids than the index's Search")
        run(eng, xq, gt, truths, prec, "steps_x2", over=lambda kw: {"n_steps": 2 * kw["n_steps"]})
        run(eng, xq, gt, truths, prec, "seeds_ef",
            over=lambda kw: {"n_seed": min(int(kw["ef"]), int(eng._shards[0]["inline_entry"].shape[0]))})
        run(eng, xq, gt, truths, prec, "general_walk", general=True)
        for n in (512, 1024):
            reroute(eng, n)
            run(eng, xq, gt, truths, prec, f"cents_{n}")
        del idx, eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
