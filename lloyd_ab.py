"""Time the device build's Lloyd sums on one card.

Two ways to add the rows of each cluster, in a fixed order:

- ``segment``: ``knowhere_tpu_torch.ops.kmeans.cluster_sums`` as the port
  runs it (a stable sort by cluster, then each cluster's rows added in row
  order by segment_reduce, one thread a cluster and feature);
- ``onehot``: onehot(assign)^T @ x in f32 over 128 MB one-hot blocks (and,
  for PQ, the batched per-subspace one-hot product).

Part 1 times the sums alone at the IVF build's training shape (k = 1024,
262,144 x 128 rows) and at k = 4096 (1,048,576 rows: faiss's 256 points a
centroid), on chip_smoke's seeded SIFT-like corpus assigned to the nearest
of k rows drawn as centroids: each version's median ms (CUDA events),
whether two calls give the same bits, and the largest difference between
the versions' centroids. Part 2 times chip_smoke's GIST IVF_PQ build
(100,000 x 960, nlist 256, m = 96) with each version in the k-means and PQ
steps, in turns (forwards, then backwards), and the SIFT IVF_PQ build (1M x
128, m = 16) once each. Exits 1 if a version repeats other bits.

Run from the repository root on the card:

    python3 lloyd_ab.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def onehot_sums(x, assign, k, block_bytes=1 << 27):
    import torch

    nc = max(1, block_bytes // (4 * k))
    cols = torch.arange(k, device=x.device)
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    for i0 in range(0, x.shape[0], nc):
        sums.addmm_((assign[i0 : i0 + nc, None] == cols[None, :]).float().T, x[i0 : i0 + nc].float())
    return sums


def onehot_pq_lloyd(xs, c0, *, ksub, n_iters, nc):
    """PQ's Lloyd iterations with batched one-hot sums, chunk by chunk."""
    import torch

    m, n, s = xs.shape
    c = c0.float()
    off = (torch.arange(m, device=xs.device) * ksub)[:, None]
    cols = torch.arange(ksub, device=xs.device)
    for _ in range(n_iters):
        c_sq = (c * c).sum(2)
        sums = torch.zeros((m, ksub, s), dtype=torch.float32, device=xs.device)
        counts = torch.zeros(m * ksub, dtype=torch.float32, device=xs.device)
        for i0 in range(0, n, nc):
            xc = xs[:, i0 : i0 + nc].float()
            a = torch.argmin(c_sq[:, None, :] - 2.0 * torch.bmm(xc, c.transpose(1, 2)), 2)
            sums.baddbmm_((a[..., None] == cols).float().transpose(1, 2), xc)
            counts += torch.bincount((a + off).reshape(-1), minlength=m * ksub).float()
        counts = counts.view(m, ksub)
        c = torch.where((counts == 0)[..., None], c, sums / torch.clamp(counts, min=1.0)[..., None])
    return c


def patch(name):
    """Point the build's Lloyd sums at one version; returns the undo."""
    from knowhere_tpu_torch.ops import kmeans, quant

    saved = (kmeans.cluster_sums, quant._pq_lloyd_batched)
    if name == "onehot":
        kmeans.cluster_sums, quant._pq_lloyd_batched = onehot_sums, onehot_pq_lloyd

    def undo():
        kmeans.cluster_sums, quant._pq_lloyd_batched = saved

    return undo


def sums_alone(xb, versions) -> bool:
    import torch

    import chip_smoke
    from knowhere_tpu_torch.ops import kmeans

    rng = np.random.default_rng(7)
    ok = True
    for k in (1024, 4096):
        n = min(256 * k, len(xb))
        x = torch.from_numpy(np.ascontiguousarray(xb[:n])).cuda()
        cents = x[torch.from_numpy(rng.choice(n, k, replace=False)).cuda()]
        assign = torch.cat([kmeans._assign_block(x[i : i + kmeans.ASSIGN_CHUNK], cents).long()
                            for i in range(0, n, kmeans.ASSIGN_CHUNK)])
        counts = torch.bincount(assign, minlength=k).clamp(min=1).float()[:, None]
        line = {"k": k, "rows": n, "largest_cluster": int(torch.bincount(assign).max())}
        out = {}
        for name, fn in versions.items():
            a, b = fn(x, assign, k), fn(x, assign, k)
            torch.cuda.synchronize()
            same = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
            ok = ok and same
            out[name] = a / counts
            line[f"{name}_bit_equal"] = same
            line[f"{name}_ms"] = chip_smoke.time_ms(lambda fn=fn: fn(x, assign, k), reps=5)
        line["max_centroid_diff"] = float((out["onehot"] - out["segment"]).abs().max())
        print("lloyd_ab", json.dumps(line), flush=True)
        del x, cents, assign, out
        torch.cuda.empty_cache()
    return ok


def builds(xb, names) -> None:
    import torch

    import chip_smoke
    import knowhere_tpu_torch as kt

    xg, _ = chip_smoke.gen_corpus(100_000, 10, 960, seed=0)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        undo = patch(name)
        try:
            idx = kt.IndexFactory.Instance().Create("IVF_PQ").value()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if idx.Build(kt.GenDataSetFromArray(xg), chip_smoke.GIST_PQ_BUILD) != kt.Status.success:
                raise RuntimeError("GIST IVF_PQ Build failed")
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        finally:
            undo()
        del idx
    print("lloyd_ab", json.dumps({"gist_pq_build_s": times}), flush=True)
    sift = {}
    for name in names:
        undo = patch(name)
        try:
            idx = kt.IndexFactory.Instance().Create("IVF_PQ").value()
            t0 = time.perf_counter()
            if idx.Build(kt.GenDataSetFromArray(xb), chip_smoke.IVF_PQ_BUILD) != kt.Status.success:
                raise RuntimeError("SIFT IVF_PQ Build failed")
            torch.cuda.synchronize()
            sift[name] = time.perf_counter() - t0
        finally:
            undo()
        del idx
    print("lloyd_ab", json.dumps({"sift_pq_build_s": sift}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lloyd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops import kmeans

    kt.set_device("cuda")  # TF32 off, as in a build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    xb, _ = chip_smoke.gen_corpus(1_000_000, 10, 128, seed=0)
    ok = sums_alone(xb, {"segment": kmeans.cluster_sums, "onehot": onehot_sums})
    builds(xb, ["segment", "onehot"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
