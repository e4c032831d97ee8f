"""Time the two selections of the port's row-wise top-k on one card.

``knowhere_tpu_torch.ops.topk.topk_leftmost`` takes each row's k largest
values, lowest column first on ties, in one of two ways:

- ``sort``: ``_topk_sorted``, a stable descending sort of the whole row,
  then its first k;
- ``packed``: ``_topk_packed``, each f32 value and its column packed into
  one int64 key, then ``torch.topk`` of the distinct keys and a gather.

f32 rows of at least ``PACKED_MIN_COLS`` columns take ``packed``. Part 1
times both at the shapes the port's callers give (the sharded FLAT search's
score block, the coarse probes, the graph walks' candidate rows, the
merges, the sparse brute force) and over a ladder of widths, on seeded
normal scores rounded to repeat values, and checks that both return the
same values and columns. Part 2 times SHARDED_FLAT's search of
chip_smoke's 10,000 SIFT-like queries over 1M x 128 rows on four shards of
the card with each version in the shard top-k, in turns (sort, packed,
packed, sort). Prints one JSON line a shape and one for part 2, and the
card's name and power limit; exits 1 if the versions disagree.

Run from the repository root on the card:

    python3 topk_ab.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SHAPES = [  # (what gives the shape, rows, columns, k)
    ("sharded_flat_block", 2147, 250_000, 10),  # SCORE_BLOCK_BYTES over 250,000 f32 columns
    ("sparse_brute_force", 2000, 200_000, 10),
    ("coarse_probe_sift", 10_000, 1024, 12),
    ("coarse_probe_deep", 500, 4096, 8),
    ("graph_step", 10_000, 192, 6),  # W 6 x degree 32
    ("merge_k10", 10_000, 20, 10),
] + [(f"width_{c}", 10_000, c, 10) for c in (2048, 4096, 8192, 16384, 32768, 65536)]


def shapes_alone() -> bool:
    import torch

    import chip_smoke
    from knowhere_tpu_torch.ops.topk import PACKED_MIN_COLS, _topk_packed, _topk_sorted

    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for caller, rows, cols, k in SHAPES:
        # rounded to 1/64: repeated values, so the tie rule is exercised
        score = torch.round(torch.randn(rows, cols, device="cuda", generator=g) * 64) / 64
        a, b = _topk_sorted(score, k), _topk_packed(score, k)
        same = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        ok = ok and same
        line = {"shape": caller, "rows": rows, "columns": cols, "k": k, "same": same,
                "takes": "packed" if cols >= PACKED_MIN_COLS else "sort",
                "sort_ms": chip_smoke.time_ms(lambda: _topk_sorted(score, k), reps=10),
                "packed_ms": chip_smoke.time_ms(lambda: _topk_packed(score, k), reps=10)}
        print("topk_ab", json.dumps(line), flush=True)
        del score
        torch.cuda.empty_cache()
    return ok


def sharded_flat(xb, xq) -> bool:
    import torch

    import chip_smoke
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops.topk import _topk_packed, _topk_sorted
    from knowhere_tpu_torch.parallel import sharding

    idx = kt.IndexFactory.Instance().Create("SHARDED_FLAT", object=[torch.device("cuda", 0)] * 4).value()
    if idx.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}) != kt.Status.success:
        raise RuntimeError("SHARDED_FLAT Build failed")
    cfg = {"metric_type": "L2", "k": 10}
    real = sharding.topk_leftmost
    versions = {"sort": _topk_sorted, "packed": _topk_packed}
    times, ids = {n: [] for n in versions}, {}
    for name in ["sort", "packed", "packed", "sort"]:
        sharding.topk_leftmost = versions[name]
        try:
            (ids[name], _), t, _ = chip_smoke._warm(lambda: chip_smoke._search(idx, kt, xq, cfg), reps=3)
        finally:
            sharding.topk_leftmost = real
        times[name] += t
    same = bool(np.array_equal(ids["sort"], ids["packed"]))
    print("topk_ab", json.dumps({"sharded_flat_search_ms": times, "queries": len(xq), "ids_same": same}), flush=True)
    return same


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import knowhere_tpu_torch as kt

    kt.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ok = shapes_alone()
    xb, xq = chip_smoke.gen_corpus(1_000_000, 10_000, 128, seed=0)
    ok = sharded_flat(xb, xq) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
