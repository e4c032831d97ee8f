"""A/B of the IVF family's k=10 Search: this tree against another tree, on one card.

Each side runs in a process of its own, in turns (other, this, this, other,
``--pairs`` times). A process imports knowhere_tpu_torch from its tree, makes
chip_smoke.py's 1M x 128 SIFT-like corpus and 10,000 queries (seed 0),
builds IVF_FLAT, IVF_PQ, IVF_SQ8 and IVF_RABITQ at chip_smoke.py's
configurations, and times ``--reps`` warm Search calls of each at k=10 after
one warm-up (host clock, from a device sync to the numpy result). Each
process prints one JSON line: every rep, the median, and a digest of the ids
(equal digests: both trees returned the same ids). Then one summary line an
index: each process's median, and whether no median of this tree lies
above the other tree's largest.

Run from the repository root on the card:

    python3 search_ab.py --other .scratch/parent
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path, reps: int) -> dict:
    """Time the four indexes' k=10 Search with the package of ``tree``."""
    sys.path.insert(0, str(tree))
    import torch

    import knowhere_tpu_torch as kt

    if not Path(kt.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"knowhere_tpu_torch came from {kt.__file__}, not {tree}")
    cs = _chip_smoke()
    kt.set_device("cuda")
    kt.KnowhereConfig.SetSimdType("AUTO")
    xb, xq = cs.gen_corpus(1_000_000, 10_000, 128, seed=0)
    cases = {
        "IVF_FLAT": ({"metric_type": "L2", "nlist": 1024}, {"metric_type": "L2", "k": 10, "nprobe": 12}),
        "IVF_PQ": (cs.IVF_PQ_BUILD, cs.IVF_PQ_SEARCH),
        "IVF_SQ8": (cs.SQ8_BUILD, cs.SQ8_SEARCH),
        "IVF_RABITQ": (cs.RBQ_BUILD, cs.RBQ_SEARCH),
    }
    out = {"tree": str(tree)}
    q = kt.GenDataSetFromArray(xq)
    for name, (build, search) in cases.items():
        idx = kt.IndexFactory.Instance().Create(name).value()
        if idx.Build(kt.GenDataSetFromArray(xb), build) != kt.Status.success:
            raise RuntimeError(f"{name} Build failed")

        def run():
            res = idx.Search(q, search, kt.BitsetView())
            if not res.has_value():
                raise RuntimeError(f"{name} Search failed: {res.what()}")
            return np.asarray(res.value().ids)

        ids = run()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms_all": times, "ms_median": float(np.median(times)),
                     "ids_sha1": hashlib.sha1(np.ascontiguousarray(ids, np.int64).tobytes()).hexdigest()[:16]}
        del idx
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other tree (a checkout)")
    ap.add_argument("--pairs", type=int, default=1, help="rounds of (other, this, this, other)")
    ap.add_argument("--reps", type=int, default=9, help="timed searches an index a process")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.reps)))
        return 0
    order = ["other", "this", "this", "other"] * args.pairs
    trees = {"other": args.other, "this": ROOT}
    runs = []
    for side in order:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "search_ab.py"), "--other", str(args.other), "--reps", str(args.reps),
             "--worker", str(trees[side])],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["side"] = side
        print(json.dumps(line), flush=True)
        runs.append(line)
    for name in ("IVF_FLAT", "IVF_PQ", "IVF_SQ8", "IVF_RABITQ"):
        med = {s: [r[name]["ms_median"] for r in runs if r["side"] == s] for s in trees}
        print(json.dumps({
            "index": name, "other_ms_medians": med["other"], "this_ms_medians": med["this"],
            "this_within_other_max": max(med["this"]) <= max(med["other"]),
            "ids_equal": len({r[name]["ids_sha1"] for r in runs}) == 1,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
