"""Run one cell of the benchmark once and print its result.

    python3 ann_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding `knowhere_tpu_torch` and
`BENCHMARK.json`, on a machine with as many CUDA devices as the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit. The same numbers
are the last lines of standard error. Without the devices, or where the
program is missing, it exits 1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "knowhere_tpu")  # whole top-level module names


def loaded_forbidden() -> list:
    """The forbidden packages the process has loaded, by top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ann_bench import harness, spec

    bench = spec.load_benchmark(ROOT)
    workload = spec.load_workload(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ann_bench: {args.workload} needs {workload.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 1
    readers = spec.load_readers(workload) if args.trace else None
    result = harness.run(workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START, readers)
    found = loaded_forbidden()
    if found:
        print(f"ann_bench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 1
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
