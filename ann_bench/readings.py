"""The readings a cell's limits are set from: the program's compared numbers
over many seeds, and its control's, in one process.

    python3 ann_bench/readings.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6]

Each seed is a whole run of the cell (corpus, build, a window of `--seconds`,
the reference's judgement) and prints one JSON line: the seed, "program" or
"control", `correct`, the checks and the end-to-end metrics. The control is
the cell's `control` (cells/<cell>.json) put in the program's place:
- `{"reference": <precision>}`: the reference computed at that lower
  precision (reference.PRECISIONS) answers every request;
- `{"build": {...}}`: the program with its own lower-precision path switched
  on by those build parameters.
The benchmark's own runs never run the control. It needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class ReferenceIndex:
    """The plain reference at a lower precision, behind Index.Search."""

    def __init__(self, kt, xb, precision: str):
        import torch

        self.kt = kt
        self.xb = torch.from_numpy(xb).to(kt.get_device())
        self.precision = precision

    def Search(self, dataset, cfg, bitset):
        import numpy as np
        import torch

        from ann_bench import reference

        dev = self.xb.device
        q = torch.from_numpy(np.asarray(dataset.tensor, dtype=np.float32)).to(dev)
        keep = None if bitset.empty_view() else torch.from_numpy(bitset.host_mask(len(self.xb))).to(dev)
        k = int(cfg["k"])
        d, i = reference.knn(q, self.xb, k, keep, self.precision)
        return self.kt.expected.Ok(self.kt.GenResultDataSet(len(q), k, i.cpu().numpy(), d.cpu().numpy()))


def control_factory(control: dict):
    """The index_factory of harness.run that puts the control in the
    program's place."""
    from ann_bench import harness

    if "reference" in control:
        return lambda kt, xb, config, build_cfg: ReferenceIndex(kt, xb, control["reference"])
    return lambda kt, xb, config, build_cfg: harness.build_index(kt, xb, config, dict(build_cfg, **control["build"]))


def reading(workload, seed: int, seconds: float, device: str, control: bool) -> dict:
    from ann_bench import harness

    factory = control_factory(workload.cell["control"]) if control else None
    r = harness.run(workload, seed, seconds, False, device, time.perf_counter(), index_factory=factory)
    return {"seed": seed, "side": "control" if control else "program", "correct": r["correct"],
            "checks": r["checks"], "metrics": {n: m["value"] for n, m in r["metrics"].items()},
            "attempted": r["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from ann_bench import spec

    if not torch.cuda.is_available():
        print("ann_bench: readings need a CUDA device", file=sys.stderr)
        return 1
    workload = spec.load_workload(spec.load_benchmark(ROOT), args.workload, ROOT)
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(reading(workload, int(s), args.seconds, "cuda", side == "control")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
