"""The benchmark's data files, each found by the name `BENCHMARK.json` gives it.

- `BENCHMARK.json` at the root of the checkout: the cells (`workloads`), the
  configurations and the metrics.
- `ann_bench/configs/<config>.json` (the `file` of each configuration): the
  corpus, the index and its build and search parameters.
- `ann_bench/cells/<cell>.json`: the cell's traffic (request size, k,
  clients, query pool, filter) and the limits that decide `correct`.
- `ann_bench/layers/<metric>.py`: the reader of one per-layer metric, a
  function `read(ctx)` that returns a number, or None where it finds nothing.

A new configuration, cell or per-layer metric is new files and new entries
in `BENCHMARK.json`; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Workload:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    cell: dict  # the cell file's contents
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_workload(bench: dict, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Workload:
    """The cell `name` with its configuration and cell files."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"configuration {entry['config']!r} of {name!r} is not in BENCHMARK.json")
    config = json.loads((Path(root) / configs[0]["file"]).read_text())
    cell = json.loads((Path(bench_dir) / "cells" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if cell.get(key) != entry[key]:
            raise ValueError(f"cells/{name}.json: {key} {cell.get(key)!r}, BENCHMARK.json says {entry[key]!r}")
    return Workload(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        cell=cell,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable[[object], Optional[float]]:
    """`read` of `layers/<metric>.py`."""
    path = Path(bench_dir) / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ann_bench_layer_{metric.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no reader for per-layer metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_readers(workload: Workload, bench_dir: Path = BENCH_DIR) -> Dict[str, Callable]:
    return {m["name"]: load_reader(m["name"], bench_dir) for m in workload.per_layer}
