"""BENCHMARK.json against the contract, and every cell, configuration and
reader found by name; a new configuration, cell and per-layer metric taken
from new files and entries alone."""

import json
import re
import shutil

import pytest

from ann_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"] == ["python3", "ann_bench/run.py"] and bench["paths"] == ["ann_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    for kind, entries in (("config", bench["configs"]), ("workload", bench["workloads"]),
                          ("end_to_end", bench["end_to_end"]), ("per_layer", bench["per_layer"])):
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names))
        for e in entries:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert len(metrics) == len(bench["end_to_end"]) + len(bench["per_layer"])


def test_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("name", ["sift1m-hnsw.bulk", "sift1m-ivf_pq.bulk", "sift1m-hnsw.filter99"])
def test_workload_loads_with_its_readers(bench, name):
    w = spec.load_workload(bench, name)
    assert w.chips == 1 and w.config["nb"] == 1_000_000 and w.config["reduced"] == []
    assert {"setup_s", "qps"} <= {m["name"] for m in w.end_to_end}
    readers = spec.load_readers(w)
    assert set(readers) == {m["name"] for m in w.per_layer} and len(readers) >= 1
    assert all(callable(r) for r in readers.values())
    assert set(w.cell["limits"]) == {"recall_at_10_min", "dist_rel_err_max"}


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in bench["workloads"]}


def test_new_config_cell_and_metric_from_new_files_alone(bench, tmp_path):
    """A later change adds files and entries; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "ann_bench", ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((spec.BENCH_DIR / "configs" / "sift1m-ivf_pq.json").read_text())
    cfg.update(name="sift1m-ivf_pq_m32", build=dict(cfg["build"], m=32))
    (root / "ann_bench" / "configs" / "sift1m-ivf_pq_m32.json").write_text(json.dumps(cfg))
    cell = json.loads((spec.BENCH_DIR / "cells" / "sift1m-ivf_pq.bulk.json").read_text())
    cell.update(config="sift1m-ivf_pq_m32", traffic="top100", k=100)
    (root / "ann_bench" / "cells" / "sift1m-ivf_pq_m32.top100.json").write_text(json.dumps(cell))
    (root / "ann_bench" / "layers" / "requests_read.py").write_text(
        "def read(ctx):\n    return len(ctx.records)\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "sift1m-ivf_pq_m32", "source": "a test", "file": "ann_bench/configs/sift1m-ivf_pq_m32.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "sift1m-ivf_pq_m32.top100", "config": "sift1m-ivf_pq_m32", "traffic": "top100",
                             "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "requests_read", "unit": "requests", "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "qps", "workloads": ["sift1m-ivf_pq_m32.top100"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    loaded = spec.load_benchmark(root)
    w = spec.load_workload(loaded, "sift1m-ivf_pq_m32.top100", root, root / "ann_bench")
    assert w.config["build"]["m"] == 32 and w.cell["k"] == 100
    readers = spec.load_readers(w, root / "ann_bench")
    assert "requests_read" in readers and readers["requests_read"](type("Ctx", (), {"records": [1, 2]})) == 2
    old = spec.load_workload(loaded, "sift1m-hnsw.bulk", root, root / "ann_bench")
    assert "requests_read" not in {m["name"] for m in old.per_layer}


def test_a_cell_file_that_disagrees_is_refused(bench, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "ann_bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    path = root / "ann_bench" / "cells" / "sift1m-hnsw.bulk.json"
    cell = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cell, traffic="filter99")))
    with pytest.raises(ValueError):
        spec.load_workload(spec.load_benchmark(root), "sift1m-hnsw.bulk", root, root / "ann_bench")
