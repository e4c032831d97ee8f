"""Whole runs of the harness on the CPU at a tiny size (tiny.py), past the
look for a card: a sound run, and the timed path broken underneath, where
`correct` has to come out false; and a run with no card, which fails."""

import json
import time

import numpy as np
import pytest

from ann_bench import harness, run, spec
from ann_bench.tests import tiny

SEED = 2**31 + 987654321  # past 32 signed bits


class Broken:
    """The program's index with its answers broken where they are produced."""

    def __init__(self, kt, idx, fault: str, warmup_calls: int):
        self.kt, self.idx, self.fault, self.last, self.calls = kt, idx, fault, None, 0
        self.warmup_calls = warmup_calls

    def Search(self, dataset, cfg, bitset):
        self.calls += 1
        res = self.idx.Search(dataset, cfg, bitset)
        nq, k = dataset.rows, int(cfg["k"])
        ids = res.value().ids.reshape(nq, k).copy()
        d = res.value().distance.reshape(nq, k).copy()
        if self.fault == "half_left_out":  # the second half of the batch gets no answer
            ids[nq // 2 :], d[nq // 2 :] = -1, np.inf
        elif self.fault == "answer_altered":  # one id of each answer moved to its neighbour row
            ids[:, 0] = (ids[:, 0] + 1) % self.idx.Count()
        elif self.fault == "state_unchanged":  # the previous request's answer returned again
            fresh = (ids, d)
            if self.last is not None:
                ids, d = self.last
            self.last = fresh
        elif self.fault == "fails" and self.calls > self.warmup_calls:  # fails in the window
            return self.kt.expected.Err(self.kt.Status.internal_error, "broken")
        return self.kt.expected.Ok(self.kt.GenResultDataSet(nq, k, ids, d))


def broken(fault, clients):
    def factory(kt, xb, config, build_cfg):
        return Broken(kt, harness.build_index(kt, xb, config, build_cfg), fault, clients * harness.WARMUP_ROUNDS)

    return factory


def answers_hold(checks) -> bool:
    """Every compared number but recall, which the tiny size does not set, holds."""
    return all(v <= lim for n, (v, lim) in checks.items() if n != "recall_at_10_min")


def tiny_run(name, trace=False, factory=None, **cell):
    w = tiny.workload(name, **cell)
    readers = spec.load_readers(w) if trace else None
    return harness.run(w, SEED, 2.0, trace, "cpu", time.perf_counter(), readers, factory)


@pytest.mark.parametrize("name", ["sift1m-hnsw.bulk", "sift1m-hnsw.filter99"])
def test_sound_run_passes_its_answer_checks(name):
    r = tiny_run(name)
    assert answers_hold(r["checks"]), r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"qps", "latency_p95_ms", "recall_at_10", "setup_s"}  # no device GB on the CPU
    assert list(r)[-1] == "checks"


def test_sound_ivf_pq_run_passes_its_answer_checks():
    assert answers_hold(tiny_run("sift1m-ivf_pq.bulk")["checks"])


def test_traced_run_reports_the_per_layer_metrics_it_finds():
    r = tiny_run("sift1m-hnsw.bulk", trace=True, trace_seconds=0.5)
    assert answers_hold(r["checks"]) and "build_s" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    assert "device_idle_pct" not in r["metrics"]  # no device operation on the CPU: the reader finds nothing


@pytest.mark.parametrize("fault,check", [
    ("half_left_out", "bad_answers_max"),
    ("answer_altered", "dist_rel_err_max"),
    ("state_unchanged", "dist_rel_err_max"),
    ("fails", "failed_max"),
])
@pytest.mark.parametrize("name", ["sift1m-hnsw.bulk", "sift1m-ivf_pq.bulk", "sift1m-hnsw.filter99"])
def test_broken_timed_path_is_not_correct(name, fault, check):
    r = tiny_run(name, factory=broken(fault, tiny.workload(name).cell["clients"]))
    assert not r["correct"]
    value, limit = r["checks"][check]
    assert (value > limit) if check.endswith("_max") else (value < limit)


def test_no_card_fails_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would not fail")
    assert run.main(["--workload", "sift1m-hnsw.bulk", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


@pytest.mark.card
def test_cell_runs_on_the_card(tmp_path):
    """The whole command on a card: a short window of the HNSW cell."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", "sift1m-hnsw.bulk",
                          "--seed", "7", "--seconds", "3", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
