"""IVF_PQ at GIST1M's widths on the port's normal path, held to the plain
reference (ann_bench/ivf_pq_plain.py) at a small size on the CPU.

The configuration of the benchmark's `gist1m-ivf_pq` (d 960, m 96, nbits 8,
OPQ, FP16 refine, refine_k 32, FAST precision) over 20,000 rows of its
GIST-like mixture (ann_bench/data.py), nlist 32, nprobe 8, 64 queries; lists
aligned at this size, so the search takes the ADC route with the queries
padded to 1,024 columns. tests/ivf_pq_plain_checks.py holds the pool, the ids
and the distances to the reference's and says why each tolerance is what it
is; two planted faults (a table without the query's lo part, BF16 refine
rows) must each fail them. Also: the ADC counters of ops/ivf_scan.py, once a
launch while tracing is on and never while it is off, and the reference's
imports.
"""

import ast
import collections
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import knowhere_tpu_torch as ktt
from ann_bench import data, ivf_pq_plain
from knowhere_tpu_torch.ops import adc_cuda, ivf_scan
from knowhere_tpu_torch.ops.distances import DistancePrecision, get_distance_precision, set_distance_precision
from knowhere_tpu_torch.utils import tracing

from . import ivf_pq_plain_checks as checks

torch.set_num_threads(4)
ktt.set_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "ann_bench" / "configs" / "gist1m-ivf_pq.json").read_text())
NB, NQ, NLIST, NPROBE = 20_000, 64, 32, 8
BUILD = dict(CONFIG["build"], metric_type=CONFIG["metric"], nlist=NLIST)
SEARCH = dict(CONFIG["search"], metric_type=CONFIG["metric"], k=10, nprobe=NPROBE)


@pytest.fixture(scope="module")
def built():
    """(index, plain reference's copy, queries) of the small configuration."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KNOWHERE_IVF_ALIGN_MIN", "4096")  # aligned lists at this size: the ADC route
    prec = get_distance_precision()
    set_distance_precision(DistancePrecision.FAST)
    try:
        xb, xq = data.mixture(CONFIG["corpus"], NB, NQ, 2_147_483_661)
        idx = ktt.IndexFactory.Instance().Create(CONFIG["index_type"]).value()
        assert idx.Build(ktt.GenDataSetFromArray(xb), BUILD) == ktt.Status.success
        bs = ktt.BinarySet()
        assert idx.Serialize(bs) == ktt.Status.success
        plain = ivf_pq_plain.load(bytes(bs.GetByName("IVF_PQ").data), "cpu")
        yield idx, plain, xq
    finally:
        set_distance_precision(prec)
        mp.undo()


@pytest.fixture(scope="module")
def reference(built):
    _, plain, xq = built
    return ivf_pq_plain.search(plain, torch.from_numpy(xq), SEARCH["k"], NPROBE, SEARCH["refine_k"])


def _compare(built, reference, port):
    _, plain, xq = built
    d, i, stages = reference
    return checks.compare(plain, xq, port, (d, i), stages, SEARCH["k"])


def test_route_is_adc_at_1024_columns(built):
    idx, _, xq = built
    node = idx.node
    assert node._scan_plan(SEARCH["k"], SEARCH["refine_k"]).route == "adc"
    assert node._dim == 960 and node._d_dev == 1024
    assert node._opq_rot is not None and node._store["rot_t"].shape == (1024, 1024)
    assert node._store["cent_scan"].shape == (NLIST, 1024)
    assert tuple(node._store["books"].shape) == (96, 256, 10)
    assert node._refine_store.data.dtype == torch.float16 and node._refine_store.data.shape[1] == 1024
    assert node._pad_q_host(xq).shape[1] == 1024
    # 4 subspaces a LUT chunk at ksub 256: 24 chunks over m = 96, inside a block's shared memory
    assert adc_cuda.adc_smem_bytes(96, 256, 10, False) <= adc_cuda.SMEM_LIMIT


def test_port_matches_the_plain_reference(built, reference):
    idx, _, xq = built
    numbers = _compare(built, reference, checks.port_search(idx, xq, SEARCH))
    assert checks.failed(numbers) == [], numbers
    assert numbers["adc_common"] > 0.8 * NQ * SEARCH["k"] * SEARCH["refine_k"]
    assert numbers["id_share"] >= numbers["id_share_min"] > 0.5


def _hi_only(q, books, *, is_l2):
    """compute_qlut without the query's lo part: the planted fault."""
    m, ksub, sub = books.shape
    hi = q[..., : m * sub].float().to(torch.bfloat16).float()
    lut = torch.einsum("nms,mvs->nmv", hi.reshape(-1, m, sub), books.float())
    return (2.0 * lut if is_l2 else lut).reshape(*q.shape[:-1], m * ksub)


def test_a_table_without_lo_fails(built, reference, monkeypatch):
    idx, _, xq = built
    monkeypatch.setattr(adc_cuda, "compute_qlut", _hi_only)
    numbers = _compare(built, reference, checks.port_search(idx, xq, SEARCH))
    assert "adc_lo" in checks.failed(numbers), numbers


def test_bf16_refine_rows_fail(built, reference, monkeypatch):
    idx, _, xq = built
    store = idx.node._refine_store
    monkeypatch.setattr(store, "data", store.data.to(torch.bfloat16))
    numbers = _compare(built, reference, checks.port_search(idx, xq, SEARCH))
    assert "distances" in checks.failed(numbers), numbers


def _counted(monkeypatch, idx, xq):
    """The ADC launches of one Search under a CPU profiler, at most 8 tasks a
    launch, and the ivf_scan.kernel spans' counters."""
    launches = []
    real = ivf_scan.adc_scan_tasks

    def launch(blk, nrows, *args, **kw):
        launches.append((nrows.clone(), args[1].shape[1]))
        return real(blk, nrows, *args, **kw)

    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=tracing.STORE_LIMIT))
    monkeypatch.setattr(ivf_scan, "adc_scan_tasks", launch)
    monkeypatch.setattr(ivf_scan, "_kernel_chunk", lambda Qg, d: 8)
    with profile(activities=[ProfilerActivity.CPU]):
        checks.port_search(idx, xq, SEARCH)
    counters = collections.Counter()
    for rec in tracing.get_span_log():
        if rec["counters"]:
            assert rec["name"] == "ivf_scan.kernel"
            counters.update(rec["counters"])
    return launches, counters


def test_adc_counters_once_a_launch(built, monkeypatch):
    idx, _, xq = built
    launches, counters = _counted(monkeypatch, idx, xq)
    assert len(launches) > 1
    m, ksub = 96, 256
    assert counters["ivf_scan.adc_lut_entries"] == sum(Qg * m * ksub * int((nr > 0).sum()) for nr, Qg in launches)
    # every (query, probed list) pair looks up each row of its list once a subspace
    node = idx.node
    probes = ivf_scan.coarse_probe(torch.from_numpy(node._pad_q_host(xq))[:NQ], node._store["centroids"],
                                   nprobe=NPROBE, is_l2=True)
    assert counters["ivf_scan.adc_lookups"] == m * int(node._lengths[probes.long().numpy()].sum())
    assert counters["ivf_scan.tasks_launched"] == sum(len(nr) for nr, _ in launches)


def test_adc_counters_off_count_nothing(built, monkeypatch):
    idx, _, xq = built
    seen = []
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=tracing.STORE_LIMIT))
    monkeypatch.setattr(tracing, "count", lambda name, value: seen.append(name))
    checks.port_search(idx, xq, SEARCH)
    assert not tracing.enabled() and seen == [] and tracing.get_span_log() == []


def test_plain_reference_imports_nothing_of_either_package():
    names = set()
    for node in ast.walk(ast.parse((ROOT / "ann_bench" / "ivf_pq_plain.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "knowhere_tpu", "knowhere_tpu_torch"}
    assert names <= {"__future__", "dataclasses", "typing", "numpy", "torch", "ann_bench"}
