"""The port's tracing (knowhere_tpu_torch/utils/tracing.py): the span that is
a shared no-op while off, the spans and counters of the IVF_PQ and HNSW
search paths under a CPU torch profiler (names, parents, one root a request,
waits, counters), the same names among the profiler's own events, a second
thread's span, the store's bound, and the facade's latency histograms and
AddEvent on the spans' clock."""

import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import knowhere_tpu_torch as ktt
from knowhere_tpu_torch.ops.distances import DistancePrecision, get_distance_precision, set_distance_precision
from knowhere_tpu_torch.utils import metrics, tracing

torch.set_num_threads(2)
ktt.set_device("cpu")

IVF_SPANS = {  # name -> its parent's name (None: the root), or the names it may have
    "knowhere_search": None, "search.config": "knowhere_search", "ivf.queries": "knowhere_search",
    "ivf.probe": "knowhere_search", "ivf.scan": "knowhere_search", "ivf_scan.tasks": "ivf.scan",
    "ivf_scan.kernel": "ivf.scan", "ivf_scan.merge": "ivf.scan", "ivf.refine": "ivf.scan",
    "ivf.readback": "knowhere_search", "ivf.topk_full": "knowhere_search", "ivf.result": "knowhere_search",
}
HNSW_SPANS = {
    "knowhere_search": None, "search.config": "knowhere_search", "hnsw.prep": "knowhere_search",
    "graph_inline.seed": "knowhere_search", "graph_inline.walk": "knowhere_search",
    "graph_inline.done_check": "graph_inline.walk", "graph_inline.rerank": "knowhere_search",
    "hnsw.readback": "knowhere_search", "hnsw.result": "knowhere_search",
}
HNSW_FILTERED_SPANS = {
    "knowhere_search": None, "search.config": "knowhere_search", "hnsw.prep": "knowhere_search",
    "hnsw.brute_force": "knowhere_search", "hnsw.readback": "hnsw.brute_force", "hnsw.result": "knowhere_search",
}
HNSW_REFINE_SPANS = dict(HNSW_SPANS, **{"hnsw.refine": "knowhere_search",
                                         "hnsw.readback": ("knowhere_search", "hnsw.refine")})
WAITS = {"ivf.readback", "hnsw.readback", "graph_inline.done_check"}


def _fresh(monkeypatch, limit=tracing.STORE_LIMIT):
    """An empty store of `limit` records for one test."""
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=limit))
    monkeypatch.setattr(tracing, "_dropped", 0)


@pytest.fixture(autouse=True)
def _fresh_store(monkeypatch):
    _fresh(monkeypatch)
    yield
    tracing.init_telemetry(tracing.TraceConfig())


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((32, 128)).astype(np.float32) * 3
    xb = centers[rng.integers(0, 32, 4096)] + rng.standard_normal((4096, 128)).astype(np.float32)
    xq = centers[rng.integers(0, 32, 40)] + rng.standard_normal((40, 128)).astype(np.float32)
    return xb.astype(np.float32), xq.astype(np.float32)


def _build(name, xb, cfg):
    idx = ktt.IndexFactory.Instance().Create(name).value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), cfg) == ktt.Status.success
    return idx


@pytest.fixture(scope="module")
def ivf_pq(rows):
    mp = pytest.MonkeyPatch()
    mp.setenv("KNOWHERE_IVF_ALIGN_MIN", "1024")  # aligned lists at test size: the ADC route
    prec = get_distance_precision()
    set_distance_precision(DistancePrecision.FAST)
    try:
        idx = _build("IVF_PQ", rows[0], {"metric_type": "L2", "nlist": 16, "m": 16, "nbits": 8, "opq": True,
                                         "refine": True, "refine_type": "FP16"})
        assert idx.node._scan_plan(10, 8).route == "adc"
        yield idx
    finally:
        set_distance_precision(prec)
        mp.undo()


@pytest.fixture(scope="module")
def hnsw(rows):
    mp = pytest.MonkeyPatch()
    mp.setenv("KNOWHERE_GRAPH_INLINE", "1")  # the inline walk below its size floor
    try:
        idx = _build("HNSW", rows[0], {"metric_type": "L2", "M": 8, "efConstruction": 40})
        ref = _build("HNSW_SQ", rows[0], {"metric_type": "L2", "M": 8, "efConstruction": 40, "sq_type": "SQ8",
                                          "refine": True, "refine_type": "FP16"})
        assert idx.node._inline is not None and ref.node._inline is not None
        yield idx, ref
    finally:
        mp.undo()


def _search(idx, xq, cfg, bitset=None):
    res = idx.Search(ktt.GenDataSetFromArray(xq), cfg, bitset or ktt.BitsetView())
    assert res.has_value(), res.what()
    return res.value()


def _traced(fn):
    """(span records, profiler event names) of fn() under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return tracing.get_span_log(), {e.name for e in prof.events()}


def _check_requests(log, expected, n_requests):
    """Every span of `expected` in each request, under its parent; one root
    a request; waits flagged; returns the records by root id."""
    by_id = {r["id"]: r for r in log}
    roots = [r for r in log if r["parent"] is None]
    assert len(roots) == n_requests and {r["name"] for r in roots} == {"knowhere_search"}
    by_root = {r["id"]: [s for s in log if s["root"] == r["id"]] for r in roots}
    assert sum(len(v) for v in by_root.values()) == len(log)  # every span in one request
    for spans in by_root.values():
        assert {s["name"] for s in spans} == set(expected)
        for s in spans:
            parent = by_id.get(s["parent"])
            want = expected[s["name"]]
            assert (parent["name"] if parent else None) in (want if isinstance(want, tuple) else (want,)), s["name"]
            assert s["wait"] == (s["name"] in WAITS), s["name"]
            assert s["start_ns"] <= s["end_ns"]
            if parent:
                assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
                assert s["thread"] == parent["thread"]
    return by_root


def _counter(spans, name):
    return sum(s["counters"].get(name, 0) for s in spans)


def test_off_records_nothing_and_returns_the_shared_noop(ivf_pq, rows):
    assert not tracing.enabled()
    a, b = tracing.span("a"), tracing.span("b", wait=True, x=1)
    assert a is b
    with a:
        tracing.count("c", 3)
        tracing.count("c", torch.tensor(2))
        tracing.AddEvent("e")
    _search(ivf_pq, rows[1], {"metric_type": "L2", "k": 10, "nprobe": 4, "refine_k": 8})
    assert tracing.get_span_log() == [] and tracing.spans_dropped() == 0


def test_ivf_pq_spans_and_counters(ivf_pq, rows):
    cfg = {"metric_type": "L2", "k": 10, "nprobe": 4, "refine_k": 8}
    log, events = _traced(lambda: [_search(ivf_pq, rows[1][s:s + 20], cfg) for s in (0, 20)])
    by_root = _check_requests(log, IVF_SPANS, 2)
    assert set(IVF_SPANS) <= events  # each span is a host event of the profiler's trace
    for spans in by_root.values():
        launched = _counter(spans, "ivf_scan.tasks_launched")
        filled = _counter(spans, "ivf_scan.tasks_filled")
        assert 0 < filled <= launched
        assert [s["name"] for s in spans if s["counters"]] == ["ivf_scan.kernel"]


@pytest.mark.parametrize("case", ["plain", "filtered", "refine"])
def test_hnsw_spans_and_counters(hnsw, rows, case):
    idx = hnsw[1] if case == "refine" else hnsw[0]
    cfg = {"metric_type": "L2", "k": 10, "ef": 48}
    bitset = None
    if case == "filtered":  # 99% filtered: the exact fallback
        n = idx.Count()
        drop = np.arange(n) < int(0.99 * n)
        bitset = ktt.BitsetView(np.packbits(drop, bitorder="little"), n, int(drop.sum()))
        cfg = dict(cfg)
    if case == "refine":
        cfg = dict(cfg, refine_k=2)
    log, events = _traced(lambda: _search(idx, rows[1], cfg, bitset))
    expected = {"plain": HNSW_SPANS, "filtered": HNSW_FILTERED_SPANS, "refine": HNSW_REFINE_SPANS}[case]
    (spans,) = _check_requests(log, expected, 1).values()
    assert set(expected) <= events
    if case == "filtered":
        assert not any(s["counters"] for s in spans)
        return
    (walk,) = [s for s in spans if s["name"] == "graph_inline.walk"]
    c = walk["counters"]
    n_rows = 64  # 40 queries on the row ladder (pad_rows_ladder): the padded rows walk too
    W = 48 // 8  # the beam width at ef 48
    steps, rest = divmod(c["graph_inline.scored"], n_rows * W * idx.node._inline.deg)
    assert rest == 0 and steps >= 9  # whole steps, past the first done check
    assert 0 < c["graph_inline.fresh"] <= c["graph_inline.scored"]


def test_counters_sum_host_and_device_values():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("c", 3)
                tracing.count("c", torch.tensor(4))
                tracing.count("c", torch.tensor([5]).sum())
            tracing.count("d", 1)
    log = {r["name"]: r for r in tracing.get_span_log()}
    assert log["inner"]["counters"] == {"c": 12} and log["outer"]["counters"] == {"d": 1}
    assert tracing.get_span_log()[0]["counters"] == {"c": 12}  # a second read reads the same


def test_second_thread_span_is_recorded():
    seen = {}

    def other():
        seen["thread"] = threading.get_ident()
        with tracing.span("other.thread", wait=True, a=1):
            pass

    log, _ = _traced(lambda: _run(other))
    (rec,) = log
    assert rec["name"] == "other.thread" and rec["thread"] == seen["thread"] != threading.get_ident()
    assert rec["parent"] is None and rec["root"] == rec["id"] and rec["wait"] and rec["attrs"] == {"a": 1}


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_threads_share_the_store_without_losing_a_record(monkeypatch):
    """16 threads open nested spans at once through a store of 64 records
    with a short switch interval: every record is kept or counted dropped,
    and each thread's spans nest on its own stack."""
    import sys

    _fresh(monkeypatch, 64)
    tracing.init_telemetry(tracing.TraceConfig(exporter="stdout"))
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("c", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    log = tracing.get_span_log()
    assert len(log) == 64 and tracing.spans_dropped() == 2 * n_threads * n_spans - 64
    by_id = {r["id"]: r for r in log}
    for r in log:
        if r["name"] == "inner" and r["parent"] in by_id:
            assert by_id[r["parent"]]["thread"] == r["thread"] and by_id[r["parent"]]["name"] == "outer"
        assert (r["parent"] is None) == (r["name"] == "outer")
        assert r["counters"] == ({"c": 1} if r["name"] == "inner" else {})


def test_store_bound_and_dropped_count(monkeypatch):
    _fresh(monkeypatch, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with tracing.span(f"s{i}"):
                pass
    log = tracing.get_span_log()
    assert [r["name"] for r in log] == ["s6", "s7", "s8", "s9"]  # the newest kept
    assert tracing.spans_dropped() == 6


def test_exporter_turns_spans_on():
    tracing.init_telemetry(tracing.TraceConfig(exporter="stdout"))
    assert tracing.enabled()
    with tracing.span("exported", n=2):
        tracing.count("c", 1)
    (rec,) = tracing.get_span_log()
    assert rec["attrs"] == {"n": 2} and rec["counters"] == {"c": 1}
    tracing.init_telemetry(tracing.TraceConfig())
    assert not tracing.enabled()


def _hist_sum(name: str, index_type: str):
    """(count, sum) of a latency histogram, either backend."""
    h = metrics._registry._hists[name]
    if not metrics._HAS_PROM:
        counts, sums = metrics.get_fallback_buckets(name, index_type)
        return sum(counts), sum(sums)
    samples = {s.name: s.value for s in h.collect()[0].samples if s.labels.get("index_type") == index_type}
    return samples[f"{name}_count"], samples[f"{name}_sum"]


def test_search_latency_is_the_root_span_and_events_attach(ivf_pq, rows):
    name = "knowhere_torch_search_latency_seconds"
    cfg = {"metric_type": "L2", "k": 10, "nprobe": 4, "refine_k": 8}
    _search(ivf_pq, rows[1], cfg)  # the histogram exists
    n0, s0 = _hist_sum(name, "IVF_PQ")
    log, _ = _traced(lambda: _search(ivf_pq, rows[1], cfg))
    n1, s1 = _hist_sum(name, "IVF_PQ")
    (root,) = [r for r in log if r["parent"] is None]
    assert n1 == n0 + 1
    assert s1 - s0 == pytest.approx((root["end_ns"] - root["start_ns"]) / 1e9, rel=1e-9, abs=1e-12)
    assert root["attrs"]["k"] == 10 and root["attrs"]["nq"] == 40 and root["attrs"]["index"] == "IVF_PQ"

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("with.event"):
            tracing.AddEvent("hello")
    (rec,) = tracing.get_span_log()[-1:]
    ((text, t),) = rec["events"]
    assert text == "hello" and rec["start_ns"] <= t <= rec["end_ns"]


def test_fallback_histogram_keeps_buckets_not_observations():
    h = metrics._FallbackHistogram()
    for v in (0.0005, 0.001, 0.002, 7.0, 1e6):
        h.observe(v)
    assert len(h.counts) == len(metrics._BUCKETS) + 1
    assert h.counts[0] == 2 and h.counts[1] == 1 and h.counts[metrics._BUCKETS.index(10)] == 1 and h.counts[-1] == 1
    assert h.sums[0] == pytest.approx(0.0015) and h.sums[-1] == 1e6
    for _ in range(1000):
        h.observe(0.2)
    assert len(h.counts) == len(metrics._BUCKETS) + 1 and sum(h.counts) == 1005
