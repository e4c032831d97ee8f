"""The span and counter readers (spans.py, layers/search_host_ms_per_kq.py,
adc_task_fill_pct.py, walk_fresh_pct.py) on span logs built by hand: a
request outside the profiled part is left out, a wait inside a wait is
subtracted once, overlapping requests each get their own root, a span
opened before the profiler is no request's, and each reader returns None
where the program recorded no spans, spans of the older form, not one root
for every request, or a store that dropped records."""

from types import SimpleNamespace as NS

import pytest

from ann_bench import spans, spec
from ann_bench.profile import Trace

MS = 1_000_000  # ns


def rec(id, name, start, end, parent=None, root=None, wait=False, **counters):
    return {"id": id, "name": name, "parent": parent, "root": root or id, "thread": 1, "start_ns": start * MS,
            "end_ns": end * MS, "wait": wait, "attrs": {}, "counters": counters, "events": []}


def log():
    """Request 0 (10-40 ms): a 28 ms root with a 6 ms readback (wait) that
    holds a 2 ms wait, and a walk with a 3 ms done check (wait). Request 1
    (50-70 ms): a 15 ms root with no wait. Request 2 (80-95 ms) ran outside
    the profiled part: its spans are left out."""
    return [
        rec(1, "knowhere_search", 11, 39),
        rec(2, "ivf.readback", 20, 26, parent=1, root=1, wait=True),
        rec(3, "hnsw.readback", 21, 23, parent=2, root=1, wait=True),
        rec(4, "graph_inline.walk", 27, 35, parent=1, root=1, **{"graph_inline.fresh": 30,
                                                                "graph_inline.scored": 100}),
        rec(5, "graph_inline.done_check", 30, 33, parent=4, root=1, wait=True),
        rec(6, "ivf_scan.kernel", 28, 29, parent=1, root=1, **{"ivf_scan.tasks_filled": 5,
                                                             "ivf_scan.tasks_launched": 8}),
        rec(10, "knowhere_search", 52, 67),
        rec(11, "ivf_scan.kernel", 55, 60, parent=10, root=10, **{"ivf_scan.tasks_filled": 3,
                                                                "ivf_scan.tasks_launched": 8}),
        rec(20, "knowhere_search", 81, 94),
        rec(21, "ivf_scan.kernel", 82, 90, parent=20, root=20, **{"ivf_scan.tasks_filled": 0,
                                                                "ivf_scan.tasks_launched": 100}),
    ]


WINDOWS = [(0.010, 0.040), (0.050, 0.070), (0.080, 0.095)]  # s


def ctx(nq=1000, requests=(0, 1), windows=WINDOWS):
    records = [{"i": i, "t_send": s, "t_ans": e} for i, (s, e) in enumerate(windows)]
    trace = Trace(window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[], requests={i: [] for i in requests})
    return NS(trace=trace, records=records, nq=nq)


@pytest.fixture
def store(monkeypatch):
    from knowhere_tpu_torch.utils import tracing

    held = {"log": log(), "dropped": 0}
    monkeypatch.setattr(tracing, "get_span_log", lambda: held["log"])
    monkeypatch.setattr(tracing, "spans_dropped", lambda: held["dropped"])
    return held


def read(name, c):
    return spec.load_reader(name)(c)


def test_requests_are_matched_by_their_window(store):
    reqs = spans.request_spans(ctx())
    assert sorted(reqs) == [0, 1]  # request 2 is not among the trace's requests
    assert [r["id"] for r in reqs[0]][0] == 1 and {r["id"] for r in reqs[0]} == {1, 2, 3, 4, 5, 6}
    assert {r["id"] for r in reqs[1]} == {10, 11}


def test_host_ms_subtracts_outermost_waits_once(store):
    # request 0: 28 - 6 (the readback; its inner wait not again) - 3 = 19 ms; request 1: 15 ms
    assert read("search_host_ms_per_kq", ctx()) == pytest.approx((19 + 15) / 2)
    assert read("search_host_ms_per_kq", ctx(nq=500)) == pytest.approx((19 + 15) / 1)


def test_counter_shares_over_the_requests_only(store):
    assert read("adc_task_fill_pct", ctx()) == pytest.approx(100 * 8 / 16)  # request 2's 100 empty left out
    assert read("walk_fresh_pct", ctx()) == pytest.approx(30.0)
    assert read("walk_fresh_pct", ctx(requests=(1,))) is None  # no walk in request 1


@pytest.mark.parametrize("held", [[], [{"name": "knowhere_search", "elapsed": 0.028, "k": 10}]])
def test_readers_return_none_without_spans(store, held):
    store["log"] = held  # no spans, or the older store's {name, elapsed} records
    for name in ("search_host_ms_per_kq", "adc_task_fill_pct", "walk_fresh_pct"):
        assert read(name, ctx()) is None


def test_readers_return_none_without_a_trace(store):
    c = ctx()
    c.trace = None
    assert read("search_host_ms_per_kq", c) is None and read("adc_task_fill_pct", c) is None


def test_overlapping_requests_each_get_their_own_root(store):
    """Request 1 (12-41 ms) overlaps request 0 (10-40): its root (30-38)
    lies in both windows, request 0's (11-39) in its own only, so each
    request is left one root. Two roots inside both windows could be
    either's: nothing is read."""
    store["log"] = [
        rec(1, "knowhere_search", 11, 39),
        rec(2, "ivf_scan.kernel", 12, 13, parent=1, root=1, **{"ivf_scan.tasks_filled": 5,
                                                             "ivf_scan.tasks_launched": 8}),
        rec(3, "knowhere_search", 30, 38),
        rec(4, "ivf_scan.kernel", 31, 32, parent=3, root=3, **{"ivf_scan.tasks_filled": 1,
                                                             "ivf_scan.tasks_launched": 8}),
    ]
    c = ctx(windows=[(0.010, 0.040), (0.012, 0.041)])
    reqs = spans.request_spans(c)
    assert [r["id"] for r in reqs[0]] == [1, 2] and [r["id"] for r in reqs[1]] == [3, 4]
    assert read("adc_task_fill_pct", c) == pytest.approx(100 * 6 / 16)
    store["log"][0] = rec(1, "knowhere_search", 13, 39)  # now inside both windows too
    assert spans.request_spans(c) == {} and read("adc_task_fill_pct", c) is None


def test_span_opened_before_the_profiler_is_no_request(store):
    """Request 0's Search began before the profiler: its root was off, and
    its later scan span has no parent. It closes inside request 1's window
    (14-41 ms, overlapping) before request 1's root does, and must neither
    take request 1's place nor count."""
    store["log"] = [
        rec(5, "ivf.scan", 22, 25, **{"ivf_scan.tasks_filled": 0, "ivf_scan.tasks_launched": 100}),
        rec(1, "knowhere_search", 16, 39),
        rec(2, "ivf_scan.kernel", 17, 18, parent=1, root=1, **{"ivf_scan.tasks_filled": 5,
                                                             "ivf_scan.tasks_launched": 8}),
    ]
    c = ctx(requests=(1,), windows=[(0.001, 0.021), (0.014, 0.041)])
    reqs = spans.request_spans(c)
    assert list(reqs) == [1] and [r["id"] for r in reqs[1]] == [1, 2]
    assert read("adc_task_fill_pct", c) == pytest.approx(100 * 5 / 8)
    assert read("search_host_ms_per_kq", c) == pytest.approx(23.0)


def test_readers_return_none_unless_every_request_has_its_spans(store):
    c = ctx(requests=(0, 1, 2))
    assert read("search_host_ms_per_kq", c) is not None
    store["log"] = [r for r in log() if r["root"] != 10]  # request 1's spans are gone
    assert spans.request_spans(c) == {} and read("search_host_ms_per_kq", c) is None
    store["log"], store["dropped"] = log(), 1  # the store dropped a record: some request may miss spans
    for name in ("search_host_ms_per_kq", "adc_task_fill_pct", "walk_fresh_pct"):
        assert read(name, c) is None
