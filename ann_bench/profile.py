"""Reading a torch.profiler trace of a steady part of the window.

- Busy time is the union of the device operations' intervals, so two
  clients' work in flight is never counted twice (`chip_smoke._profile_search`
  summed the kernels' times over one call). The idle share is one less the
  busy time over the profiled part.
- A request is the harness's own range `ann_bench.request.<i>` around one
  Search. Only requests that began and ended inside the profiled part are
  read. Each device operation is tied to its launch, the CUDA runtime call
  with the same correlation id, and so to the moment it was launched: it
  belongs to the request open then, and is listed with the names of the
  ranges open there (`graph_inline.walk`, `hnsw.brute_force`, ...), which
  the per-layer readers select from. With several clients in flight the
  launch's thread picks among their requests; the port's ctypes launches
  (its `kw::` kernels) run outside any PyTorch op and the tracer gives them
  no client's thread, so such a launch is left out where more than one
  request is open. Every cell today runs one client.
- `breakdown`: the device operations that took the most time, and the idle
  time of the longest gaps, each gap named by the innermost host range or op
  open at its middle, on any thread.

The ranges a kernel runs under also appear on the device's timeline as
annotations; an event on the device whose name is a host event's name is
such an annotation and is no device operation.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

REQUEST_PREFIX = "ann_bench.request."
RUNTIME_PREFIXES = ("cuda", "cu")  # the CUDA API calls that launch or copy: cudaLaunchKernel, cuLaunchKernel, ...
GAPS_NAMED = 200  # the longest gaps whose host op is looked up


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # (name, seconds), most first
    idle_gaps: List[Tuple[str, float]]  # (host op at the gap, seconds), most first
    # request index -> [(device op name, seconds, names of the ranges open at its launch)]
    requests: Dict[int, List[Tuple[str, float, Tuple[str, ...]]]] = field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def union_intervals(starts: np.ndarray, ends: np.ndarray) -> List[Tuple[float, float]]:
    """Merged intervals of [starts[i], ends[i]), sorted."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(zip(starts.tolist(), ends.tolist())):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) in ("CUDA", "PrivateUse1")


def analyze(events, window_s: float) -> Trace:
    """The Trace of a profile's events (`prof.events()`); window_s is the
    profiled part's length on the host's clock. Times in the events are
    microseconds from the profile's start."""
    cpu = [e for e in events if not _is_device(e)]
    host_names = {e.name for e in cpu}
    dev = [e for e in events if _is_device(e) and e.name not in host_names]
    w_us = window_s * 1e6
    starts = np.array([min(max(e.time_range.start, 0.0), w_us) for e in dev], dtype=np.float64)
    ends = np.array([min(max(e.time_range.end, 0.0), w_us) for e in dev], dtype=np.float64)
    merged = union_intervals(starts, ends)
    busy_us = sum(e - s for s, e in merged)

    per_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        per_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]

    edges = [0.0] + [x for iv in merged for x in iv] + [w_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    c_start = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    c_end = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    is_req = [e.name.startswith(REQUEST_PREFIX) for e in cpu]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps[:GAPS_NAMED]:
        mid = 0.5 * (g0 + g1)
        open_ = np.nonzero((c_start <= mid) & (c_end >= mid))[0]
        inner = [j for j in open_ if not is_req[j]]
        if inner:
            name = cpu[max(inner, key=lambda j: c_start[j])].name
        else:
            name = "(host code inside Search, between ops)" if len(open_) else "(no host op)"
        idle[name] += (g1 - g0) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    requests = _by_request(cpu, dev, w_us)
    return Trace(window_s=window_s, busy_s=busy_us / 1e6, device_ops=device_ops, idle_gaps=idle_gaps,
                 requests=requests)


def _is_range(e) -> bool:
    """A range the program or the harness opened (record_function)."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag) if flag is not None else ("." in e.name and not e.name.startswith(("aten::", "cu")))


def _by_request(cpu, dev, w_us: float) -> Dict[int, List[Tuple[str, float, Tuple[str, ...]]]]:
    runtime = {e.id: e for e in cpu if e.name.startswith(RUNTIME_PREFIXES)}
    reqs = [(e.time_range.start, e.time_range.end, int(e.name[len(REQUEST_PREFIX):]), e.thread) for e in cpu
            if e.name.startswith(REQUEST_PREFIX) and e.time_range.start >= 0 and e.time_range.end <= w_us]
    ranges: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)  # thread -> its ranges
    for e in cpu:
        if _is_range(e) and not e.name.startswith(REQUEST_PREFIX):
            ranges[e.thread].append((e.time_range.start, e.time_range.end, e.name))

    out: Dict[int, List[Tuple[str, float, Tuple[str, ...]]]] = {i: [] for _, _, i, _ in reqs}
    for d in dev:
        r = runtime.get(d.id)
        if r is None:
            continue
        t = r.time_range.start
        open_ = [q for q in reqs if q[0] <= t <= q[1]]
        if len(open_) > 1:  # several clients in flight: the launching thread's request
            open_ = [q for q in open_ if q[3] == r.thread]
        if len(open_) != 1:
            continue
        _, _, i, thread = open_[0]
        names = tuple(n for s0, s1, n in ranges.get(thread, ()) if s0 <= t <= s1)
        out[i].append((d.name, (d.time_range.end - d.time_range.start) / 1e6, names))
    return out


def device_ms_per_kq(trace: Trace, nq: int, select) -> float | None:
    """Device ms of the selected operations of the profile's complete
    requests per 1,000 of their queries, or None where none was selected.
    select(op name, ranges) -> bool."""
    if not trace or not trace.requests:
        return None
    ms = [dur * 1e3 for ops in trace.requests.values() for name, dur, ranges in ops if select(name, ranges)]
    if not ms:
        return None
    return sum(ms) / (len(trace.requests) * nq / 1000.0)
