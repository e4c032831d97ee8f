"""The program's span records (knowhere_tpu_torch/utils/tracing.py) of the
profiled part's complete requests, for the per-layer readers that read
spans and counters.

A request of the trace (a key of `ctx.trace.requests`: it began and ended
inside the profiled part) owns the one root span (`knowhere_search` or
`knowhere_range_search`, no parent) that its Search opened between its
record's `t_send` and `t_ans`; both clocks are `time.perf_counter`. The
program's spans are on while the profiler runs, so the store holds the
profiled part's. Where windows overlap (several clients), a root inside
several windows goes to the one request left without another: each of the
trace's requests has exactly one root, and every root lies in its own
request's window. A span whose Search opened before the profiler started
has no parent either; it is no root and belongs to no request.

The readers read nothing (None) unless every request of the trace was
given one root this way and the store dropped no record: a subset of the
requests, or a request missing some of its spans, would read biased. A
program without the store, or whose records carry no root (an older
program), matches no request, and the readers return None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

FIELDS = {"id", "name", "parent", "root", "start_ns", "end_ns", "wait", "counters"}
ROOTS = ("knowhere_search", "knowhere_range_search")


def request_spans(ctx) -> Dict[int, List[dict]]:
    """Request index -> the span records of its Search (root first), or {}
    where any request of the trace has no root of its own."""
    tr = ctx.trace
    if tr is None or not tr.requests:
        return {}
    try:
        from knowhere_tpu_torch.utils import tracing

        log = tracing.get_span_log()
        if tracing.spans_dropped():
            return {}
    except (ImportError, AttributeError):
        return {}
    recs = [r for r in log if isinstance(r, dict) and FIELDS <= r.keys()]
    roots = {r["id"]: r for r in recs if r["parent"] is None and r["name"] in ROOTS}
    windows = {r["i"]: (r["t_send"] * 1e9, r["t_ans"] * 1e9) for r in ctx.records}
    if not set(tr.requests) <= windows.keys():
        return {}

    def inside(root, i):
        s, e = windows[i]
        return s <= root["start_ns"] and root["end_ns"] <= e

    owners = {rid: {i for i in windows if inside(r, i)} for rid, r in roots.items()}
    owners = {rid: o for rid, o in owners.items() if o}  # a root in no window is no request's
    cands = {i: {rid for rid, o in owners.items() if i in o} for i in tr.requests}
    root_of: Dict[int, int] = {}  # request -> root id
    changed = True
    while changed:  # settle what only one assignment allows
        changed = False
        taken = set(root_of.values())
        for i, c in cands.items():  # a request of the trace with one root left
            left = c - taken
            if i not in root_of and len(left) == 1:
                root_of[i] = left.pop()
                taken.add(root_of[i])
                changed = True
        for rid, o in owners.items():  # a root with one request left
            left = o - root_of.keys()
            if rid not in taken and len(left) == 1:
                root_of[left.pop()] = rid
                taken.add(rid)
                changed = True
    if not all(i in root_of for i in tr.requests):
        return {}
    members: Dict[int, List[dict]] = defaultdict(list)
    for r in recs:
        members[r["root"]].append(r)
    return {i: [roots[root_of[i]]] + [r for r in members[root_of[i]] if r["parent"] is not None]
            for i in tr.requests}


def host_ns(spans: List[dict]) -> int:
    """A request's root span less its outermost wait spans (a wait inside a
    wait is counted once)."""
    by_id = {r["id"]: r for r in spans}

    def under_wait(r) -> bool:
        p = by_id.get(r["parent"])
        while p is not None:
            if p["wait"]:
                return True
            p = by_id.get(p["parent"])
        return False

    root = spans[0]
    waits = sum(r["end_ns"] - r["start_ns"] for r in spans if r["wait"] and not under_wait(r))
    return root["end_ns"] - root["start_ns"] - waits


def counter(reqs: Dict[int, List[dict]], name: str) -> int:
    """A counter summed over the requests' spans."""
    return sum(int(r["counters"].get(name, 0)) for spans in reqs.values() for r in spans)


def counter_pct(ctx, part: str, whole: str):
    """100 x counter `part` / counter `whole` over the profiled part's
    complete requests, or None where `whole` counted nothing."""
    reqs = request_spans(ctx)
    total = counter(reqs, whole)
    if total <= 0:
        return None
    return 100.0 * counter(reqs, part) / total
