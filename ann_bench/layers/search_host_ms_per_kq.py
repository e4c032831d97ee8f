"""search_host_ms_per_kq: host ms of the program's Search per 1,000 queries
of the profiled part's complete requests: each request's root span
(`knowhere_search`, index.py) less its outermost wait spans (readbacks and
the walk's done checks, where the host blocks on the device), from the
program's span store (spans.py)."""

from ann_bench import spans


def read(ctx):
    reqs = spans.request_spans(ctx)
    if not reqs:
        return None
    ms = sum(spans.host_ns(s) for s in reqs.values()) / 1e6
    return ms / (len(reqs) * ctx.nq / 1000.0)
