"""walk_ms_per_kq: device ms under the `graph_inline.walk` range (the HNSW
inline walk, ops/graph_inline.py) per 1,000 queries of the profiled part's
complete requests."""

from ann_bench.profile import device_ms_per_kq


def read(ctx):
    return device_ms_per_kq(ctx.trace, ctx.nq, lambda name, ranges: "graph_inline.walk" in ranges)
