"""brute_force_ms_per_kq: device ms under the `hnsw.brute_force` range (the
exact fallback of models/hnsw.py over ops/topk.knn_device) per 1,000
queries of the profiled part's complete requests."""

from ann_bench.profile import device_ms_per_kq


def read(ctx):
    return device_ms_per_kq(ctx.trace, ctx.nq, lambda name, ranges: "hnsw.brute_force" in ranges)
