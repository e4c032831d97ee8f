"""ivf_path_ms_per_kq: device ms of every operation outside the port's own
`kw::` kernels (the coarse probe, task build, merge and refine of
ops/ivf_scan.py, ops/refine.py and models/ivf.py, and the copies) per
1,000 queries of the profiled part's complete requests."""

from ann_bench.profile import device_ms_per_kq


def read(ctx):
    return device_ms_per_kq(ctx.trace, ctx.nq, lambda name, ranges: "kw::" not in name)
