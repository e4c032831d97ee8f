"""The trace reading on events built by hand: busy time as a union, the idle
gaps by host op, and each device operation tied to its request by its
launch."""

from types import SimpleNamespace as NS

import pytest

from ann_bench import profile


def ev(name, start, end, thread=1, device=False, id=0, user=None):
    return NS(name=name, time_range=NS(start=start, end=end), thread=thread, id=id,
              device_type=NS(name="CUDA" if device else "CPU"), is_user_annotation=user)


def test_union_intervals():
    import numpy as np

    got = profile.union_intervals(np.array([0.0, 5.0, 2.0, 20.0]), np.array([3.0, 8.0, 6.0, 25.0]))
    assert got == [(0.0, 8.0), (20.0, 25.0)]


def build():
    """Two clients (threads 1 and 2) over a 100 us window. Client 1's
    request 0 (10-50) launches an aten kernel inside `graph_inline.walk` and
    two ctypes kernels, whose runtime calls carry a thread id no client has
    (900); client 2's request 1 (15-60) launches one kernel and, after
    request 0 ended, a ctypes kernel (901); request 2 began before the
    window."""
    return [
        ev("ann_bench.request.0", 10, 50, thread=1, user=True),
        ev("graph_inline.walk", 12, 30, thread=1, user=True),
        ev("aten::mm", 13, 14, thread=1, user=False),
        ev("cudaLaunchKernel", 13.5, 13.9, thread=1, id=501, user=False),
        ev("cudaLaunchKernel", 31, 31.5, thread=900, id=502, user=False),
        ev("ann_bench.request.1", 15, 60, thread=2, user=True),
        ev("cudaLaunchKernel", 16, 16.5, thread=2, id=503, user=False),
        ev("cudaLaunchKernel", 40, 40.5, thread=900, id=504, user=False),
        ev("cudaLaunchKernel", 52, 52.5, thread=901, id=505, user=False),
        ev("ann_bench.request.2", -5, 20, thread=3, user=True),
        ev("void gemm", 20, 40, device=True, id=501),
        ev("void kw::ivf_adc_scan_kernel<8>", 45, 48, device=True, id=502),
        ev("void add", 30, 35, device=True, id=503),
        ev("void kw::ivf_adc_scan_kernel<8>", 49, 50, device=True, id=504),
        ev("void kw::ivf_adc_scan_kernel<8>", 53, 55, device=True, id=505),
        ev("graph_inline.walk", 20, 40, device=True),  # the range's annotation on the device
    ]


def test_busy_is_the_union_and_annotations_are_not_operations():
    tr = profile.analyze(build(), 100e-6)
    assert tr.busy_s == pytest.approx(26e-6)  # [20, 40] + [45, 48] + [49, 50] + [53, 55]
    assert tr.idle_pct == pytest.approx(74.0)
    assert dict(tr.device_ops) == pytest.approx({"void gemm": 20e-6, "void add": 5e-6,
                                                 "void kw::ivf_adc_scan_kernel<8>": 6e-6})


def test_operations_by_request_and_range():
    tr = profile.analyze(build(), 100e-6)
    assert set(tr.requests) == {0, 1}  # request 2 began before the window
    ops0 = {name: (dur, ranges) for name, dur, ranges in tr.requests[0]}
    assert ops0["void gemm"][0] == pytest.approx(20e-6) and ops0["void gemm"][1] == ("graph_inline.walk",)
    # thread 900's launches fell while both requests were open: no client's thread, left out
    assert not [n for n, _, _ in tr.requests[0] if "adc" in n]
    # 901's fell while request 1 alone was open: its own
    assert [n for n, _, _ in tr.requests[1]] == ["void add", "void kw::ivf_adc_scan_kernel<8>"]
    nq = 1000
    walk = profile.device_ms_per_kq(tr, nq, lambda name, ranges: "graph_inline.walk" in ranges)
    one = profile.analyze([e for e in build() if e.thread != 2 and e.id not in (503, 505)], 100e-6)
    adc = "void kw::ivf_adc_scan_kernel<8>"
    assert [n for n, _, _ in one.requests[0]] == ["void gemm", adc, adc]  # one client: every launch is its own
    assert walk == pytest.approx(20e-3 / 2)  # 0.02 ms over 2 requests of 1,000 queries
    assert profile.device_ms_per_kq(tr, nq, lambda name, ranges: "hnsw.brute_force" in ranges) is None


def test_idle_gaps_named_by_the_innermost_host_op():
    tr = profile.analyze(build(), 100e-6)
    gaps = dict(tr.idle_gaps)
    # gaps [0, 20], [40, 45], [48, 49], [50, 53] fall inside requests, between host ops; [55, 100] in none
    assert gaps == pytest.approx({"(no host op)": 45e-6, "(host code inside Search, between ops)": 29e-6})
