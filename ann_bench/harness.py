"""One run of one cell: set-up, the measured window, the reference, the result.

Set-up draws the corpus and, from the seed, the query pool (`data.py`), sets
the precision Milvus's query node sets at start-up
(`KnowhereConfig.SetSimdType`), builds the index through the factory, and
warms up with the cell's own request shape. The window is a closed loop of
`clients` threads: each sends its next `Index.Search` as soon as its last
one returns, with a fresh `DataSet` (and a fresh `BitsetView` where the cell
filters) for every request, cycling through the pool's blocks. A request
sent before the window's length has passed is waited for; the window closes
at the last answer. Once it has closed and the peak of device memory is
read, the per-layer readers run, the index is freed, and the reference
judges every answer (`check.py`).
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, data, reference
from .profile import REQUEST_PREFIX, Trace, analyze
from .spec import Workload

WARMUP_ROUNDS = 2  # rounds of `clients` requests in flight before the window
TRACE_START = 0.3  # the profiled part starts at this share of the window


@dataclass
class Context:
    """What a per-layer reader reads."""

    workload: Workload
    trace: Optional[Trace]
    build_s: float
    nq: int
    records: List[dict]  # the window's requests: i, block, t_send, t_ans, ids, dists, error
    pool: np.ndarray  # (blocks * nq, dim) f32: block b is rows [b * nq, (b + 1) * nq)
    index: object  # the program's index, still built
    search_cfg: dict
    device: torch.device


def build_index(kt, xb: np.ndarray, config: dict, build_cfg: dict):
    """The program's index, created by the factory and built on xb."""
    made = kt.IndexFactory.Instance().Create(config["index_type"])
    if not made.has_value():
        raise RuntimeError(f"Create({config['index_type']}): {made.error().name}")
    idx = made.value()
    st = idx.Build(kt.GenDataSetFromArray(xb), build_cfg)
    if st != kt.Status.success:
        raise RuntimeError(f"Build: {st.name}")
    return idx


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    workload: Workload,
    seed: int,
    seconds: float,
    trace: bool,
    device: str,
    t_start: float,
    readers: Optional[Dict[str, Callable]] = None,
    index_factory: Optional[Callable] = None,
) -> dict:
    """The result of one run (run.py prints it); the harness's stages in order."""
    import knowhere_tpu_torch as kt

    dev = torch.device(device)
    config, cell = workload.config, workload.cell
    kt.set_device(dev)
    kt.KnowhereConfig.SetSimdType(config["simd_type"])
    nb, nq, k, blocks = int(config["nb"]), int(cell["nq"]), int(cell["k"]), int(cell["pool_blocks"])
    clients = int(cell["clients"])

    xb, pool = data.mixture(config["corpus"], nb, blocks * nq, seed)
    keep = data.keep_mask(nb, cell.get("filter"))
    packed = None if keep is None else np.packbits(~keep, bitorder="little")
    n_filtered = 0 if keep is None else int((~keep).sum())
    order = data.request_order(blocks, seed)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    build_cfg = dict(config["build"], metric_type=config["metric"])
    t = time.perf_counter()
    idx = (index_factory or build_index)(kt, xb, config, build_cfg)
    _sync(dev)
    build_s = time.perf_counter() - t
    search_cfg = dict(config["search"], metric_type=config["metric"], k=k)

    def request(i: int) -> dict:
        block = int(order[i % blocks])
        ds = kt.GenDataSetFromArray(pool[block * nq : (block + 1) * nq])
        bs = kt.BitsetView() if packed is None else kt.BitsetView(packed.copy(), nb, n_filtered)
        t_send = time.perf_counter()
        try:
            with torch.profiler.record_function(f"{REQUEST_PREFIX}{i}"):
                res = idx.Search(ds, search_cfg, bs)
        except Exception as e:  # a request that raises is a failed request; the client goes on
            res = None
            err = f"{type(e).__name__}: {e}"
        t_ans = time.perf_counter()
        rec = {"i": i, "block": block, "t_send": t_send, "t_ans": t_ans, "error": None}
        if res is None:
            rec["error"] = err
        elif res.has_value():
            rec["ids"] = res.value().ids.reshape(nq, k)
            rec["dists"] = res.value().distance.reshape(nq, k)
        else:
            rec["error"] = f"{res.error().name}: {res.what()}"
        return rec

    for r in range(WARMUP_ROUNDS):
        warm = _in_threads([lambda i=i: request(i) for i in range(r * clients, (r + 1) * clients)])
        errors = [w["error"] for w in warm if w["error"]]
        if errors:
            raise RuntimeError(f"warm-up Search failed: {errors[0]}")
    del warm
    gc.collect()
    _sync(dev)
    index_device_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9 if cuda else None
    setup_s = time.perf_counter() - t_start

    # --- the window ---------------------------------------------------------
    records: List[dict] = []
    lock = threading.Lock()
    next_i = [0]
    t0 = time.perf_counter()

    def client() -> None:
        while True:
            with lock:
                if time.perf_counter() - t0 >= seconds:
                    return
                i = next_i[0]
                next_i[0] += 1
            rec = request(i)
            with lock:
                records.append(rec)

    threads = [threading.Thread(target=client, name=f"client{c}") for c in range(clients)]
    for th in threads:
        th.start()
    prof = None
    try:
        if trace:
            prof = _profile(t0, seconds, float(cell["trace_seconds"]), cuda)
    finally:
        for th in threads:
            th.join()
    prof_trace = analyze(*prof) if trace else None
    records.sort(key=lambda r: r["i"])
    t_end = max(r["t_ans"] for r in records)
    window_s = t_end - t0
    ok = [r for r in records if r["error"] is None]
    failed = len(records) - len(ok)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    metrics = {
        "qps": (len(ok) * nq / window_s, "queries/s"),
        "latency_p95_ms": (check.p95([(r["t_ans"] - r["t_send"]) * 1e3 for r in records]), "ms"),
        "setup_s": (setup_s, "s"),
    }
    if index_device_gb is not None:
        metrics["index_device_gb"] = (index_device_gb, "GB")

    layer_values = {}
    if trace:
        ctx = Context(workload, prof_trace, build_s, nq, records, pool, idx, search_cfg, dev)
        for name, read in (readers or {}).items():
            v = read(ctx)
            if v is not None:
                layer_values[name] = float(v)
        del ctx

    # --- the reference, once the program's state is freed -------------------
    del idx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    xb_t = torch.from_numpy(xb).to(dev)
    pool_t = torch.from_numpy(pool).to(dev)
    keep_t = None if keep is None else torch.from_numpy(keep).to(dev)
    truth = {
        b: reference.knn(pool_t[b * nq : (b + 1) * nq], xb_t, k, keep_t)[1]
        for b in sorted({r["block"] for r in ok})
    }
    numbers = check.judge([(r["block"], r["ids"], r["dists"]) for r in ok], pool_t, nq, xb_t, keep_t, truth, k, seed)
    metrics["recall_at_10"] = (numbers["recall_at_10"], "ratio")
    correct, checks = check.verdict(numbers, failed, cell["limits"])

    wanted = {m["name"] for m in (workload.per_layer if trace else workload.end_to_end)}
    source = layer_values if trace else {n: v for n, (v, _) in metrics.items()}
    units = {m["name"]: m["unit"] for m in workload.per_layer + workload.end_to_end}
    out_metrics = {n: {"value": float(source[n]), "unit": units[n]} for n in sorted(wanted) if n in source}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": workload.chips,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed, "metrics": out_metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = prof_trace.busy_s
        device_info["window_s"] = prof_trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in prof_trace.device_ops],
                               "idle_gaps": [list(x) for x in prof_trace.idle_gaps]}
    result["checks"] = checks
    return result


def _in_threads(fns: List[Callable]) -> list:
    """Run fns at once, one thread each; their results in order."""
    out = [None] * len(fns)
    errors = []

    def call(j):
        try:
            out[j] = fns[j]()
        except BaseException as e:  # re-raised on the calling thread below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(j,)) for j in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _profile(t0: float, seconds: float, trace_seconds: float, cuda: bool):
    """(events, seconds) of a profile of every thread from TRACE_START of the
    window for trace_seconds (at most half the window)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    length = min(trace_seconds, 0.5 * seconds)
    time.sleep(max(0.0, t0 + TRACE_START * seconds - time.perf_counter()))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    p0 = time.perf_counter()
    time.sleep(length)
    p1 = time.perf_counter()
    prof.stop()
    return prof.events(), p1 - p0
