"""adc_scan_roofline_pct: the least time the card could take for the ADC
work of the profiled part's complete requests (roofline.py, counted from
IVF_PQ's algorithm with the benchmark's own coarse probe over the index's
centroids) over the ADC kernel's device time in them, in percent."""

import numpy as np
import torch

from ann_bench import roofline
from ann_bench.layers.adc_scan_ms_per_kq import ADC_KERNEL


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.requests:
        return None
    kernel_s = {i: sum(d for name, d, _ in ops if ADC_KERNEL in name) for i, ops in tr.requests.items()}
    if sum(kernel_s.values()) <= 0:
        return None
    import knowhere_tpu_torch as kt

    bs = kt.BinarySet()
    if ctx.index.Serialize(bs) != kt.Status.success:
        return None
    data = bs.GetByName(ctx.workload.config["index_type"]).data
    arrays, meta = roofline.read_sections(data.tobytes() if isinstance(data, np.ndarray) else bytes(data))
    sizes = arrays["lengths"] if "lengths" in arrays else np.diff(arrays["offsets"])
    m, ksub, _ = arrays["pq_codebooks"].shape
    dev = ctx.device
    centroids = torch.from_numpy(np.array(arrays["centroids"], dtype=np.float32)).to(dev)
    sizes_t = torch.from_numpy(np.array(sizes, dtype=np.int64)).to(dev)
    s = ctx.search_cfg
    n_out = int(s["k"]) * int(s.get("refine_k", 1))
    blocks = {r["i"]: r["block"] for r in ctx.records}
    least = 0.0
    for i, t in kernel_s.items():
        if t <= 0:
            continue
        block = blocks[i]
        xq = torch.from_numpy(ctx.pool[block * ctx.nq : (block + 1) * ctx.nq]).to(dev)
        least += roofline.adc_request_bound_s(xq, centroids, sizes_t, int(s["nprobe"]), int(m), int(ksub),
                                              int(meta["pq_nbits"]), n_out)
    return 100.0 * least / sum(kernel_s.values())
