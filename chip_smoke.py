#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (knowhere_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU. In order:

1. require a CUDA device and print the card's name and power limit;
2. build the CUDA kernels from knowhere_tpu_torch/csrc (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time both (the int8 scan also with a
   quarter of its tasks empty, at 32-query groups, at d=256 and on a
   heavy-tie corpus, every position equal; the f32 scan also at the HNSW
   build's per-launch shape, 8,192 tasks at kk=32; FLAT phase 1 also as its
   group-max and select launches apart, beside an f32 yardstick; the ADC
   scan at every width it compiles, and its shared-memory figure against
   the wrapper's);
4. run the main path through the public API on the SIFT1M-like corpus
   (1M x 128 f32, 10,000 queries, seed 0): FLAT exact ground truth, its
   first 1,000 queries' ids held against an independent full-f32 answer
   (torch.matmul + torch.topk) and its warm search time, IVF_FLAT
   (nlist=1024, L2) FAST search at nprobe=12, k=10, recall@10 and warm QPS,
   a 50% bitset search, a Serialize/Deserialize round trip, and the same
   index served by the f32 scan (KNOWHERE_DISABLE_INT8_SCAN=1), its recall
   and warm QPS;
5. IVF_PQ at the north-star configuration on the same corpus (nlist=1024,
   m=16, nbits=8, OPQ, FP16 refine with refine_k=8, FAST, nprobe=12, k=10):
   recall@10 against the FLAT truth and warm QPS, a 50% bitset search, a
   Serialize/Deserialize round trip, and an EXACT-precision search of the
   first 1,000 queries (the plain decode scan) that FAST must come within
   0.01 recall of;
6. IVF_SQ8 on the SIFT1M-like corpus (nlist=1024, sq_type SQ8, FAST,
   nprobe=16, k=10; the bench's SQ8 leg): served by the int8 scan over the
   u8 codes with an SQ8-decode rerank; recall@10 against the FLAT truth,
   warm QPS, a 50% bitset search, a Serialize/Deserialize round trip,
   EXACT on the first 1,000 queries; then the same BinarySet loaded with
   KNOWHERE_DISABLE_INT8_SCAN=1, served by the SQ scan kernel, its recall,
   warm QPS and one torch-profiler pass over one search;
7. IVF_RABITQ on the same corpus (nlist=1024, raw refine, FAST, nprobe=16,
   refine_k=8, k=10): served by the RaBitQ scan kernel; recall, warm QPS,
   one torch-profiler pass over one search, bitset, round trip, EXACT on
   1,000 queries;
8. HNSW at the bench's configuration on the same corpus (M=16,
   efConstruction=200, L2, FAST): the build (its all-pairs kNN graph runs
   through the f32 scan kernel; the inline walk must be active), recall@10
   and warm QPS at ef=48, the ef ladder 32 / 48 / 64, a 50% bitset, a 95%
   bitset (the exact-scan fallback), a Serialize/Deserialize round trip, the
   same BinarySet in lean mode (KNOWHERE_GRAPH_INLINE=0, the general walk),
   and one torch-profiler pass over one search;
9. the single-pass fused kNN scan (fused_knn, the counterpart of the
   reference's pallas_knn) over all queries at k=10, held against its plain
   version on the same inputs, recall@10 against the FLAT truth and its wall
   time beside FLAT's;
10. the bench's GIST leg of IVF_PQ (m=96, nbits=8, FP16 refine, so
   m * ksub = 24,576 LUT entries) at a reduced size: a GIST-like corpus of
   100,000 x 960 with 1,000 queries instead of 1M, nlist=256 instead of
   1024 and nprobe=32 instead of 384 (refine_k=32), all cut for chip time;
   FLAT ground truth on that corpus, FAST recall within 0.01 of EXACT;
11. one torch-profiler pass over one search each of IVF_FLAT (the int8
   scan), IVF_PQ (the ADC scan at its real shape) and IVF_SQ8 FAST (the
   int8 scan over u8 codes), after every timed search: device ms per
   kernel, device busy and idle share; then one more IVF_PQ search whose
   ADC launch is held against its plain version on the same inputs, with
   its task count, the share of empty tasks and the share of padded query
   rows in the others;
12. run the device build's Lloyd steps (a k-means step at the IVF build's
   shape, PQ's batched step at SIFT's codebook shape) twice each on the
   same inputs: the same bits;
13. print the reproducibility line (IVF_FLAT, IVF_PQ and GIST IVF_PQ
   recall, the ADC task count of one IVF_PQ search: two processes on the
   same seeds print the same), the kernel summary (each kernel's time,
   plain-version time and bound), the card line, and the contract line
   {"ok": true, "device": {...}} last.

Kernel launch counters are zeroed right before each of phases 4-10 and read
right after it; every kernel must have launched on its path.

Every phase raises on failure; the script then exits non-zero and prints no
result. JAX is not imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances of the kernel-vs-plain comparisons (section 3 of the docstring).
# int8: the dot is exact in both and the epilogue rounds the same f32 ops in
# the same order, so scores agree to 1e-6 relative and positions exactly.
INT8_RTOL = 1e-6
# f32: the kernel and the plain version compute the same exact bf16 products
# (three passes, or one) and sum them in f32 in other orders (the tensor
# cores' accumulators against cuBLAS): scores agree within 1e-4 relative +
# 1e-3, and positions except near-ties (at least 99.9% equal).
F32_RTOL, F32_ATOL, F32_POS_AGREE = 1e-4, 1e-3, 0.999
# FLAT phase 1: the kernel and the plain version both compute the
# reference's 3-pass hi/lo bf16 product, summed in other orders: group maxima
# agree within 1e-5 of the largest magnitude + 1e-3, group-id sets on
# >= 99.9% of entries.
FLAT_RTOL, FLAT_ATOL, FLAT_ID_AGREE = 1e-5, 1e-3, 0.999
# FLAT against an independent full-f32 answer (torch.matmul + torch.topk,
# TF32 off) on the first 1,000 queries: ids identical except where the k-th
# and (k+1)-th exact distances lie within this much (and ranks swapped
# between distances this close).
FLAT_EXACT_TIE = 1e-3
RECALL_FLOOR = 0.95  # IVF_FLAT recall@10 at nprobe=12 (reference: 0.9585)
FILTERED_RECALL_FLOOR = 0.90
F32_PATH_RECALL_FLOOR = 0.95
# ADC: the kernel and the plain version sum the LUT's f32 products in other
# orders, so a LUT entry may round to the neighbouring bf16 value: scores
# agree within 1e-3 relative + 1e-2, positions on >= 99% of slots.
ADC_RTOL, ADC_ATOL, ADC_POS_AGREE = 1e-3, 1e-2, 0.99
PQ_RECALL_FLOOR = 0.945  # IVF_PQ recall@10 at nprobe=12
PQ_TPU_ANCHOR = 0.9544  # the JAX package's recall on a TPU (docs/BENCHMARKS.md:16)
IVF_PQ_BUILD = {"metric_type": "L2", "nlist": 1024, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"}
IVF_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12, "refine_k": 8}
GIST_PQ_BUILD = {"metric_type": "L2", "nlist": 256, "m": 96, "nbits": 8, "refine": True, "refine_type": "FP16"}
GIST_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 32, "refine_k": 32}
# SQ: decoded values and queries are rounded to bf16 in both (single pass) or
# split to hi/lo bf16 (three_pass); the products are exact, the sums and the
# f32 norms run in other orders: the f32 scan's tolerances hold.
SQ8_BUILD = {"metric_type": "L2", "nlist": 1024, "sq_type": "SQ8"}
SQ8_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 16}
SQ8_RECALL_FLOOR = 0.945  # IVF_SQ8 recall@10 at nprobe=16
SQ8_TPU_ANCHOR = 0.9520  # the JAX package's recall on a TPU (docs/BENCHMARKS.md:19)
SQ_SCAN_RECALL_FLOOR = 0.90  # the same index served by the SQ scan kernel
SQ_SCAN_VS_EXACT = 0.03
# RaBitQ: the same +/-bf16(qr) terms in both (qr_hi and qr_lo for three_pass),
# summed in another order; |qr|^2 and <q,c> too: the f32 scan's tolerances
# hold.
RBQ_BUILD = {"metric_type": "L2", "nlist": 1024}
RBQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 16, "refine_k": 8}
RBQ_RECALL_FLOOR = 0.85
FAST_VS_EXACT = 0.01  # FAST recall may trail EXACT recall by this much
# fused kNN scan: both round the same bf16 inputs and sum exact products in
# f32 in other orders: scores within 1e-4 relative + 1e-3, id sets equal on
# >= 99.9% of slots.
FUSED_RTOL, FUSED_ATOL, FUSED_ID_AGREE = 1e-4, 1e-3, 0.999
FUSED_RECALL_FLOOR = 0.95
# HNSW floors, each just under the JAX package's TPU anchor
# (docs/BENCHMARKS.md:17,20,22; the reference's figures, not the port's)
HNSW_BUILD = {"metric_type": "L2", "M": 16, "efConstruction": 200}
HNSW_RECALL_FLOOR, HNSW_TPU_ANCHOR = 0.96, 0.9728  # ef=48, 4-bit inline walk
HNSW_FILTERED_FLOOR, HNSW_FILTERED_ANCHOR = 0.94, 0.9575  # 50% bitset
HNSW_LEAN_FLOOR, HNSW_LEAN_ANCHOR = 0.96, 0.9734  # general walk
HNSW_FALLBACK_FLOOR = 0.99  # 95% bitset: the exact scan
# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): device
# memory bytes/s, and operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def gen_corpus(nb, nq, dim, n_clusters=500, intrinsic_dim=48, seed=0, center_scale=(0.9, 1.6)):
    """SIFT-like gaussian mixture with low intrinsic dimension (the same
    generator as the reference benchmark's corpus)."""
    rng = np.random.default_rng(seed)
    scales = rng.uniform(*center_scale, size=n_clusters).astype(np.float32)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * scales[:, None]
    W = rng.standard_normal((intrinsic_dim, dim)).astype(np.float32)
    W *= np.sqrt(dim / intrinsic_dim) / np.sqrt(intrinsic_dim)

    def noise(n):
        return rng.standard_normal((n, intrinsic_dim)).astype(np.float32) @ W

    xb = centers[rng.integers(0, n_clusters, size=nb)] + noise(nb)
    xq = centers[rng.integers(0, n_clusters, size=nq)] + noise(nq)
    return xb, xq


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() over reps runs, CUDA events, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i].tolist())) for i in range(len(gt)))
    return hits / gt.size


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations ({operand type: count}) over the peak
    rate of their type. Returns {"bound_ms", "bound_by"}."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _task_work(blk, nrows, keep, Qg, kk, B=512):
    """What a task scan's data needs: the distinct list blocks it reads, the
    rows it scores (the sum of nrows), and the bytes of the task indices,
    the mask of the blocks read and the (score, position) outputs."""
    import torch

    n_blocks = int(torch.unique(blk).numel())
    rows = int(nrows.long().sum())
    T = blk.numel()
    side = T * 8 + T * Qg * kk * 8 + (n_blocks * B if keep is not None else 0)
    return n_blocks, rows, side


def _rows_read(blk, nrows):
    """The rows of the distinct list blocks up to each block's largest
    nrows: what a scan that stops at nrows must read."""
    import torch

    uniq, inv = torch.unique(blk, return_inverse=True)
    most = torch.zeros(uniq.numel(), dtype=torch.long, device=blk.device)
    return int(most.scatter_reduce_(0, inv, nrows.long(), "amax").sum())


def _dot_ops(three_pass: bool, dots: int, f32_ops: int) -> dict:
    """A scan's operations by type: its dots in f32 (three_pass, full f32) or
    bf16 (the single bf16 pass), plus f32_ops more in f32."""
    ops = {"f32": f32_ops}
    key = "f32" if three_pass else "bf16"
    ops[key] = ops.get(key, 0) + dots
    return ops


def _agreement(s_k, p_k, s_p, p_p, rtol, atol, pos_agree, sentinels) -> dict:
    """A kernel's (scores, positions) against its plain version's: scores
    within rtol/atol, positions on >= pos_agree of the slots; with
    sentinels, also the empty slots: the same slots, each exactly (-1e38,
    -1)."""
    import torch

    out = {"max_abs_err": (s_k - s_p).abs().max().item(), "pos_agree": (p_k == p_p).float().mean().item()}
    ok = torch.allclose(s_k, s_p, rtol=rtol, atol=atol) and out["pos_agree"] >= pos_agree
    if sentinels:
        empty = p_p == -1
        out["empty_slots"] = int(empty.sum())
        ok = ok and bool(torch.equal(p_k == -1, empty) and (s_k[empty] == -1e38).all() and (s_p[empty] == -1e38).all())
    out["ok"] = bool(ok)
    return out


def _run_case(name, kernel, plain, args, kw, rtol, atol, pos_agree, work, reps=5, sentinels=False, **desc):
    """Run one kernel case and its plain version on the same inputs, time
    both, compare (_agreement) and raise on disagreement. work = (bytes,
    ops) for the bound."""
    import torch

    s_k, p_k = kernel(*args, **kw)
    s_p, p_p = plain(*args, **kw)
    torch.cuda.synchronize()
    agree = _agreement(s_k, p_k, s_p, p_p, rtol, atol, pos_agree, sentinels)
    ok = agree.pop("ok")
    ms = time_ms(lambda: kernel(*args, **kw), reps=reps)
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3)
    line = dict(desc, kk=kw["kk"], mask=args[-1] is not None, is_l2=kw["is_l2"], **agree, ms=ms,
                plain_ms=plain_ms, **bound(*work))
    print(name, json.dumps(line))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {line}")
    return line


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def _task_geometry(g, n_blocks, n_tasks, dev):
    import torch

    blk = torch.randint(0, n_blocks, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows = torch.randint(1, 513, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows[: n_tasks // 2] = 512  # most list blocks are full
    return blk, nrows


def _int8_case(blk, nrows, q8, sz, codes, nrm, mask, kk, is_l2, **desc):
    """One int8-scan case against its plain version: scores to INT8_RTOL and
    every position equal (exact s32 dots, the same f32 roundings)."""
    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    n_tasks, Qg, d = q8.shape
    n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
    # the kernel stops at nrows: each block's rows up to its tasks' largest
    # nrows (every 512-row block in full: bound_full_blocks_ms)
    rows_read = _rows_read(blk, nrows)
    nbytes = rows_read * (d + 4 * is_l2) + n_tasks * Qg * (d + 4) + side
    full = n_blk * 512 * (d + 4 * is_l2) + n_tasks * Qg * (d + 4) + side
    ops = {"int8": 2 * n_rows * Qg * d}
    return _run_case(
        "ivf_int8_scan", ivf_cuda.int8_scan_tasks, ivf_cuda.int8_scan_plain, (blk, nrows, q8, sz, codes, nrm, mask),
        dict(B=512, kk=kk, is_l2=is_l2), INT8_RTOL, 0.0, 1.0, (nbytes, ops), reps=10,
        u8=codes.dtype == torch.uint8, tasks=n_tasks, Qg=Qg, d=d, bound_full_blocks_ms=bound(full, ops)["bound_ms"],
        **desc,
    )


def check_ivf_kernels(dev, n_tasks=4096, n_blocks=2048, Qg=128, d=128):
    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    B = ivf_cuda.LIST_ALIGN
    nb_pad = n_blocks * B
    blk, nrows = _task_geometry(g, n_blocks, n_tasks, dev)
    keep = torch.rand(nb_pad, generator=g, device=dev) < 0.5
    codes = torch.randint(-127, 128, (nb_pad, d), generator=g, device=dev, dtype=torch.int8)
    nrm = torch.rand(nb_pad, generator=g, device=dev) * 100.0
    q8 = torch.randint(-127, 128, (n_tasks, Qg, d), generator=g, device=dev, dtype=torch.int8)
    sz = torch.rand((n_tasks, Qg, 1), generator=g, device=dev) * 0.01
    rows = torch.randn((nb_pad, d), generator=g, device=dev)
    qf = torch.randn((n_tasks, Qg, d), generator=g, device=dev)
    results = {"ivf_int8_scan": [], "ivf_f32_scan": [], "ivf_sq_scan": [], "ivf_rbq_scan": []}

    # (kk, mask, is_l2, u8 codes): the main path's L2 cases first, then IP
    # and the SQ8 u8-code branch of the same kernel
    int8_cases = [(16, None, True, False), (16, keep, True, False), (32, None, True, False),
                  (32, keep, True, False), (16, keep, False, False), (16, None, True, True)]
    for kk, mask, is_l2, u8 in int8_cases:
        c = codes.view(torch.uint8) if u8 else codes
        results["ivf_int8_scan"].append(_int8_case(blk, nrows, q8, sz, c, nrm, mask, kk, is_l2))
    # a quarter of the tasks empty; a 32-query group (the N=32 instance)
    nrows_e = nrows.clone()
    nrows_e[::4] = 0
    results["ivf_int8_scan"].append(_int8_case(blk, nrows_e, q8, sz, codes, nrm, keep, 16, True, empty=True))
    q32, sz32 = q8[:, :32].contiguous(), sz[:, :32].contiguous()
    results["ivf_int8_scan"].append(_int8_case(blk, nrows, q32, sz32, codes, nrm, keep, 32, True))
    del q32, sz32, nrows_e
    # heavy ties: i8 codes and queries in {-1, 0, 1} (u8 codes 127..129),
    # norms and scales from a few values, so most scores of a row tie (own
    # generators: the later kernels' inputs stay as they were)
    g2 = torch.Generator(device=dev).manual_seed(4)
    ties_c = torch.randint(-1, 2, (nb_pad, d), generator=g2, device=dev, dtype=torch.int8)
    ties_q = torch.randint(-1, 2, (n_tasks, Qg, d), generator=g2, device=dev, dtype=torch.int8)
    ties_n = (ties_c != 0).sum(1).float()
    ties_s = torch.randint(1, 4, (n_tasks, Qg, 1), generator=g2, device=dev).float() * 0.25
    for kk, mask, is_l2, u8 in [(32, None, True, False), (16, keep, True, True), (32, keep, False, False),
                                (16, None, False, True)]:
        c = (ties_c.view(torch.uint8) ^ 0x80) if u8 else ties_c  # u8 c ^ 0x80 recentres to the same i8
        results["ivf_int8_scan"].append(
            _int8_case(blk, nrows, ties_q, ties_s, c, ties_n, mask, kk, is_l2, ties=True))
    del ties_c, ties_q, ties_n, ties_s
    # d=256: two feature chunks, 1,024 tasks of 64 queries
    g2 = torch.Generator(device=dev).manual_seed(3)
    blk2, nrows2 = _task_geometry(g2, n_blocks // 4, 1024, dev)
    codes2 = torch.randint(-127, 128, (nb_pad // 4, 256), generator=g2, device=dev, dtype=torch.int8)
    q2 = torch.randint(-127, 128, (1024, 64, 256), generator=g2, device=dev, dtype=torch.int8)
    sz2 = torch.rand((1024, 64, 1), generator=g2, device=dev) * 0.01
    for kk, mask, is_l2, u8 in [(16, None, True, False), (32, keep, True, True)]:
        c = codes2.view(torch.uint8) if u8 else codes2
        results["ivf_int8_scan"].append(_int8_case(blk2, nrows2, q2, sz2, c, nrm, mask, kk, is_l2))
    del codes2, q2, sz2

    # (three_pass, kk, mask, is_l2, tasks): the path's shape first, then the
    # HNSW build's per-launch shape (8,192 tasks, kk=32)
    f32_cases = [(True, 16, None, True, n_tasks), (True, 32, keep, True, n_tasks), (False, 16, None, True, n_tasks),
                 (False, 32, keep, True, n_tasks), (True, 16, keep, False, n_tasks), (True, 32, None, True, 8192)]
    path_inputs = blk, nrows, qf
    for three_pass, kk, mask, is_l2, tasks in f32_cases:
        if tasks != n_tasks:  # its own generator: the later cases keep their inputs
            g2 = torch.Generator(device=dev).manual_seed(2)
            blk, nrows = _task_geometry(g2, n_blocks, tasks, dev)
            qf = torch.randn((tasks, Qg, d), generator=g2, device=dev)
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        # the kernel stops at nrows: each block's rows up to its tasks' largest
        # nrows (every 512-row block in full: bound_full_blocks_ms)
        rows_read = _rows_read(blk, nrows)
        nbytes = rows_read * d * 4 + tasks * Qg * d * 4 + side
        # the tensor cores' bf16 passes over the scored rows, the L2 norms in f32
        ops = {"bf16": (3 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 2 * rows_read * d * is_l2}
        full = n_blk * B * d * 4 + tasks * Qg * d * 4 + side
        bound_full = bound(full, {"bf16": ops["bf16"], "f32": 2 * n_blk * B * d * is_l2})["bound_ms"]
        # the bound as if the dots ran in f32 on the CUDA cores, for comparison
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 2 * n_blk * B * d * is_l2))["bound_ms"]
        results["ivf_f32_scan"].append(_run_case(
            "ivf_f32_scan", ivf_cuda.f32_scan_tasks, ivf_cuda.f32_scan_plain, (blk, nrows, qf, rows, mask),
            dict(B=B, kk=kk, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL, F32_POS_AGREE,
            (nbytes, ops), three_pass=three_pass, tasks=tasks, bound_full_blocks_ms=bound_full,
            bound_f32_ms=bound_f32,
        ))
    blk, nrows, qf = path_inputs
    del rows, codes, q8

    # SQ: u8 codes and the grid; (three_pass, kk, mask, is_l2, levels), the
    # path's single bf16 pass first
    codes_u8 = torch.randint(0, 256, (nb_pad, d), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    vmin = torch.randn(d, generator=g, device=dev) - 2.0
    vdiff = torch.rand(d, generator=g, device=dev) * 4.0 + 0.5
    sq_cases = [(False, 16, None, True, 256), (False, 32, keep, True, 256), (False, 16, keep, False, 256),
                (False, 32, None, True, 64), (True, 16, None, True, 256), (True, 32, keep, True, 256)]
    rows_read = _rows_read(blk, nrows)  # the kernels stop at nrows
    for three_pass, kk, mask, is_l2, levels in sq_cases:
        c = codes_u8 if levels == 256 else codes_u8 >> 2
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        nbytes = rows_read * d + 2 * d * 4 + n_tasks * Qg * d * 4 + side
        # the tensor cores' bf16 passes over the scored rows, the decode (and
        # the norms for L2) once per code read in f32
        ops = {"bf16": (3 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 2 * rows_read * d * (1 + is_l2)}
        full = n_blk * B * d + 2 * d * 4 + n_tasks * Qg * d * 4 + side
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 2 * n_blk * B * d * (1 + is_l2)))
        results["ivf_sq_scan"].append(_run_case(
            "ivf_sq_scan", ivf_cuda.sq_scan_tasks, ivf_cuda.sq_scan_plain, (blk, nrows, qf, c, vmin, vdiff, mask),
            dict(B=B, kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL,
            F32_POS_AGREE, (nbytes, ops), three_pass=three_pass, levels=levels, bound_f32_ms=bound_f32["bound_ms"],
        ))
    del codes_u8

    # RaBitQ: packed sign bits, corrections, rotated centroids; (three_pass,
    # kk, mask, is_l2), the path's single bf16 pass at kk=32 first
    nlist = 1024
    signs = torch.randint(0, 256, (nb_pad, d // 8), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    rn = torch.rand(nb_pad, generator=g, device=dev) * 4.0
    tt = torch.rand(nb_pad, generator=g, device=dev) * 0.3 + 0.6
    cents = torch.randn((nlist, d), generator=g, device=dev)
    lids = torch.randint(0, nlist, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    n_lids = int(torch.unique(lids).numel())
    rbq_cases = [(False, 32, None, True), (False, 16, keep, True), (False, 16, keep, False), (True, 32, None, True),
                 (True, 16, keep, False)]
    for three_pass, kk, mask, is_l2 in rbq_cases:
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        nbytes = rows_read * (d // 8 + 8) + n_lids * d * 4 + n_tasks * (Qg * d * 4 + 4) + side
        # the tensor cores' sign dots (two passes for three_pass) over the
        # scored rows, plus qr and |qr|^2 or <q,c> once per query row in f32
        ops = {"bf16": (2 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 3 * n_tasks * Qg * d}
        full = n_blk * B * (d // 8 + 8) + n_lids * d * 4 + n_tasks * (Qg * d * 4 + 4) + side
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 3 * n_tasks * Qg * d))
        results["ivf_rbq_scan"].append(_run_case(
            "ivf_rbq_scan", ivf_cuda.rbq_scan_tasks, ivf_cuda.rbq_scan_plain,
            (blk, nrows, lids, qf, cents, signs, rn, tt, mask),
            dict(B=B, kk=kk, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL, F32_POS_AGREE,
            (nbytes, ops), three_pass=three_pass, bound_f32_ms=bound_f32["bound_ms"],
        ))
    return results


def _adc_case(g, dev, n_tasks, n_blocks, Qg, d, m, sub, ksub, nlist=1024):
    """Random ADC inputs at one shape: f32 queries, bf16 books, the bf16 L2
    CLUT made from them in float64 as the index makes it."""
    import torch

    B = 512
    blk, nrows = _task_geometry(g, n_blocks, n_tasks, dev)
    lids = torch.randint(0, nlist, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    books = (torch.randn((m, ksub, sub), generator=g, device=dev) * 0.3).to(torch.bfloat16)
    cents = torch.randn((nlist, d), generator=g, device=dev)
    b64 = books.double()
    c3 = cents[:, : m * sub].double().reshape(nlist, m, sub)
    clut = 2.0 * torch.einsum("lms,mvs->lmv", c3, b64) + (b64 * b64).sum(-1)[None]
    clut = clut.float().reshape(nlist, m * ksub).to(torch.bfloat16)
    q = torch.randn((n_tasks, Qg, d), generator=g, device=dev)
    return blk, nrows, lids, q, books, clut, cents, n_blocks * B


def _adc_run(args, kk, is_l2, nib, tol=(ADC_RTOL, ADC_ATOL, ADC_POS_AGREE), **desc):
    """One ADC case against its plain version, with every empty slot equal
    (-1e38, -1). The bound counts what the kernel does: an empty task loads
    nothing and builds no LUT, and a block's code rows are read up to its
    tasks' largest nrows."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda

    blk, nrows, lids, q, books, clut, cents, codes, mask = args
    n_tasks, Qg, d = q.shape
    m, ksub, sub = books.shape
    mb = m // 2 if nib else m
    live = nrows > 0
    n_live = int(live.sum())
    n_lids = int(torch.unique(lids[live]).numel())
    _, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
    nbytes = (_rows_read(blk, nrows) * mb + n_live * (Qg * d * 4 + 4) + m * ksub * sub * 2
              + n_lids * (m * ksub * 2 + d * 4) + side)
    # the LUT of every non-empty task (hi and lo bf16 passes), then m lookups a scored row
    ops = {"bf16": 2 * 2 * n_live * Qg * m * ksub * sub, "f32": n_rows * Qg * m}
    return _run_case(
        "ivf_adc_scan", adc_cuda.adc_scan_tasks, adc_cuda.adc_scan_plain, args,
        dict(B=512, kk=kk, is_l2=is_l2, nib=nib), *tol, (nbytes, ops), sentinels=True,
        tasks=n_tasks, d=d, m=m, ksub=ksub, sub=sub, nib=nib, empty_tasks=n_tasks - n_live, **desc,
    )


def _adc_grid(g, dev, m, ksub, sub, d, nlist, n_tasks, Qg, n_codes):
    """ADC inputs on a power-of-two grid (queries in {-1/2, 0, 1/2},
    centroids in halves, codebooks in {-1/4, 0, 1/4}, 4 in 5 of them 0,
    codes from 2 codewords a subspace): every LUT entry, sum and base is
    exact, so kernel and plain version agree bit for bit and many scores
    of a row tie (tests/test_torch_ivf_pq.py uses the same grid)."""
    import torch

    books = torch.randint(-1, 2, (m, ksub, sub), generator=g, device=dev).float() * 0.25
    books = (books * (torch.rand((m, ksub, sub), generator=g, device=dev) < 0.2)).to(torch.bfloat16)
    cents = torch.randint(-2, 3, (nlist, d), generator=g, device=dev).float() * 0.5
    q = torch.randint(-1, 2, (n_tasks, Qg, d), generator=g, device=dev).float() * 0.5
    codes = torch.randint(0, 2, (n_codes, m), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    b64 = books.double()
    c3 = cents[:, : m * sub].double().reshape(nlist, m, sub)
    clut = 2.0 * torch.einsum("lms,mvs->lmv", c3, b64) + (b64 * b64).sum(-1)[None]
    return q, books, clut.float().reshape(nlist, m * ksub).to(torch.bfloat16), cents, codes


# check_adc_kernel's shapes: (n_tasks, n_blocks, d, m, sub, ksub, nib,
# [(kk, mask, is_l2), ...], extras); extras adds the table shape with a
# quarter of its tasks empty and the exact tie grid. GIST's m=96 codebooks
# cover 960 of the 1024 padded columns; the last three shapes hold the other
# widths the kernel compiles (sub 4 and 16) and its run-time width (sub 6).
ADC_SHAPES = [
    (4096, 2048, 128, 16, 8, 256, False, [(16, False, True), (32, True, True), (16, False, False)], True),
    (4096, 2048, 128, 64, 2, 16, True, [(16, False, True)], False),
    (512, 256, 1024, 96, 10, 256, False, [(16, False, True), (16, True, True)], False),
    (512, 256, 128, 32, 4, 256, False, [(16, True, True)], False),
    (512, 256, 128, 8, 16, 256, False, [(16, True, True)], False),
    (512, 256, 128, 20, 6, 256, False, [(16, True, True), (32, False, False)], False),
]


def adc_cases(dev, shapes=ADC_SHAPES):
    """check_adc_kernel's inputs, in order: yields (args, kk, is_l2, nib,
    desc) for each case of each shape (seeded generators, so adc_ab.py
    reproduces them)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    for n_tasks, n_blocks, d, m, sub, ksub, nib, cases, extras in shapes:
        blk, nrows, lids, q, books, clut, cents, nb_pad = _adc_case(g, dev, n_tasks, n_blocks, 128, d, m, sub, ksub)
        mb = m // 2 if nib else m
        codes = torch.randint(0, 256 if nib else ksub, (nb_pad + 2048, mb), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        keep = torch.rand(nb_pad + 2048, generator=g, device=dev) < 0.5
        for kk, masked, is_l2 in cases:
            yield (blk, nrows, lids, q, books, clut, cents, codes, keep if masked else None), kk, is_l2, nib, {}
        if not extras:
            continue
        # the table shape with a quarter of the tasks empty (own generators
        # from here: the later shapes keep their inputs)
        nrows_e = nrows.clone()
        nrows_e[::4] = 0
        yield (blk, nrows_e, lids, q, books, clut, cents, codes, keep), 32, True, nib, {"empty": True}
        del nrows_e
        g2 = torch.Generator(device=dev).manual_seed(5)
        qg, books_g, clut_g, cents_g, codes_g = _adc_grid(g2, dev, m, ksub, sub, d, 1024, n_tasks, 128, nb_pad + 2048)
        for kk, masked, is_l2 in [(32, True, True), (16, False, False)]:
            args = (blk, nrows, lids, qg, books_g, clut_g, cents_g, codes_g, keep if masked else None)
            yield args, kk, is_l2, nib, {"ties": True}
        del qg, books_g, clut_g, cents_g, codes_g


def check_adc_kernel(dev):
    """ivf_adc_scan against adc_scan_plain on ADC_SHAPES: the main path's
    shape (4096 tasks, Qg=128, d=128, m=16, ksub=256; also with a quarter of
    the tasks empty, and on the exact tie grid with every score and position
    equal), the 4-bit nibble layout (m=64, ksub=16), the GIST shape (d=1024,
    m=96, ksub=256, 512 tasks) and the other compiled widths. First the
    wrapper's shared-memory figure (adc_cuda.adc_smem_bytes, which decides
    the search's route) against the kernel's own at each shape."""
    from knowhere_tpu_torch.ops import adc_cuda, cuda_build

    for _, _, _, m, sub, ksub, nib, _, _ in ADC_SHAPES:
        want = cuda_build.lib().kw_ivf_adc_smem_bytes(m, ksub, sub, int(nib))
        if adc_cuda.adc_smem_bytes(m, ksub, sub, nib) != want:
            raise AssertionError(f"adc_smem_bytes({m}, {ksub}, {sub}, {nib}) differs from the kernel's {want}")
    out = []
    for args, kk, is_l2, nib, desc in adc_cases(dev):
        tol = (0.0, 0.0, 1.0) if desc.get("ties") else (ADC_RTOL, ADC_ATOL, ADC_POS_AGREE)
        out.append(_adc_run(args, kk, is_l2, nib, tol=tol, **desc))
    return out


def check_lloyd_repro(dev, xb: np.ndarray, k=1024, m=16, ksub=256, reps=2) -> dict:
    """The device build's Lloyd sums add in a fixed order: one k-means step
    (ops/kmeans._lloyd_step) at the IVF build's shape (262,144 x 128 rows,
    k=1024) and PQ's batched step (ops/quant._pq_lloyd_batched) at SIFT's
    codebook shape (m=16, ksub=256, 65,536 rows of 8 features, two
    iterations) run twice each on the same inputs and must give the same
    bits. Also their wall ms (host clock around a synchronised call)."""
    import torch

    from knowhere_tpu_torch.ops import kmeans, quant

    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.ascontiguousarray(xb[: k * 256])).to(dev)
    c0 = x[torch.from_numpy(rng.choice(x.shape[0], k, replace=False)).to(dev)]
    xs = x[: ksub * 256].reshape(-1, m, x.shape[1] // m).transpose(0, 1).contiguous()
    b0 = xs[:, torch.from_numpy(rng.choice(xs.shape[1], ksub, replace=False)).to(dev)]
    out = {}
    for name, fn in (
        ("kmeans_step", lambda: kmeans._lloyd_step(x, c0, k=k)),
        ("pq_lloyd", lambda: (quant._pq_lloyd_batched(xs, b0, ksub=ksub, n_iters=2, nc=2048),)),
    ):
        runs, times = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append([r.clone() for r in fn()])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 else torch.equal(a, b)
                   for run in runs[1:] for a, b in zip(runs[0], run))
        out[name] = {"bit_equal": same, "ms": times}
        if not same:
            raise AssertionError(f"{name} gave other bits on the same inputs: {out}")
    print("lloyd:", json.dumps(out))
    return out


def check_flat_kernel(dev, xb: np.ndarray, xq: np.ndarray):
    """flat_group_scan against flat_group_scan_plain on the 1M corpus with
    1,024 queries (k=10 and k=100 L2, k=10 IP), and at d=256 on a random
    corpus. Times the whole scan, its
    group-max and select launches apart, and the f32 yardstick
    topk(((a q @ base^T) - |x|^2) grouped by 16 and maxed) in full f32."""
    import torch

    from knowhere_tpu_torch.ops import cuda_flat

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be full f32")
    base = torch.from_numpy(xb).to(dev)
    out = []
    for is_l2, k in ((True, 10), (True, 100), (False, 10)):
        store = cuda_flat.FlatScanStore(base, None, is_l2)
        q = torch.nn.functional.pad(torch.from_numpy(xq[:1024]).to(dev), (0, store.d_pad - store.d))
        args = (store.base, store.nrm, q, k, store.a_coef)
        err, agree = _flat_agreement(*args)
        ms = time_ms(lambda: cuda_flat.flat_group_scan(*args), reps=5)
        nq = q.shape[0]
        q_op = cuda_flat.query_operand(q)
        gmax = cuda_flat.flat_group_max(store.base, store.nrm, q_op, store.a_coef)
        group_max_ms = time_ms(lambda: cuda_flat.flat_group_max(store.base, store.nrm, q_op, store.a_coef), reps=5)
        select_ms = time_ms(lambda: cuda_flat.flat_select(gmax, nq, k), reps=5)
        del gmax
        plain_ms = time_ms(lambda: cuda_flat.flat_group_scan_plain(*args), reps=3)
        yardstick_ms = time_ms(lambda: torch.topk(
            (store.a_coef * (q @ store.base.T) - store.nrm).view(nq, -1, cuda_flat.GROUP).amax(-1), k), reps=3)
        nbytes = store.nb * (store.d + 1) * 4 + nq * store.d * 4 + nq * k * 8
        dots = 2 * store.nb * nq * store.d
        line = dict(nb=store.nb, nq=nq, k=k, is_l2=is_l2, max_abs_err=err, id_agree=agree, ms=ms,
                    group_max_ms=group_max_ms, select_ms=select_ms, plain_ms=plain_ms, yardstick_ms=yardstick_ms,
                    **bound(nbytes, {"bf16": 3 * dots}), bound_f32_ms=bound(nbytes, {"f32": dots})["bound_ms"])
        print("flat_group_scan", json.dumps(line))
        out.append(line)
        del store
    # d = 256 (two feature chunks: the corpus chunk is staged again for each
    # query tile, as at GIST's d = 960) on a random corpus
    g = torch.Generator(device=dev).manual_seed(3)
    store = cuda_flat.FlatScanStore(torch.randn((65536, 256), generator=g, device=dev), None, True)
    q = torch.randn((300, 256), generator=g, device=dev)
    err, agree = _flat_agreement(store.base, store.nrm, q, 10, store.a_coef)
    print("flat_group_scan", json.dumps(dict(nb=store.nb, nq=300, d=256, k=10, max_abs_err=err, id_agree=agree)))
    return out


def _flat_agreement(base, nrm, q, k, a_coef):
    """flat_group_scan against its plain version on the same inputs: (max
    abs error of the group maxima, mean share of equal group ids a query);
    raises beyond FLAT_RTOL / FLAT_ATOL or under FLAT_ID_AGREE."""
    import torch

    from knowhere_tpu_torch.ops import cuda_flat

    v_k, g_k = cuda_flat.flat_group_scan(base, nrm, q, k, a_coef)
    v_p, g_p = cuda_flat.flat_group_scan_plain(base, nrm, q, k, a_coef)
    torch.cuda.synchronize()
    err = (v_k - v_p).abs().max().item()
    tol = FLAT_ATOL + FLAT_RTOL * v_p.abs().max().item()
    gk, gp = g_k.cpu().numpy(), g_p.cpu().numpy()
    agree = float(np.mean([len(set(gk[i]) & set(gp[i])) / k for i in range(len(gk))]))
    if err > tol or agree < FLAT_ID_AGREE:
        raise AssertionError(f"flat_group_scan disagrees with its plain version: d={base.shape[1]} k={k} "
                             f"max_abs_err={err} tol={tol} id_agree={agree}")
    return err, agree


def flat_vs_exact(xb: np.ndarray, xq: np.ndarray, ids: np.ndarray, k: int) -> dict:
    """FLAT's ids against an independent full-f32 answer on the card:
    |q|^2 - 2 q.x + |x|^2 by torch.matmul (TF32 off), torch.topk of k + 1.
    A row may differ only where its k-th and (k+1)-th exact distances lie
    within FLAT_EXACT_TIE (another id set) or where the swapped ranks'
    distances do (another order)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the exact answer would not be full f32")
    b, q = torch.from_numpy(xb).cuda(), torch.from_numpy(xq).cuda()
    d2 = (q * q).sum(1, keepdim=True) - 2.0 * (q @ b.T) + (b * b).sum(1)[None, :]
    dist, idx = torch.topk(d2, k + 1, dim=1, largest=False)
    d_ids = torch.gather(d2, 1, torch.from_numpy(ids).long().cuda()).cpu().numpy()
    ex, dist = idx.cpu().numpy(), dist.cpu().numpy()
    del d2, b, q
    diff = np.nonzero((ex[:, :k] != ids).any(1))[0]
    other_set = [r for r in diff if set(ex[r, :k].tolist()) != set(ids[r].tolist())]
    bad = [int(r) for r in diff if np.abs(d_ids[r] - dist[r, :k]).max() > FLAT_EXACT_TIE
           or (r in other_set and dist[r, k] - dist[r, k - 1] > FLAT_EXACT_TIE)]
    out = {"queries": len(ids), "rows_differing": int(len(diff)), "rows_other_id_set": len(other_set),
           "rows_not_near_tie": len(bad)}
    if bad:
        raise AssertionError(f"FLAT ids disagree with the full-f32 answer beyond near-ties: {out}, rows {bad[:10]}")
    return out


def check_fused_kernel(dev, xb: np.ndarray, xq: np.ndarray):
    """fused_knn_scan against fused_knn_scan_plain on the 1M corpus with
    1,024 queries: k=10 and k=100 L2, k=10 IP, and a corpus whose row count
    is not a tile multiple (padded as fused_knn pads it). Also times the
    two-call yardstick torch.topk(2 (q_bf16 @ b_bf16^T) - norms, k)."""
    import torch

    from knowhere_tpu_torch.ops import fused_topk

    out = []
    q = torch.from_numpy(xq[:1024]).to(dev)
    for nb, k, is_l2 in ((len(xb), 10, True), (len(xb), 100, True), (len(xb), 10, False), (len(xb) - 37, 10, True)):
        b = torch.from_numpy(xb[:nb]).to(dev)
        nrm = (b * b).sum(1) if is_l2 else torch.zeros(nb, device=dev)
        base, norms = fused_topk.pad_base(b, nrm)
        args, kw = (q, base, norms), dict(k=k, is_l2=is_l2)
        s_k, i_k = fused_topk.fused_knn_scan(*args, **kw)
        s_p, i_p = fused_topk.fused_knn_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        ok = torch.allclose(s_k, s_p, rtol=FUSED_RTOL, atol=FUSED_ATOL)
        ik, ip_ = i_k.cpu().numpy(), i_p.cpu().numpy()
        agree = float(np.mean([len(set(ik[i]) & set(ip_[i])) / k for i in range(len(ik))]))
        ms = time_ms(lambda: fused_topk.fused_knn_scan(*args, **kw), reps=5)
        plain_ms = time_ms(lambda: fused_topk.fused_knn_scan_plain(*args, **kw), reps=3)
        nq, d = q.shape
        nbytes = nb * (d + 1) * 4 + nq * d * 4 + nq * k * 8  # the base read once per launch
        line = dict(nb=nb, nq=nq, k=k, is_l2=is_l2, max_abs_err=err, id_agree=agree, ms=ms, plain_ms=plain_ms,
                    **bound(nbytes, {"bf16": 2 * nq * nb * d}))
        if nb == len(xb) and k == 10 and is_l2:
            qb, bb = q.to(torch.bfloat16), base[:nb].to(torch.bfloat16)
            line["two_call_topk_ms"] = time_ms(lambda: torch.topk(2.0 * (qb @ bb.T).float() - nrm, k), reps=3)
            del qb, bb
        print("fused_knn_scan", json.dumps(line))
        if not ok or agree < FUSED_ID_AGREE:
            raise AssertionError(f"fused_knn_scan disagrees with its plain version: {line}")
        out.append(line)
        del base, norms, b
    return out


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def _search(idx, kt, xq, cfg, bitset=None):
    res = idx.Search(kt.GenDataSetFromArray(xq), cfg, bitset or kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"Search failed: {res.error().name}: {res.what()}")
    k = cfg["k"]
    return res.value().ids.reshape(len(xq), k), res.value().distance.reshape(len(xq), k)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(kt, xb, xq, k=10, nlist=1024, nprobe=12, search_reps=5):
    """FLAT ground truth, IVF_FLAT build + FAST search, filtered search,
    serialize round trip and the f32-scan path, all through the public API.
    Returns (numbers, the FLAT index, its ground truth ids)."""
    nq = len(xq)
    cfg_flat = {"metric_type": "L2", "k": k}
    cfg_ivf = {"metric_type": "L2", "k": k, "nprobe": nprobe}
    out = {}

    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    st, out["flat_build_s"] = _timed(lambda: flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}))
    if st != kt.Status.success:
        raise RuntimeError(f"FLAT Build: {st.name}")
    (gt, gt_d), out["flat_search_s"] = _timed(lambda: _search(flat, kt, xq, cfg_flat))
    if (gt < 0).any() or not np.isfinite(gt_d).all():
        raise AssertionError("FLAT ground truth has empty slots")
    d_chk = ((xq[:64, None, :] - xb[gt[:64]]) ** 2).sum(-1)
    if not np.allclose(d_chk, gt_d[:64], rtol=1e-3, atol=1e-2):
        raise AssertionError("FLAT distances disagree with numpy on the first 64 queries")
    if not (np.diff(gt_d, axis=1) >= -1e-3).all():
        raise AssertionError("FLAT results are not sorted")
    out["flat_vs_full_f32"] = flat_vs_exact(xb, xq[:1000], gt[:1000], k)
    # the first search also built the device copy and the scan store
    out["flat_warm_search_s_all"] = [_timed(lambda: _search(flat, kt, xq, cfg_flat))[1] for _ in range(3)]
    out["flat_warm_search_s_median"] = float(np.median(out["flat_warm_search_s_all"]))

    ivf = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    st, out["ivf_build_s"] = _timed(
        lambda: ivf.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": nlist})
    )
    if st != kt.Status.success:
        raise RuntimeError(f"IVF_FLAT Build: {st.name}")
    ids, dists = _search(ivf, kt, xq, cfg_ivf)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(ivf, kt, xq, cfg_ivf))
        times.append(dt)
    out["ivf_search_s_median"] = float(np.median(times))
    out["ivf_search_s_all"] = times
    out["ivf_qps"] = nq / out["ivf_search_s_median"]
    out["recall_at_10"] = recall_at(ids, gt)
    if not np.isfinite(dists).all() or ids.shape != (nq, k):
        raise AssertionError("IVF_FLAT results not finite / wrong shape")
    if out["recall_at_10"] < RECALL_FLOOR:
        raise AssertionError(f"IVF_FLAT recall@10 {out['recall_at_10']} < {RECALL_FLOOR}")
    _profile_later("ivf_profile", lambda idx=ivf: _search(idx, kt, xq, cfg_ivf))  # the int8 scan's search

    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    fids, _ = _search(ivf, kt, xq, cfg_ivf, kt.BitsetView.from_bool_array(drop))
    fgt, _ = _search(flat, kt, xq, cfg_flat, kt.BitsetView.from_bool_array(drop))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError("filtered search returned a filtered or empty id")
    out["filtered_recall_at_10"] = recall_at(fids, fgt)
    out["filtered_ids_returned"] = int(fids.size)
    if out["filtered_recall_at_10"] < FILTERED_RECALL_FLOOR:
        raise AssertionError(f"filtered recall {out['filtered_recall_at_10']} < {FILTERED_RECALL_FLOOR}")

    bs = kt.BinarySet()
    if ivf.Serialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT Serialize failed")
    again = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT Deserialize failed")
    ids2, _ = _search(again, kt, xq, cfg_ivf)
    out["roundtrip_ids_identical"] = bool(np.array_equal(ids2, ids))
    if not out["roundtrip_ids_identical"]:
        raise AssertionError("Serialize/Deserialize changed the result ids")

    # the same index without the int8 sidecar: FAST serves from the f32 scan
    os.environ["KNOWHERE_DISABLE_INT8_SCAN"] = "1"
    try:
        f32_idx = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
        if f32_idx.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("IVF_FLAT Deserialize (f32 scan) failed")
    finally:
        del os.environ["KNOWHERE_DISABLE_INT8_SCAN"]
    ids3, _ = _search(f32_idx, kt, xq, cfg_ivf)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids3, _), dt = _timed(lambda: _search(f32_idx, kt, xq, cfg_ivf))
        times.append(dt)
    out["f32_scan_search_s_all"] = times
    out["f32_scan_search_s_median"] = float(np.median(times))
    out["f32_scan_qps"] = nq / out["f32_scan_search_s_median"]
    out["f32_scan_recall_at_10"] = recall_at(ids3, gt)
    if out["f32_scan_recall_at_10"] < F32_PATH_RECALL_FLOOR:
        raise AssertionError(f"f32-scan recall {out['f32_scan_recall_at_10']} < {F32_PATH_RECALL_FLOOR}")
    return out, flat, gt


def _flat_truth(kt, xb, xq, k=10):
    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    if flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}) != kt.Status.success:
        raise RuntimeError("FLAT Build failed")
    return flat, _search(flat, kt, xq, {"metric_type": "L2", "k": k})[0]


def _exact_vs_fast(kt, idx, xq, gt, cfg, name="IVF_PQ"):
    """recall@k of EXACT (the plain decode scan) and FAST on the same queries;
    FAST must come within FAST_VS_EXACT."""
    kt.KnowhereConfig.SetSimdType("GENERIC")  # EXACT
    try:
        exact = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    finally:
        kt.KnowhereConfig.SetSimdType("AUTO")  # back to FAST
    fast = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    if fast < exact - FAST_VS_EXACT:
        raise AssertionError(f"{name} FAST recall {fast} < EXACT recall {exact} - {FAST_VS_EXACT}")
    return exact, fast


def _serve(kt, name, tag, xb, xq, gt, build, search, floor, search_reps=5):
    """Build `name`, then a warm-up and search_reps timed FAST searches of all
    queries; recall@k against gt must reach floor. Returns (index, ids,
    numbers keyed by tag)."""
    nq, k = len(xq), search["k"]
    out = {}
    idx = kt.IndexFactory.Instance().Create(name).value()
    st, out[f"{tag}_build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), build))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Build: {st.name}")
    ids, dists = _search(idx, kt, xq, search)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(idx, kt, xq, search))
        times.append(dt)
    out[f"{tag}_search_s_median"] = float(np.median(times))
    out[f"{tag}_search_s_all"] = times
    out[f"{tag}_qps"] = nq / out[f"{tag}_search_s_median"]
    out[f"{tag}_recall_at_10"] = recall_at(ids, gt)
    if not np.isfinite(dists).all() or ids.shape != (nq, k) or (ids < 0).any():
        raise AssertionError(f"{name} results not finite / wrong shape / short")
    if out[f"{tag}_recall_at_10"] < floor:
        raise AssertionError(f"{name} recall@10 {out[f'{tag}_recall_at_10']} < {floor}")
    return idx, ids, out


def _filtered_and_round_trip(kt, name, tag, idx, ids, xb, xq, flat, search):
    """A 50% bitset search (no filtered or empty id; recall against the
    filtered FLAT truth) and a Serialize/Deserialize round trip that must
    give identical ids. Returns (numbers keyed by tag, the BinarySet)."""
    out = {}
    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    fids, _ = _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(drop))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError(f"{name} filtered search returned a filtered or empty id")
    fgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": search["k"]}, kt.BitsetView.from_bool_array(drop))
    out[f"{tag}_filtered_recall_at_10"] = recall_at(fids, fgt)

    bs = kt.BinarySet()
    if idx.Serialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} Serialize failed")
    again = kt.IndexFactory.Instance().Create(name).value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} Deserialize failed")
    out[f"{tag}_roundtrip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
    if not out[f"{tag}_roundtrip_ids_identical"]:
        raise AssertionError(f"{name} Serialize/Deserialize changed the result ids")
    return out, bs


def pq_path(kt, xb, xq, gt, flat):
    """IVF_PQ at the north-star configuration through the public API."""
    pq, ids, out = _serve(kt, "IVF_PQ", "pq", xb, xq, gt, IVF_PQ_BUILD, IVF_PQ_SEARCH, PQ_RECALL_FLOOR)
    out["pq_tpu_anchor_recall_at_10"] = PQ_TPU_ANCHOR  # the reference's, not the port's
    # ivf_adc_scan at its real shape, held against its plain version there,
    # and the share of its tasks that are empty
    _profile_later("pq_profile", lambda idx=pq: _search(idx, kt, xq, IVF_PQ_SEARCH), _adc_real_launch)
    out.update(_filtered_and_round_trip(kt, "IVF_PQ", "pq", pq, ids, xb, xq, flat, IVF_PQ_SEARCH)[0])
    out["pq_exact_recall_1k"], out["pq_fast_recall_1k"] = _exact_vs_fast(
        kt, pq, xq[:1000], gt[:1000], IVF_PQ_SEARCH
    )
    return out


def sq8_path(kt, xb, xq, gt, flat):
    """IVF_SQ8 (SQ8) through the public API: FAST serves from the int8 scan
    over the u8 codes; then the same BinarySet, loaded without the int8
    sidecar, serves from the SQ scan kernel."""
    from knowhere_tpu_torch.ops import ivf_cuda

    sq, ids, out = _serve(kt, "IVF_SQ8", "sq8", xb, xq, gt, SQ8_BUILD, SQ8_SEARCH, SQ8_RECALL_FLOOR)
    out["sq8_tpu_anchor_recall_at_10"] = SQ8_TPU_ANCHOR  # the reference's, not the port's
    if ivf_cuda.int8_scan_tasks.launches == 0:
        raise AssertionError("IVF_SQ8 FAST did not run the int8 scan")
    _profile_later("sq8_profile", lambda idx=sq: _search(idx, kt, xq, SQ8_SEARCH))
    more, bs = _filtered_and_round_trip(kt, "IVF_SQ8", "sq8", sq, ids, xb, xq, flat, SQ8_SEARCH)
    out.update(more)
    exact, out["sq8_fast_recall_1k"] = _exact_vs_fast(kt, sq, xq[:1000], gt[:1000], SQ8_SEARCH, "IVF_SQ8")
    out["sq8_exact_recall_1k"] = exact
    del sq

    # the same BinarySet without the int8 sidecar: FAST serves from the SQ scan
    os.environ["KNOWHERE_DISABLE_INT8_SCAN"] = "1"
    try:
        sq_idx = kt.IndexFactory.Instance().Create("IVF_SQ8").value()
        if sq_idx.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("IVF_SQ8 Deserialize (SQ scan) failed")
    finally:
        del os.environ["KNOWHERE_DISABLE_INT8_SCAN"]
    before = ivf_cuda.sq_scan_tasks.launches
    ids_sq, _ = _search(sq_idx, kt, xq, SQ8_SEARCH)  # warm-up
    times = []
    for _ in range(3):
        (ids_sq, _), dt = _timed(lambda: _search(sq_idx, kt, xq, SQ8_SEARCH))
        times.append(dt)
    if ivf_cuda.sq_scan_tasks.launches == before:
        raise AssertionError("IVF_SQ8 without the int8 sidecar did not run the SQ scan")
    out["sq_scan_search_s_all"] = times
    out["sq_scan_qps"] = len(xq) / float(np.median(times))
    out["sq_scan_profile"] = _profile_search(lambda: _search(sq_idx, kt, xq, SQ8_SEARCH))
    out["sq_scan_recall_at_10"] = recall_at(ids_sq, gt)
    out["sq_scan_recall_1k"] = recall_at(ids_sq[:1000], gt[:1000])
    if out["sq_scan_recall_at_10"] < SQ_SCAN_RECALL_FLOOR or out["sq_scan_recall_1k"] < exact - SQ_SCAN_VS_EXACT:
        raise AssertionError(f"IVF_SQ8 SQ-scan recall {out['sq_scan_recall_at_10']} (first 1,000: "
                             f"{out['sq_scan_recall_1k']}, EXACT {exact}) below its floor")
    return out


def rabitq_path(kt, xb, xq, gt, flat):
    """IVF_RABITQ with its default raw refine store through the public API."""
    rbq, ids, out = _serve(kt, "IVF_RABITQ", "rbq", xb, xq, gt, RBQ_BUILD, RBQ_SEARCH, RBQ_RECALL_FLOOR)
    out["rbq_profile"] = _profile_search(lambda: _search(rbq, kt, xq, RBQ_SEARCH))
    out.update(_filtered_and_round_trip(kt, "IVF_RABITQ", "rbq", rbq, ids, xb, xq, flat, RBQ_SEARCH)[0])
    out["rbq_exact_recall_1k"], out["rbq_fast_recall_1k"] = _exact_vs_fast(
        kt, rbq, xq[:1000], gt[:1000], RBQ_SEARCH, "IVF_RABITQ"
    )
    return out


def gist_pq_path(kt, nb=100_000, nq=1_000):
    """The bench's GIST leg of IVF_PQ (m=96) at the reduced size of the
    docstring, against FLAT ground truth on its own corpus."""
    from knowhere_tpu_torch.ops import adc_cuda

    t0 = time.perf_counter()
    xb, xq = gen_corpus(nb, nq, 960, seed=0)
    out = {"gist_corpus_s": time.perf_counter() - t0}
    _, gt = _flat_truth(kt, xb, xq)
    pq = kt.IndexFactory.Instance().Create("IVF_PQ").value()
    st, out["gist_pq_build_s"] = _timed(lambda: pq.Build(kt.GenDataSetFromArray(xb), GIST_PQ_BUILD))
    if st != kt.Status.success:
        raise RuntimeError(f"GIST IVF_PQ Build: {st.name}")
    m, ksub, _ = pq.node._store["books"].shape
    out["gist_lut_entries"] = m * ksub
    before = adc_cuda.adc_scan_tasks.launches
    (ids, _), out["gist_pq_search_s"] = _timed(lambda: _search(pq, kt, xq, GIST_PQ_SEARCH))
    if m * ksub != 24576 or adc_cuda.adc_scan_tasks.launches == before:
        raise AssertionError(f"the ADC kernel did not serve m * ksub = {m * ksub} (want 24576)")
    out["gist_pq_recall_at_10"] = recall_at(ids, gt)
    out["gist_exact_recall"], out["gist_fast_recall"] = _exact_vs_fast(kt, pq, xq, gt, GIST_PQ_SEARCH)
    return out


# (name, search): torch-profiler passes run after every timed search of the
# script (late_profiles), so that the searches timed on the paths before
# them do not follow a profiler pass, which can slow the searches timed
# after it in the same process; the closures keep their indexes alive
_LATE_PROFILES = []


def _profile_later(name, fn, extra=None) -> None:
    """extra(fn), if given, runs after the profiler pass and adds to its numbers."""
    _LATE_PROFILES.append((name, fn, extra))


def late_profiles() -> dict:
    out = {}
    for name, fn, extra in _LATE_PROFILES:
        out[name] = _profile_search(fn)
        if extra is not None:
            out[name].update(extra(fn))
    _LATE_PROFILES.clear()
    return out


def _adc_real_launch(fn) -> dict:
    """One more fn() with the search's ADC scan wrapped: each launch's
    output is held against adc_scan_plain on the same inputs at the ADC
    tolerance, with every empty slot exactly (-1e38, -1); its tasks and
    those with nrows == 0 (padding of the device task builder's static
    bound, which the kernel skips) are counted. Its task builder is wrapped
    to count the query rows of the non-empty tasks and those that are
    padding (qids < 0, scanned as query 0 and dropped by the merge).
    Outside the profiler pass: the counts sync the host."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda, ivf_scan

    real, real_tasks = ivf_scan.adc_scan_tasks, ivf_scan._tasks
    seen = {"adc_tasks": 0, "adc_empty_tasks": 0, "adc_live_query_rows": 0, "adc_padded_query_rows": 0}
    calls = []

    def capturing(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, tuple(o.clone() for o in out)))
        return out

    def counting_tasks(*args, **kw):
        out = real_tasks(*args, **kw)
        if out is not None:
            nr, qids = out[1], out[3]
            live = nr > 0
            seen["adc_live_query_rows"] += int(live.sum()) * qids.shape[1]
            seen["adc_padded_query_rows"] += int(((qids < 0) & live[:, None]).sum())
        return out

    ivf_scan.adc_scan_tasks, ivf_scan._tasks = capturing, counting_tasks
    try:
        fn()
    finally:
        ivf_scan.adc_scan_tasks, ivf_scan._tasks = real, real_tasks
    checks = []
    for args, kw, (s_k, p_k) in calls:
        seen["adc_tasks"] += int(args[1].numel())
        seen["adc_empty_tasks"] += int((args[1] <= 0).sum())
        s_p, p_p = adc_cuda.adc_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        agree = _agreement(s_k, p_k, s_p, p_p, ADC_RTOL, ADC_ATOL, ADC_POS_AGREE, True)
        agree["scores_differing"] = int((s_k.view(torch.int32) != s_p.view(torch.int32)).sum())
        checks.append(agree)
        if not agree["ok"]:
            raise AssertionError(f"ivf_adc_scan disagrees with its plain version on the real IVF_PQ launch: {agree}")
    if not calls:
        raise AssertionError("the IVF_PQ search launched no ADC scan")
    seen["adc_vs_plain"] = checks
    seen["adc_empty_share"] = seen["adc_empty_tasks"] / max(seen["adc_tasks"], 1)
    seen["adc_padded_row_share"] = seen["adc_padded_query_rows"] / max(seen["adc_live_query_rows"], 1)
    return seen


def _profile_search(fn) -> dict:
    """One torch-profiler pass over fn(): wall ms, device busy ms (the sum of
    the device kernels' time), the idle share, the device ms under each
    library range (graph_inline.seed / walk / rerank, graph.walk,
    hnsw.refine, hnsw.brute_force), the device ms and launches of each of the
    port's CUDA kernels (namespace kw) and the top ops by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_ms(e, attr):
        return (getattr(e, attr, None) or getattr(e, attr.replace("device", "cuda"), 0.0) or 0.0) / 1e3

    avgs = prof.key_averages()
    # the ranges appear twice: as host events (device time of the kernels
    # they launched) and as spans on the device timeline, which busy skips
    is_range = [e.key.startswith(("graph_inline.", "graph.", "hnsw.")) for e in avgs]
    busy = sum(dev_ms(e, "self_device_time_total") for e, r in zip(avgs, is_range)
               if e.device_type == DeviceType.CUDA and not r)
    ranges = {e.key: round(dev_ms(e, "device_time_total"), 3) for e, r in zip(avgs, is_range)
              if r and e.device_type == DeviceType.CPU}
    ops = sorted((e for e in avgs if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")),
                 key=lambda e: dev_ms(e, "self_device_time_total"), reverse=True)
    top = [(e.key, round(dev_ms(e, "self_device_time_total"), 3), e.count) for e in ops[:10]]
    kernels = {e.key.split("(")[0].replace("void ", "")[:90]: (round(dev_ms(e, "self_device_time_total"), 3), e.count)
               for e in avgs if e.device_type == DeviceType.CUDA and "kw::" in e.key}
    if busy > wall:
        raise AssertionError(f"profile: device busy {busy} ms exceeds the wall {wall} ms (time counted twice)")
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall, "ranges": ranges,
            "kernels": kernels, "top_ops": top}


def hnsw_path(kt, xb, xq, gt, flat, search_reps=5):
    """HNSW at the bench's configuration through the public API (see the
    module docstring, step 8). Returns its numbers."""
    from knowhere_tpu_torch.ops import ivf_cuda

    nq, k = len(xq), 10
    search = {"metric_type": "L2", "k": k, "ef": 48}
    out = {}
    idx = kt.IndexFactory.Instance().Create("HNSW").value()
    f32_before = ivf_cuda.f32_scan_tasks.launches
    os.environ["KNOWHERE_BUILD_TIMING"] = "1"  # the build prints its phases
    try:
        st, out["hnsw_build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), HNSW_BUILD))
    finally:
        del os.environ["KNOWHERE_BUILD_TIMING"]
    if st != kt.Status.success:
        raise RuntimeError(f"HNSW Build: {st.name}")
    out["hnsw_build_f32_scan_launches"] = ivf_cuda.f32_scan_tasks.launches - f32_before
    if out["hnsw_build_f32_scan_launches"] == 0:
        raise AssertionError("the HNSW build's kNN graph did not run the f32 scan kernel")
    inline = idx.node._inline
    if inline is None:
        raise AssertionError("the HNSW inline walk is not active at 1M rows")
    out["hnsw_inline_bits"] = inline.bits
    ids, dists = _search(idx, kt, xq, search)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(idx, kt, xq, search))
        times.append(dt)
    out["hnsw_search_s_all"] = times
    out["hnsw_qps"] = nq / float(np.median(times))
    out["hnsw_recall_at_10"] = recall_at(ids, gt)
    out["hnsw_tpu_anchor_recall_at_10"] = HNSW_TPU_ANCHOR  # the reference's, not the port's
    if not np.isfinite(dists).all() or ids.shape != (nq, k) or (ids < 0).any():
        raise AssertionError("HNSW results not finite / wrong shape / short")
    if out["hnsw_recall_at_10"] < HNSW_RECALL_FLOOR:
        raise AssertionError(f"HNSW recall@10 {out['hnsw_recall_at_10']} < {HNSW_RECALL_FLOOR}")
    out["hnsw_profile"] = _profile_search(lambda: _search(idx, kt, xq, search))
    for ef in (32, 48, 64):
        (ids_e, _), dt = _timed(lambda: _search(idx, kt, xq, dict(search, ef=ef)))
        out[f"hnsw_ef{ef}"] = {"recall_at_10": recall_at(ids_e, gt), "qps": nq / dt}

    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    (fids, _), out["hnsw_filtered_s"] = _timed(lambda: _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(drop)))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError("HNSW filtered search returned a filtered or empty id")
    fgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": k}, kt.BitsetView.from_bool_array(drop))
    out["hnsw_filtered_recall_at_10"] = recall_at(fids, fgt)
    out["hnsw_filtered_tpu_anchor"] = HNSW_FILTERED_ANCHOR
    if out["hnsw_filtered_recall_at_10"] < HNSW_FILTERED_FLOOR:
        raise AssertionError(f"HNSW 50% bitset recall {out['hnsw_filtered_recall_at_10']} < {HNSW_FILTERED_FLOOR}")

    # 95% filtered: the exact-scan fallback must answer
    dense = np.random.default_rng(2).random(len(xb)) < 0.95
    node, calls = idx.node, []
    brute = node._brute_force
    node._brute_force = lambda *a: (calls.append(1), brute(*a))[1]
    try:
        (bids, _), out["hnsw_fallback_s"] = _timed(
            lambda: _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(dense)))
    finally:
        del node._brute_force
    bgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": k}, kt.BitsetView.from_bool_array(dense))
    out["hnsw_fallback_recall_at_10"] = recall_at(bids, bgt)
    if not calls or (bids < 0).any() or dense[bids].any() or out["hnsw_fallback_recall_at_10"] < HNSW_FALLBACK_FLOOR:
        raise AssertionError(f"HNSW 95% bitset: fallback calls {len(calls)}, recall {out['hnsw_fallback_recall_at_10']}")

    bs = kt.BinarySet()
    if idx.Serialize(bs) != kt.Status.success:
        raise RuntimeError("HNSW Serialize failed")
    again = kt.IndexFactory.Instance().Create("HNSW").value()
    (st, out["hnsw_load_s"]) = _timed(lambda: again.Deserialize(bs))
    if st != kt.Status.success:
        raise RuntimeError("HNSW Deserialize failed")
    out["hnsw_roundtrip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
    if not out["hnsw_roundtrip_ids_identical"]:
        raise AssertionError("HNSW Serialize/Deserialize changed the result ids")
    del idx, again, node, brute

    # the same BinarySet in lean mode: the general walk
    os.environ["KNOWHERE_GRAPH_INLINE"] = "0"
    try:
        lean = kt.IndexFactory.Instance().Create("HNSW").value()
        if lean.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("HNSW Deserialize (lean mode) failed")
    finally:
        del os.environ["KNOWHERE_GRAPH_INLINE"]
    if lean.node._inline is not None:
        raise AssertionError("lean mode built the inline table")
    ids_l, _ = _search(lean, kt, xq, search)  # warm-up
    times = []
    for _ in range(3):
        (ids_l, _), dt = _timed(lambda: _search(lean, kt, xq, search))
        times.append(dt)
    out["hnsw_lean_profile"] = _profile_search(lambda: _search(lean, kt, xq, search))
    out["hnsw_lean_search_s_all"] = times
    out["hnsw_lean_qps"] = nq / float(np.median(times))
    out["hnsw_lean_recall_at_10"] = recall_at(ids_l, gt)
    out["hnsw_lean_tpu_anchor"] = HNSW_LEAN_ANCHOR
    if out["hnsw_lean_recall_at_10"] < HNSW_LEAN_FLOOR:
        raise AssertionError(f"HNSW lean-mode recall {out['hnsw_lean_recall_at_10']} < {HNSW_LEAN_FLOOR}")
    return out


def fused_knn_path(xb, xq, gt, flat_search_s, k=10):
    """fused_knn (the single-pass scan) over every query against the 1M base."""
    import torch

    from knowhere_tpu_torch.device import to_device
    from knowhere_tpu_torch.ops import fused_topk

    base = to_device(xb)
    fused_topk.fused_knn(xq[:64], base, k, "L2")  # warm-up
    (dists, ids), wall = _timed(lambda: fused_topk.fused_knn(xq, base, k, "L2"))
    # the plain version on the same padded inputs: this call's shape (all
    # queries in one launch) splits the corpus unlike the kernel phase's
    base_p, norms_p = fused_topk.pad_base(base, (base * base).sum(1))
    q = torch.nn.functional.pad(to_device(xq), (0, base_p.shape[1] - base.shape[1]))
    s_p, i_p = fused_topk.fused_knn_scan_plain(q, base_p, norms_p, k=k, is_l2=True)
    dists_p, ids_p = fused_topk.host_result(s_p, i_p, xq, len(xb), True)
    del base, base_p, norms_p, q, s_p, i_p
    torch.cuda.empty_cache()
    out = {"fused_knn_s": wall, "flat_exact_search_s": flat_search_s, "fused_recall_at_10": recall_at(ids, gt),
           "plain_max_abs_err": float(np.abs(dists - dists_p).max()),
           "plain_id_agree": float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, ids_p)]))}
    if not np.allclose(dists, dists_p, rtol=FUSED_RTOL, atol=FUSED_ATOL) or out["plain_id_agree"] < FUSED_ID_AGREE:
        raise AssertionError(f"fused_knn over every query disagrees with the plain version: {out}")
    if ids.shape != (len(xq), k) or (ids < 0).any() or not np.isfinite(dists).all():
        raise AssertionError("fused_knn results not finite / wrong shape / short")
    if out["fused_recall_at_10"] < FUSED_RECALL_FLOOR:
        raise AssertionError(f"fused_knn recall@10 {out['fused_recall_at_10']} < {FUSED_RECALL_FLOOR}")
    return out


def _run_path(name, wrappers, must_launch, fn):
    """Drive one path with every launch counter zeroed just before it; the
    counts are read just after it, and each kernel of the path must have
    launched. Returns (fn's output, counts)."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    counts = {n: w.launches for n, w in wrappers.items()}
    print(f"{name} launches:", json.dumps(counts))
    missing = [n for n in must_launch if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name}: {missing}")
    return out, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "knowhere_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: knowhere_tpu_torch/ not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops import adc_cuda, cuda_build, cuda_flat, fused_topk, ivf_cuda

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kt.set_device("cuda")
    dev = torch.device("cuda")
    card = card_line()
    print("card:", card)

    t0 = time.perf_counter()
    cuda_build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc: {cuda_build.build_seconds})")

    ivf_checks = check_ivf_kernels(dev)
    adc_checks = check_adc_kernel(dev)
    t0 = time.perf_counter()
    xb, xq = gen_corpus(1_000_000, 10_000, 128, seed=0)
    print(f"corpus 1000000 x 128, 10000 queries, made in {time.perf_counter() - t0:.2f} s")
    flat_checks = check_flat_kernel(dev, xb, xq)
    fused_checks = check_fused_kernel(dev, xb, xq)

    kt.KnowhereConfig.SetSimdType("AUTO")  # FAST: the kernels' serving scans
    wrappers = {
        "ivf_int8_scan": ivf_cuda.int8_scan_tasks,
        "ivf_f32_scan": ivf_cuda.f32_scan_tasks,
        "flat_group_scan": cuda_flat.flat_group_scan,
        "ivf_adc_scan": adc_cuda.adc_scan_tasks,
        "ivf_sq_scan": ivf_cuda.sq_scan_tasks,
        "ivf_rbq_scan": ivf_cuda.rbq_scan_tasks,
        "fused_knn_scan": fused_topk.fused_knn_scan,
    }
    # each kernel's launches are reported from the path that introduced it
    (e2e, flat, gt), counts = _run_path(
        "main path", wrappers, ("ivf_int8_scan", "ivf_f32_scan", "flat_group_scan"),
        lambda: main_path(kt, xb, xq),
    )
    print("main path:", json.dumps(e2e))
    launches = {n: counts[n] for n in ("ivf_int8_scan", "ivf_f32_scan", "flat_group_scan")}
    pq_out, counts = _run_path("ivf_pq path", wrappers, ("ivf_adc_scan",), lambda: pq_path(kt, xb, xq, gt, flat))
    print("ivf_pq path:", json.dumps(pq_out))
    launches["ivf_adc_scan"] = counts["ivf_adc_scan"]
    sq_out, counts = _run_path(
        "ivf_sq8 path", wrappers, ("ivf_int8_scan", "ivf_sq_scan"), lambda: sq8_path(kt, xb, xq, gt, flat)
    )
    print("ivf_sq8 path:", json.dumps(sq_out))
    launches["ivf_sq_scan"] = counts["ivf_sq_scan"]
    rbq_out, counts = _run_path(
        "ivf_rabitq path", wrappers, ("ivf_rbq_scan",), lambda: rabitq_path(kt, xb, xq, gt, flat)
    )
    print("ivf_rabitq path:", json.dumps(rbq_out))
    launches["ivf_rbq_scan"] = counts["ivf_rbq_scan"]
    # HNSW before FLAT is dropped: its filtered truths need it
    hnsw_out, _ = _run_path("hnsw path", wrappers, ("ivf_f32_scan",), lambda: hnsw_path(kt, xb, xq, gt, flat))
    print("hnsw path:", json.dumps(hnsw_out))
    del flat
    torch.cuda.empty_cache()
    fused_out, counts = _run_path(
        "fused knn path", wrappers, ("fused_knn_scan",), lambda: fused_knn_path(xb, xq, gt, e2e["flat_search_s"])
    )
    print("fused knn path:", json.dumps(fused_out))
    launches["fused_knn_scan"] = counts["fused_knn_scan"]
    gist_out, _ = _run_path("gist ivf_pq path", wrappers, ("ivf_adc_scan", "flat_group_scan"), lambda: gist_pq_path(kt))
    print("gist ivf_pq path:", json.dumps(gist_out))
    profiles = late_profiles()
    print("late profiles:", json.dumps(profiles))
    # after every timed search: its steps' large blocks do not share a
    # process with them
    lloyd = check_lloyd_repro(dev, xb)
    # what a second process on the same seeds must reproduce: the device
    # build is deterministic, so these equal from run to run
    print("reproducibility:", json.dumps({
        "ivf_flat_recall_at_10": e2e["recall_at_10"], "ivf_pq_recall_at_10": pq_out["pq_recall_at_10"],
        "adc_tasks": profiles["pq_profile"]["adc_tasks"], "gist_pq_recall_at_10": gist_out["gist_pq_recall_at_10"],
        "lloyd_bit_equal": all(v["bit_equal"] for v in lloyd.values()),
    }))
    torch.cuda.synchronize()

    first = {name: lines[0] for name, lines in (
        ("ivf_int8_scan", ivf_checks["ivf_int8_scan"]),
        ("ivf_f32_scan", ivf_checks["ivf_f32_scan"]),
        ("flat_group_scan", flat_checks),
        ("ivf_adc_scan", adc_checks),
        ("ivf_sq_scan", ivf_checks["ivf_sq_scan"]),
        ("ivf_rbq_scan", ivf_checks["ivf_rbq_scan"]),
        ("fused_knn_scan", fused_checks),
    )}
    meta = {
        "ivf_int8_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:400"),
        "ivf_f32_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:113"),
        "flat_group_scan": ("knowhere_tpu_torch/csrc/flat_scan.cu", "knowhere_tpu/ops/pallas_flat.py:62"),
        "ivf_adc_scan": (
            "knowhere_tpu_torch/csrc/ivf_adc.cu",
            "knowhere_tpu/ops/ivf_pallas.py:556 and knowhere_tpu/ops/ivf_pallas.py:732",
        ),
        "ivf_sq_scan": ("knowhere_tpu_torch/csrc/ivf_sq.cu", "knowhere_tpu/ops/ivf_pallas.py:236"),
        "ivf_rbq_scan": ("knowhere_tpu_torch/csrc/ivf_rbq.cu", "knowhere_tpu/ops/ivf_pallas.py:966"),
        "fused_knn_scan": ("knowhere_tpu_torch/csrc/fused_knn.cu", "knowhere_tpu/ops/pallas_topk.py:73"),
    }
    # library_ms is null for every kernel: no single PyTorch call computes a
    # per-task masked top-kk over gathered list blocks, FLAT's top-k of
    # 16-row group maxima, or a bf16 top-k scan (a product without the top-k
    # is another function; the fused scan's two-call yardstick is printed in
    # its kernel lines)
    kernels = [
        {
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": launches[name], "max_abs_err": first[name]["max_abs_err"],
            "ms": first[name]["ms"], "plain_ms": first[name]["plain_ms"],
            "bound_ms": first[name]["bound_ms"], "bound_by": first[name]["bound_by"], "library_ms": None,
        }
        for name in wrappers
    ]
    # the tensor-core kernels also carry their f32-typed bound (the f32 scan
    # its whole-block one too); FLAT its two launches apart and its f32
    # yardstick (several calls)
    for entry in kernels:
        extra = ("bound_f32_ms", "bound_full_blocks_ms", "group_max_ms", "select_ms", "yardstick_ms")
        entry.update({key: first[entry["name"]][key] for key in extra if key in first[entry["name"]]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
