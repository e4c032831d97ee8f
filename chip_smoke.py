#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (knowhere_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU. In order:

1. require a CUDA device and print the card's name and power limit;
2. build the CUDA kernels from knowhere_tpu_torch/csrc (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time both;
4. run the main path through the public API on the SIFT1M-like corpus
   (1M x 128 f32, 10,000 queries, seed 0): FLAT exact ground truth, IVF_FLAT
   (nlist=1024, L2) FAST search at nprobe=12, k=10, recall@10 and warm QPS,
   a 50% bitset search, a Serialize/Deserialize round trip, and the same
   index served by the f32 scan (KNOWHERE_DISABLE_INT8_SCAN=1);
5. IVF_PQ at the north-star configuration on the same corpus (nlist=1024,
   m=16, nbits=8, OPQ, FP16 refine with refine_k=8, FAST, nprobe=12, k=10):
   recall@10 against the FLAT truth and warm QPS, a 50% bitset search, a
   Serialize/Deserialize round trip, and an EXACT-precision search of the
   first 1,000 queries (the plain decode scan) that FAST must come within
   0.01 recall of;
6. the bench's GIST leg of IVF_PQ (m=96, nbits=8, FP16 refine, so
   m * ksub = 24,576 LUT entries) at a reduced size: a GIST-like corpus of
   100,000 x 960 with 1,000 queries instead of 1M, nlist=256 instead of
   1024 and nprobe=32 instead of 384 (refine_k=32), all cut for chip time;
   FLAT ground truth on that corpus, FAST recall within 0.01 of EXACT;
7. print the kernel summary, the card line, and the contract line
   {"ok": true, "device": {...}} last.

Kernel launch counters are zeroed right before each of phases 4-6 and read
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
# f32: the kernel sums FMAs in feature order, the plain version through
# cuBLAS in another order: scores agree within 1e-4 relative + 1e-3, and
# positions except near-ties (at least 99.9% equal).
F32_RTOL, F32_ATOL, F32_POS_AGREE = 1e-4, 1e-3, 0.999
# FLAT phase 1: the kernel is full f32, the plain version the reference's
# 3-pass hi/lo bf16 (drops lo*lo, ~2^-16 relative): group maxima agree within
# 1e-5 of the largest magnitude + 1e-3, group-id sets on >= 99.9% of entries.
FLAT_RTOL, FLAT_ATOL, FLAT_ID_AGREE = 1e-5, 1e-3, 0.999
RECALL_FLOOR = 0.95  # IVF_FLAT recall@10 at nprobe=12 (reference: 0.9585)
FILTERED_RECALL_FLOOR = 0.90
F32_PATH_RECALL_FLOOR = 0.95
# ADC: the kernel and the plain version sum the LUT's f32 products in other
# orders, so a LUT entry may round to the neighbouring bf16 value: scores
# agree within 1e-3 relative + 1e-2, positions on >= 99% of slots.
ADC_RTOL, ADC_ATOL, ADC_POS_AGREE = 1e-3, 1e-2, 0.99
PQ_RECALL_FLOOR = 0.945  # IVF_PQ recall@10 at nprobe=12
PQ_TPU_ANCHOR = 0.9544  # the JAX package's recall on a TPU (docs/BENCHMARKS.md:16)
PQ_FAST_VS_EXACT = 0.01  # FAST recall may trail EXACT recall by this much
IVF_PQ_BUILD = {"metric_type": "L2", "nlist": 1024, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"}
IVF_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12, "refine_k": 8}
GIST_PQ_BUILD = {"metric_type": "L2", "nlist": 256, "m": 96, "nbits": 8, "refine": True, "refine_type": "FP16"}
GIST_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 32, "refine_k": 32}


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


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def _task_geometry(g, n_blocks, n_tasks, dev):
    import torch

    blk = torch.randint(0, n_blocks, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows = torch.randint(1, 513, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows[: n_tasks // 2] = 512  # most list blocks are full
    return blk, nrows


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
    results = {"ivf_int8_scan": [], "ivf_f32_scan": []}

    # (kk, mask, is_l2, u8 codes): the main path's L2 cases first, then IP
    # and the SQ8 u8-code branch of the same kernel
    int8_cases = [(16, None, True, False), (16, keep, True, False), (32, None, True, False),
                  (32, keep, True, False), (16, keep, False, False), (16, None, True, True)]
    for kk, mask, is_l2, u8 in int8_cases:
        c = codes.view(torch.uint8) if u8 else codes
        args = (blk, nrows, q8, sz, c, nrm, mask)
        kw = dict(B=B, kk=kk, is_l2=is_l2)
        s_k, p_k = ivf_cuda.int8_scan_tasks(*args, **kw)
        s_p, p_p = ivf_cuda.int8_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        rel_ok = torch.allclose(s_k, s_p, rtol=INT8_RTOL, atol=0.0)
        pos_eq = (p_k == p_p).float().mean().item()
        ms = time_ms(lambda: ivf_cuda.int8_scan_tasks(*args, **kw))
        plain_ms = time_ms(lambda: ivf_cuda.int8_scan_plain(*args, **kw), reps=3)
        line = dict(kk=kk, mask=mask is not None, is_l2=is_l2, u8=u8, max_abs_err=err,
                    pos_agree=pos_eq, ms=ms, plain_ms=plain_ms)
        print("ivf_int8_scan", json.dumps(line))
        if not rel_ok or pos_eq != 1.0:
            raise AssertionError(f"ivf_int8_scan disagrees with its plain version: {line}")
        results["ivf_int8_scan"].append(line)

    # (three_pass, kk, mask, is_l2)
    f32_cases = [(True, 16, None, True), (True, 32, keep, True), (False, 16, None, True),
                 (False, 32, keep, True), (True, 16, keep, False)]
    for three_pass, kk, mask, is_l2 in f32_cases:
        args = (blk, nrows, qf, rows, mask)
        kw = dict(B=B, kk=kk, is_l2=is_l2, three_pass=three_pass)
        s_k, p_k = ivf_cuda.f32_scan_tasks(*args, **kw)
        s_p, p_p = ivf_cuda.f32_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        ok = torch.allclose(s_k, s_p, rtol=F32_RTOL, atol=F32_ATOL)
        pos_eq = (p_k == p_p).float().mean().item()
        ms = time_ms(lambda: ivf_cuda.f32_scan_tasks(*args, **kw), reps=5)
        plain_ms = time_ms(lambda: ivf_cuda.f32_scan_plain(*args, **kw), reps=3)
        line = dict(three_pass=three_pass, kk=kk, mask=mask is not None, is_l2=is_l2, max_abs_err=err,
                    pos_agree=pos_eq, ms=ms, plain_ms=plain_ms)
        print("ivf_f32_scan", json.dumps(line))
        if not ok or pos_eq < F32_POS_AGREE:
            raise AssertionError(f"ivf_f32_scan disagrees with its plain version: {line}")
        results["ivf_f32_scan"].append(line)
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


def check_adc_kernel(dev):
    """ivf_adc_scan against adc_scan_plain: the main path's shape (4096 tasks,
    Qg=128, d=128, m=16, ksub=256), the 4-bit nibble layout (m=64, ksub=16)
    and the GIST shape (d=1024, m=96, ksub=256, 512 tasks)."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda

    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    # (n_tasks, n_blocks, d, m, sub, ksub, nib, [(kk, mask, is_l2), ...]);
    # GIST's m=96 codebooks cover 960 of the 1024 padded columns
    shapes = [
        (4096, 2048, 128, 16, 8, 256, False, [(16, False, True), (32, True, True), (16, False, False)]),
        (4096, 2048, 128, 64, 2, 16, True, [(16, False, True)]),
        (512, 256, 1024, 96, 10, 256, False, [(16, False, True), (16, True, True)]),
    ]
    for n_tasks, n_blocks, d, m, sub, ksub, nib, cases in shapes:
        blk, nrows, lids, q, books, clut, cents, nb_pad = _adc_case(g, dev, n_tasks, n_blocks, 128, d, m, sub, ksub)
        mb = m // 2 if nib else m
        codes = torch.randint(0, 256 if nib else ksub, (nb_pad + 2048, mb), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        keep = torch.rand(nb_pad + 2048, generator=g, device=dev) < 0.5
        for kk, masked, is_l2 in cases:
            args = (blk, nrows, lids, q, books, clut, cents, codes, keep if masked else None)
            kw = dict(B=512, kk=kk, is_l2=is_l2, nib=nib)
            s_k, p_k = adc_cuda.adc_scan_tasks(*args, **kw)
            s_p, p_p = adc_cuda.adc_scan_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (s_k - s_p).abs().max().item()
            ok = torch.allclose(s_k, s_p, rtol=ADC_RTOL, atol=ADC_ATOL)
            pos_eq = (p_k == p_p).float().mean().item()
            ms = time_ms(lambda: adc_cuda.adc_scan_tasks(*args, **kw), reps=5)
            plain_ms = time_ms(lambda: adc_cuda.adc_scan_plain(*args, **kw), reps=2)
            line = dict(tasks=n_tasks, d=d, m=m, ksub=ksub, nib=nib, kk=kk, mask=masked, is_l2=is_l2,
                        max_abs_err=err, pos_agree=pos_eq, ms=ms, plain_ms=plain_ms)
            print("ivf_adc_scan", json.dumps(line))
            if not ok or pos_eq < ADC_POS_AGREE:
                raise AssertionError(f"ivf_adc_scan disagrees with its plain version: {line}")
            out.append(line)
    return out


def check_flat_kernel(dev, xb: np.ndarray, xq: np.ndarray):
    import torch

    from knowhere_tpu_torch.ops import cuda_flat

    base = torch.from_numpy(xb).to(dev)
    out = []
    for is_l2, k in ((True, 10), (True, 100), (False, 10)):
        store = cuda_flat.FlatScanStore(base, None, is_l2)
        q = torch.nn.functional.pad(torch.from_numpy(xq[:1024]).to(dev), (0, store.d_pad - store.d))
        args = (store.base, store.nrm, q, k, store.a_coef)
        v_k, g_k = cuda_flat.flat_group_scan(*args)
        v_p, g_p = cuda_flat.flat_group_scan_plain(*args)
        torch.cuda.synchronize()
        err = (v_k - v_p).abs().max().item()
        bound = FLAT_ATOL + FLAT_RTOL * v_p.abs().max().item()
        gk, gp = g_k.cpu().numpy(), g_p.cpu().numpy()
        agree = np.mean([len(set(gk[i]) & set(gp[i])) / k for i in range(len(gk))])
        ms = time_ms(lambda: cuda_flat.flat_group_scan(*args), reps=5)
        plain_ms = time_ms(lambda: cuda_flat.flat_group_scan_plain(*args), reps=3)
        line = dict(nb=store.nb, nq=q.shape[0], k=k, is_l2=is_l2, max_abs_err=err, id_agree=agree,
                    ms=ms, plain_ms=plain_ms)
        print("flat_group_scan", json.dumps(line))
        if err > bound or agree < FLAT_ID_AGREE:
            raise AssertionError(f"flat_group_scan disagrees with its plain version: {line}")
        out.append(line)
        del store
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
    ids3, _ = _search(f32_idx, kt, xq, cfg_ivf)
    out["f32_scan_recall_at_10"] = recall_at(ids3, gt)
    if out["f32_scan_recall_at_10"] < F32_PATH_RECALL_FLOOR:
        raise AssertionError(f"f32-scan recall {out['f32_scan_recall_at_10']} < {F32_PATH_RECALL_FLOOR}")
    return out, flat, gt


def _flat_truth(kt, xb, xq, k=10):
    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    if flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}) != kt.Status.success:
        raise RuntimeError("FLAT Build failed")
    return flat, _search(flat, kt, xq, {"metric_type": "L2", "k": k})[0]


def _exact_vs_fast(kt, idx, xq, gt, cfg):
    """recall@k of EXACT (the plain decode scan) and FAST on the same queries;
    FAST must come within PQ_FAST_VS_EXACT."""
    kt.KnowhereConfig.SetSimdType("GENERIC")  # EXACT
    try:
        exact = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    finally:
        kt.KnowhereConfig.SetSimdType("AUTO")  # back to FAST
    fast = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    if fast < exact - PQ_FAST_VS_EXACT:
        raise AssertionError(f"IVF_PQ FAST recall {fast} < EXACT recall {exact} - {PQ_FAST_VS_EXACT}")
    return exact, fast


def pq_path(kt, xb, xq, gt, flat, search_reps=5):
    """IVF_PQ at the north-star configuration through the public API."""
    nq, k = len(xq), IVF_PQ_SEARCH["k"]
    out = {}
    pq = kt.IndexFactory.Instance().Create("IVF_PQ").value()
    st, out["pq_build_s"] = _timed(lambda: pq.Build(kt.GenDataSetFromArray(xb), IVF_PQ_BUILD))
    if st != kt.Status.success:
        raise RuntimeError(f"IVF_PQ Build: {st.name}")
    ids, dists = _search(pq, kt, xq, IVF_PQ_SEARCH)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(pq, kt, xq, IVF_PQ_SEARCH))
        times.append(dt)
    out["pq_search_s_median"] = float(np.median(times))
    out["pq_search_s_all"] = times
    out["pq_qps"] = nq / out["pq_search_s_median"]
    out["pq_recall_at_10"] = recall_at(ids, gt)
    out["pq_tpu_anchor_recall_at_10"] = PQ_TPU_ANCHOR  # the reference's, not the port's
    if not np.isfinite(dists).all() or ids.shape != (nq, k) or (ids < 0).any():
        raise AssertionError("IVF_PQ results not finite / wrong shape / short")
    if out["pq_recall_at_10"] < PQ_RECALL_FLOOR:
        raise AssertionError(f"IVF_PQ recall@10 {out['pq_recall_at_10']} < {PQ_RECALL_FLOOR}")

    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    fids, _ = _search(pq, kt, xq, IVF_PQ_SEARCH, kt.BitsetView.from_bool_array(drop))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError("IVF_PQ filtered search returned a filtered or empty id")
    fgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": k}, kt.BitsetView.from_bool_array(drop))
    out["pq_filtered_recall_at_10"] = recall_at(fids, fgt)

    bs = kt.BinarySet()
    if pq.Serialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_PQ Serialize failed")
    again = kt.IndexFactory.Instance().Create("IVF_PQ").value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_PQ Deserialize failed")
    out["pq_roundtrip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, IVF_PQ_SEARCH)[0], ids))
    if not out["pq_roundtrip_ids_identical"]:
        raise AssertionError("IVF_PQ Serialize/Deserialize changed the result ids")
    del again

    out["pq_exact_recall_1k"], out["pq_fast_recall_1k"] = _exact_vs_fast(
        kt, pq, xq[:1000], gt[:1000], IVF_PQ_SEARCH
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
    from knowhere_tpu_torch.ops import adc_cuda, cuda_build, cuda_flat, ivf_cuda

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

    kt.KnowhereConfig.SetSimdType("AUTO")  # FAST: the kernels' serving scans
    wrappers = {
        "ivf_int8_scan": ivf_cuda.int8_scan_tasks,
        "ivf_f32_scan": ivf_cuda.f32_scan_tasks,
        "flat_group_scan": cuda_flat.flat_group_scan,
        "ivf_adc_scan": adc_cuda.adc_scan_tasks,
    }
    (e2e, flat, gt), counts = _run_path(
        "main path", wrappers, ("ivf_int8_scan", "ivf_f32_scan", "flat_group_scan"),
        lambda: main_path(kt, xb, xq),
    )
    print("main path:", json.dumps(e2e))
    launches = dict(counts)
    pq_out, counts = _run_path("ivf_pq path", wrappers, ("ivf_adc_scan",), lambda: pq_path(kt, xb, xq, gt, flat))
    print("ivf_pq path:", json.dumps(pq_out))
    launches["ivf_adc_scan"] = counts["ivf_adc_scan"]
    del flat
    gist_out, _ = _run_path("gist ivf_pq path", wrappers, ("ivf_adc_scan", "flat_group_scan"), lambda: gist_pq_path(kt))
    print("gist ivf_pq path:", json.dumps(gist_out))
    torch.cuda.synchronize()

    first = {name: lines[0] for name, lines in (
        ("ivf_int8_scan", ivf_checks["ivf_int8_scan"]),
        ("ivf_f32_scan", ivf_checks["ivf_f32_scan"]),
        ("flat_group_scan", flat_checks),
        ("ivf_adc_scan", adc_checks),
    )}
    meta = {
        "ivf_int8_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:400"),
        "ivf_f32_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:113"),
        "flat_group_scan": ("knowhere_tpu_torch/csrc/flat_scan.cu", "knowhere_tpu/ops/pallas_flat.py:62"),
        "ivf_adc_scan": (
            "knowhere_tpu_torch/csrc/ivf_adc.cu",
            "knowhere_tpu/ops/ivf_pallas.py:556 and knowhere_tpu/ops/ivf_pallas.py:732",
        ),
    }
    kernels = [
        {
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": launches[name], "max_abs_err": first[name]["max_abs_err"],
            "ms": first[name]["ms"], "plain_ms": first[name]["plain_ms"],
        }
        for name in wrappers
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
