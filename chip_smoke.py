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
   index served by the f32 scan (KNOWHERE_DISABLE_INT8_SCAN=1). Kernel
   launch counters are zeroed right before this phase and read after it;
5. print the kernel summary, the card line, and the contract line
   {"ok": true, "device": {...}} last.

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
    serialize round trip and the f32-scan path, all through the public API."""
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
    return out


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
    from knowhere_tpu_torch.ops import cuda_build, cuda_flat, ivf_cuda

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
    t0 = time.perf_counter()
    xb, xq = gen_corpus(1_000_000, 10_000, 128, seed=0)
    print(f"corpus 1000000 x 128, 10000 queries, made in {time.perf_counter() - t0:.2f} s")
    flat_checks = check_flat_kernel(dev, xb, xq)

    kt.KnowhereConfig.SetSimdType("AUTO")  # FAST: the int8 serving scan
    wrappers = {
        "ivf_int8_scan": ivf_cuda.int8_scan_tasks,
        "ivf_f32_scan": ivf_cuda.f32_scan_tasks,
        "flat_group_scan": cuda_flat.flat_group_scan,
    }
    for w in wrappers.values():
        w.launches = 0
    e2e = main_path(kt, xb, xq)
    launches = {name: w.launches for name, w in wrappers.items()}
    print("main path:", json.dumps(e2e))
    print("launches:", json.dumps(launches))
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    torch.cuda.synchronize()

    first = {name: lines[0] for name, lines in (
        ("ivf_int8_scan", ivf_checks["ivf_int8_scan"]),
        ("ivf_f32_scan", ivf_checks["ivf_f32_scan"]),
        ("flat_group_scan", flat_checks),
    )}
    meta = {
        "ivf_int8_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:400"),
        "ivf_f32_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:113"),
        "flat_group_scan": ("knowhere_tpu_torch/csrc/flat_scan.cu", "knowhere_tpu/ops/pallas_flat.py:62"),
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
