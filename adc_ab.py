"""A/B of the IVF_PQ ADC kernels (knowhere_tpu_torch/csrc/ivf_adc.cu) on one card.

Builds with ``nvcc -Xptxas -v`` (each kernel's registers and spills are
printed) into ``build/adc_ab/``:

- ``other``: the same file of another tree (``--other DIR``, a checkout such
  as ``git archive`` of an earlier commit unpacked into a gitignored
  directory). A file without ``kw_ivf_adc_qtable`` is launched through its
  older interface: each launch takes its tasks' query groups gathered
  (``q[qids]``, outside the timing), the codebooks and the sub width, and
  builds the table a task;
- ``this``: this tree's ``ivf_adc.cu`` as the port builds it: the table once
  (``kw_ivf_adc_qtable``), then the scan reads its rows by query id.

It runs them on the inputs of ``chip_smoke.check_adc_kernel`` (same seeds),
SIFT kk=32 unmasked, and with ``--real`` on the launches of one IVF_PQ
search at chip_smoke's north-star configuration. Each case prints one JSON
line: for each library, how many scores and positions differ from the other
tree's kernel and from ``adc_scan_plain`` on the card (on this tree's
table), the largest score difference from each, and whether it agrees with
each within chip_smoke's ADC tolerance (scores within ADC_RTOL / ADC_ATOL,
positions on >= ADC_POS_AGREE of the slots, empty slots the same, each
exactly (-1e38, -1)) or, on the exact tie grid, bit for bit; then each
library's median ms of the scan (CUDA events, in turns: forwards, then
backwards) and of each table-building library's table. Exits 1 if this
tree's scan misses either agreement anywhere.

Run from the repository root on the card:

    python3 adc_ab.py --other .scratch/parent [--real]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "knowhere_tpu_torch" / "csrc"
OUT = ROOT / "build" / "adc_ab"
CUDA_BIN = Path("/usr/local/cuda/bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-I", str(CSRC)]
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(srcs: dict) -> dict:
    """name -> (library, whether it builds the table once)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([str(CUDA_BIN / "nvcc"), *FLAGS, "-o", str(OUT / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, src in srcs.items()}
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"adc_ab: nvcc failed for {name}:\n{err[-4000:]}")
        for ln in err.splitlines():
            if "Function properties" in ln or "Used" in ln or "spill" in ln or "arning" in ln:
                print(f"[{name}] {ln.strip()[:200]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        table = hasattr(lib, "kw_ivf_adc_qtable")
        if table:
            lib.kw_ivf_adc_qtable.argtypes = [_P] * 3 + [_I] * 6 + [_P]
            lib.kw_ivf_adc_scan.argtypes = [_P] * 12 + [_I] * 8 + [_P]
        else:
            lib.kw_ivf_adc_scan.argtypes = [_P] * 11 + [_I] * 9 + [_P]
        libs[name] = (lib, table)
    return libs


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def qtable(lib, q, books, is_l2):
    import torch

    m, ksub, sub = books.shape
    out = torch.empty((q.shape[0], m * ksub), dtype=torch.float32, device=q.device)
    code = lib.kw_ivf_adc_qtable(q.data_ptr(), books.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1], m, ksub,
                                 sub, int(is_l2), _stream())
    if code != 0:
        raise RuntimeError(f"kw_ivf_adc_qtable failed: cudaError {code}")
    return out


def launch(lib, table, inputs, kk, is_l2, nib):
    """One scan launch: inputs = (blk, nrows, lids, qids, q, books, clut,
    cents, codes, keep, qtab or q_task)."""
    import torch

    blk, nrows, lids, qids, q, books, clut, cents, codes, keep, extra = inputs
    Tc, Qg = qids.shape
    m, ksub, sub = books.shape
    d = q.shape[1]
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    keep_u8 = None if keep is None else keep.view(torch.uint8)
    if table:
        code = lib.kw_ivf_adc_scan(ptr(blk), ptr(nrows), ptr(lids), ptr(qids), ptr(q), ptr(extra), ptr(clut),
                                   ptr(cents), ptr(codes), ptr(keep_u8), ptr(out_s), ptr(out_p), Tc, Qg, d, m, ksub,
                                   kk, int(is_l2), int(nib), _stream())
    else:
        code = lib.kw_ivf_adc_scan(ptr(blk), ptr(nrows), ptr(lids), ptr(extra), ptr(books), ptr(clut), ptr(cents),
                                   ptr(codes), ptr(keep_u8), ptr(out_s), ptr(out_p), Tc, Qg, d, m, ksub, sub, kk,
                                   int(is_l2), int(nib), _stream())
    if code != 0:
        raise RuntimeError(f"kw_ivf_adc_scan failed: cudaError {code}")
    return out_s, out_p


def agreement(s, p, ref_s, ref_p, exact: bool) -> dict:
    """How (s, p) differ from (ref_s, ref_p), and whether they agree as
    chip_smoke holds the kernel to its plain version."""
    import torch

    import chip_smoke

    empty = ref_p == -1
    sentinels = bool(torch.equal(p == -1, empty) and (s[empty] == -1e38).all())
    if exact:
        close = bool(torch.equal(s.view(torch.int32), ref_s.view(torch.int32)) and torch.equal(p, ref_p))
    else:
        close = bool(torch.allclose(s, ref_s, rtol=chip_smoke.ADC_RTOL, atol=chip_smoke.ADC_ATOL)
                     and (p == ref_p).float().mean().item() >= chip_smoke.ADC_POS_AGREE)
    return {"score_diff": int((s.view(torch.int32) != ref_s.view(torch.int32)).sum()),
            "pos_diff": int((p != ref_p).sum()), "max_abs_diff": float((s - ref_s).abs().max()),
            "ok": close and sentinels}


def compare(libs, name, args, kk, is_l2, nib, reps=10, ties=False, **desc):
    """args = (blk, nrows, lids, qids, q, books, clut, cents, codes, keep)."""
    import torch

    import chip_smoke
    from knowhere_tpu_torch.ops import adc_cuda

    args = tuple(None if a is None else a.contiguous() for a in args)
    blk, nrows, lids, qids, q, books, clut, cents, codes, keep = args
    blk, nrows, lids, qids = blk.int(), nrows.int(), lids.int(), qids.int()  # the search passes int64 ids
    args = (blk, nrows, lids, qids, q, books, clut, cents, codes, keep)
    m, ksub, sub = books.shape
    q_task = q[qids.long()]
    inputs = {n: (*args, qtable(lib, q, books, is_l2) if table else q_task) for n, (lib, table) in libs.items()}
    res = {n: launch(*libs[n], inputs[n], kk, is_l2, nib) for n in libs}
    plain = adc_cuda.adc_scan_plain(blk, nrows, lids, qids, q, inputs["this"][-1], clut, cents, codes, keep, m=m,
                                    B=512, kk=kk, is_l2=is_l2, nib=nib)
    torch.cuda.synchronize()
    line = dict(case=name, m=m, ksub=ksub, sub=sub, kk=kk, is_l2=is_l2, nib=nib, mask=keep is not None, ties=ties,
                slots=plain[1].numel(), empty_tasks=int((nrows <= 0).sum()), **desc)
    for n, (s, p) in res.items():
        if n != "other":
            line.update({f"{n}_{k}": v for k, v in agreement(s, p, *res["other"], ties).items()})
        line.update({f"{n}_plain_{k}": v for k, v in agreement(s, p, *plain, ties).items()})
    times = {n: [] for n in libs}
    for n in list(libs) + list(libs)[::-1]:
        times[n].append(chip_smoke.time_ms(lambda n=n: launch(*libs[n], inputs[n], kk, is_l2, nib), reps=reps))
    line.update({f"{n}_ms": t for n, t in times.items()})
    for n, (lib, table) in libs.items():
        if table:
            line[f"{n}_qtable_ms"] = chip_smoke.time_ms(lambda lib=lib: qtable(lib, q, books, is_l2), reps=reps)
    print("adc_ab", json.dumps(line), flush=True)
    return line


def table_cases(libs):
    """check_adc_kernel's cases on the same inputs, then SIFT kk=32 unmasked."""
    import torch

    import chip_smoke

    dev = torch.device("cuda")
    out = []
    for args, kk, is_l2, nib, desc in chip_smoke.adc_cases(dev):
        d = args[4].shape[1]
        out.append(compare(libs, f"d{d}", args, kk, is_l2, nib, reps=3 if desc.get("ties") else 10, **desc))
    sift = [chip_smoke.ADC_SHAPES[0][:8] + ([(32, False, True)], False)]
    for args, kk, is_l2, nib, desc in chip_smoke.adc_cases(dev, sift):
        out.append(compare(libs, "d128", args, kk, is_l2, nib, **desc))
    return out


def real_launches(libs):
    """The ADC launches of one IVF_PQ search at chip_smoke's north-star
    configuration (1M x 128 SIFT-like corpus, 10,000 queries)."""
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops import ivf_scan

    import chip_smoke

    kt.set_device("cuda")
    kt.KnowhereConfig.SetSimdType("AUTO")
    xb, xq = chip_smoke.gen_corpus(1_000_000, 10_000, 128, seed=0)
    idx = kt.IndexFactory.Instance().Create("IVF_PQ").value()
    t0 = time.perf_counter()
    if idx.Build(kt.GenDataSetFromArray(xb), chip_smoke.IVF_PQ_BUILD) != kt.Status.success:
        raise RuntimeError("IVF_PQ Build failed")
    print(f"IVF_PQ built in {time.perf_counter() - t0:.1f} s", flush=True)
    books = idx.node._store["books"]
    real, calls = ivf_scan.adc_scan_tasks, []

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    ivf_scan.adc_scan_tasks = capture
    try:
        chip_smoke._search(idx, kt, xq, chip_smoke.IVF_PQ_SEARCH)
    finally:
        ivf_scan.adc_scan_tasks = real
    out = []
    for args, kw in calls:
        blk, nrows, lids, qids, q, _, clut, cents, codes, keep = args
        live = nrows > 0
        out.append(compare(libs, "real", (blk, nrows, lids, qids, q, books, clut, cents, codes, keep), kw["kk"],
                           kw["is_l2"], kw["nib"], mean_live_nrows=float(nrows[live].float().mean())))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other tree (a checkout)")
    ap.add_argument("--real", action="store_true", help="also the launches of one real IVF_PQ search")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("adc_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build({"other": a.other.resolve() / "knowhere_tpu_torch" / "csrc" / "ivf_adc.cu", "this": CSRC / "ivf_adc.cu"})
    lines = table_cases(libs) + (real_launches(libs) if a.real else [])
    for n in libs:
        for ref in (("other", "plain") if n != "other" else ("plain",)):
            key = f"{n}_ok" if ref == "other" else f"{n}_plain_ok"
            print(f"adc_ab: {n} agrees with {ref} on every case:", all(ln[key] for ln in lines))
    ok = all(ln["this_ok"] and ln["this_plain_ok"] for ln in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
