"""A/B of the IVF_PQ ADC scan kernel (knowhere_tpu_torch/csrc/ivf_adc.cu) on one card.

Builds with ``nvcc -Xptxas -v`` (each instance's registers and spills are
printed, and ``cuobjdump -sass``'s count of tensor-core instructions in each
``ivf_adc_scan_kernel`` instance) into ``build/adc_ab/``:

- ``other``: the same file of another tree (``--other DIR``, a checkout such
  as ``git archive`` of an earlier commit unpacked into a gitignored
  directory);
- ``this``: this tree's ``ivf_adc.cu`` as the port builds it;
- ``nofix``: a copy of this tree's file with the midpoint rewrite taken out
  (no window pass in ``chunk_image``, no ``fix_marked``): every LUT entry is
  the tensor cores' sum, rounded. It measures what the rewrite costs and
  what it buys.

It runs them on the inputs of ``chip_smoke.check_adc_kernel`` (same seeds),
SIFT kk=32 unmasked, and with ``--real`` on the launches of one IVF_PQ
search at chip_smoke's north-star configuration. Each case prints one JSON
line: for each library, how many scores and positions differ from the other
tree's kernel and from ``adc_scan_plain`` on the card, the largest score
difference from each, and whether it agrees with each within chip_smoke's
ADC tolerance (scores within ADC_RTOL / ADC_ATOL, positions on >=
ADC_POS_AGREE of the slots, empty slots the same, each exactly (-1e38, -1))
or, on the exact tie grid, bit for bit; then each library's median ms (CUDA
events, in turns: forwards, then backwards). Exits 1 if this tree's kernel
misses either agreement anywhere.

Run from the repository root on the card:

    python3 adc_ab.py --other .scratch/parent [--real]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
# the edits that take the midpoint rewrite out of a copy of ivf_adc.cu
NOFIX = (
    ("  for (int jj = warp; jj < g.MC; jj += kAdcWarps) {", "  for (int jj = g.MC; jj < g.MC; jj += kAdcWarps) {"),
    ("    win[e] = __uint_as_float(lds_u32(x.qn + 4 * (ok ? J - j0 : 0)));", "    win[e] = 0.f;"),
    ("    if (mk) fix_marked<SUB>(mk, sl, x, g, books, clut_l, j0, ksub, sub, l2, lane);", "    (void)mk;"),
)


def sources(other: Path) -> dict:
    """name -> source file; the nofix copy is written into OUT."""
    src = CSRC / "ivf_adc.cu"
    text = src.read_text()
    for old, new in NOFIX:
        if text.count(old) != 1:
            raise SystemExit(f"adc_ab: the nofix edit no longer applies: {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nofix.cu").write_text(text)
    return {"other": other / "knowhere_tpu_torch" / "csrc" / "ivf_adc.cu", "this": src, "nofix": OUT / "nofix.cu"}


def tensor_core_counts(so: Path) -> dict:
    """cuobjdump -sass of a library: HGMMA / HMMA instructions in each
    ivf_adc_scan_kernel instance."""
    sass = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "ivf_adc_scan_kernel" in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and ("HGMMA" in ln or "HMMA" in ln):
            counts[name] += 1
    return counts


def build(srcs: dict) -> dict:
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
        print(f"[{name}] tensor-core instructions per instance:", json.dumps(tensor_core_counts(OUT / f"{name}.so")))
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.kw_ivf_adc_scan.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.kw_ivf_adc_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, args, kk, is_l2, nib):
    import torch

    blk, nrows, lids, q, books, clut, cents, codes, keep = args
    Tc, Qg, d = q.shape
    m, ksub, sub = books.shape
    out_s = torch.empty((Tc, Qg, kk), dtype=torch.float32, device=q.device)
    out_p = torch.empty((Tc, Qg, kk), dtype=torch.int32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    keep_u8 = None if keep is None else keep.view(torch.uint8)
    code = lib.kw_ivf_adc_scan(ptr(blk), ptr(nrows), ptr(lids), ptr(q), ptr(books), ptr(clut), ptr(cents),
                               ptr(codes), ptr(keep_u8), ptr(out_s), ptr(out_p), Tc, Qg, d, m, ksub, sub, kk,
                               int(is_l2), int(nib), torch.cuda.current_stream().cuda_stream)
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
    import torch

    import chip_smoke
    from knowhere_tpu_torch.ops import adc_cuda

    args = tuple(None if a is None else a.contiguous() for a in args)
    res = {n: launch(lib, args, kk, is_l2, nib) for n, lib in libs.items()}
    plain = adc_cuda.adc_scan_plain(*args, B=512, kk=kk, is_l2=is_l2, nib=nib)
    torch.cuda.synchronize()
    m, ksub, sub = args[4].shape
    line = dict(case=name, m=m, ksub=ksub, sub=sub, kk=kk, is_l2=is_l2, nib=nib, mask=args[-1] is not None,
                ties=ties, slots=plain[1].numel(), empty_tasks=int((args[1] <= 0).sum()), **desc)
    for n, (s, p) in res.items():
        if n != "other":
            line.update({f"{n}_{k}": v for k, v in agreement(s, p, *res["other"], ties).items()})
        line.update({f"{n}_plain_{k}": v for k, v in agreement(s, p, *plain, ties).items()})
    times = {n: [] for n in libs}
    for n in list(libs) + list(libs)[::-1]:
        times[n].append(chip_smoke.time_ms(lambda n=n: launch(libs[n], args, kk, is_l2, nib), reps=reps))
    line.update({f"{n}_ms": t for n, t in times.items()})
    print("adc_ab", json.dumps(line), flush=True)
    return line


def table_cases(libs):
    """check_adc_kernel's cases on the same inputs, then SIFT kk=32 unmasked."""
    import torch

    import chip_smoke

    dev = torch.device("cuda")
    out = []
    for args, kk, is_l2, nib, desc in chip_smoke.adc_cases(dev):
        d = args[3].shape[2]
        out.append(compare(libs, f"d{d}", args, kk, is_l2, nib, reps=3 if desc.get("ties") else 10, **desc))
    sift = [chip_smoke.ADC_SHAPES[0][:7] + ([(32, False, True)], False)]
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
        live = args[1] > 0
        out.append(compare(libs, "real", args[:9], kw["kk"], kw["is_l2"], kw["nib"],
                           mean_live_nrows=float(args[1][live].float().mean())))
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
    libs = build(sources(a.other.resolve()))
    lines = table_cases(libs) + (real_launches(libs) if a.real else [])
    for n in libs:
        for ref in (("other", "plain") if n != "other" else ("plain",)):
            key = f"{n}_ok" if ref == "other" else f"{n}_plain_ok"
            print(f"adc_ab: {n} agrees with {ref} on every case:", all(ln[key] for ln in lines))
    ok = all(ln["this_ok"] and ln["this_plain_ok"] for ln in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
