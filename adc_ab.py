"""A/B of the IVF_PQ ADC scan kernel (knowhere_tpu_torch/csrc/ivf_adc.cu) on one card.

Builds four libraries with ``nvcc -Xptxas -v`` (each instance's registers
and spills are printed) into ``build/adc_ab/``:

- ``this``: this tree's ``ivf_adc.cu``;
- ``other``: the same file of another tree (``--other DIR``, a checkout such
  as ``git archive`` of the parent commit unpacked into a gitignored
  directory);
- ``sorted`` and ``rounds``: this tree's file with only the selection
  changed. ``sorted`` sorts each lane's 16 scores with ivf_task_scan.cuh's
  ``sort_desc`` and has one thread merge the warp's 32 lists, as the task
  scan merges its P lists; ``rounds`` runs kk rounds of (warp maximum,
  leftmost column).

It runs all four on the inputs of ``chip_smoke.check_adc_kernel`` (same
seeds), SIFT kk=32 unmasked, and with ``--real`` on the launches of one
IVF_PQ search at chip_smoke's north-star configuration. Each case prints
one JSON line: whether each library's scores and positions equal the other
tree's bit for bit, and each library's median ms (CUDA events, in turns:
forwards, then backwards). Exits 1 if ``this`` differs from ``other``
anywhere: the two trees must compute the same bits.

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
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]
SELECT = "      warp_topk_select<kAdcNJ>(acc, kk, b * kB, sel_s + warp * kB, sel_c + warp * kB, out_s + o, out_p + o);"
SORTED = """      int lp[kAdcNJ];
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) lp[j] = lane + 32 * j;
      sort_desc<kAdcNJ>(acc, lp);
      float* lsm = sel_s + warp * kB;
      uint16_t* lpm = sel_c + warp * kB;
#pragma unroll
      for (int j = 0; j < kAdcNJ; ++j) {
        lsm[j * 32 + lane] = acc[j];
        lpm[j * 32 + lane] = lp[j];
      }
      __syncwarp();
      if (lane == 0) {
        int h[32];
#pragma unroll
        for (int p = 0; p < 32; ++p) h[p] = 0;
        for (int r = 0; r < kk; ++r) {
          float bs = 0.f;
          int bp = INT_MAX, bi = -1;
#pragma unroll
          for (int p = 0; p < 32; ++p) {
            if (h[p] >= kAdcNJ) continue;
            const float sv = lsm[h[p] * 32 + p];
            const int ps = lpm[h[p] * 32 + p];
            if (bi < 0 || sv > bs || (sv == bs && ps < bp)) {
              bs = sv;
              bp = ps;
              bi = p;
            }
          }
#pragma unroll
          for (int p = 0; p < 32; ++p) h[p] += (p == bi);
          out_s[o + r] = bs;
          out_p[o + r] = bs <= KW_NEG_INF * 0.5f ? -1 : b * kB + bp;
        }
      }"""
ROUNDS = """      for (int r = 0; r < kk; ++r) {
        float m = acc[0];
        int mj = 0;
#pragma unroll
        for (int j = 1; j < kAdcNJ; ++j) {
          if (acc[j] > m) {
            m = acc[j];
            mj = j;
          }
        }
        float wm = m;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, s));
        int col = (m == wm) ? (lane + 32 * mj) : INT_MAX;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) col = min(col, __shfl_xor_sync(0xffffffffu, col, s));
        if (lane == (col & 31)) {
#pragma unroll
          for (int j = 0; j < kAdcNJ; ++j)
            if (j == (col >> 5)) acc[j] = KW_NEG_INF;
        }
        if (lane == 0) {
          out_s[o + r] = wm;
          out_p[o + r] = (wm <= KW_NEG_INF * 0.5f) ? -1 : b * kB + col;
        }
      }"""


def sources(other: Path) -> dict:
    """name -> (source file, include flags); the variants go to OUT."""
    src = (CSRC / "ivf_adc.cu").read_text()
    if src.count(SELECT) != 1:
        raise SystemExit("adc_ab: this tree's ivf_adc.cu has no warp_topk_select call to vary")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sorted.cu").write_text(src.replace(SELECT, SORTED).replace(
        '#include "topk_common.cuh"\n', '#include "ivf_task_scan.cuh"\n'))
    (OUT / "rounds.cu").write_text(src.replace(SELECT, ROUNDS))
    other_csrc = other / "knowhere_tpu_torch" / "csrc"
    inc = [f"-I{CSRC}"]
    return {"other": (other_csrc / "ivf_adc.cu", []), "this": (CSRC / "ivf_adc.cu", []),
            "sorted": (OUT / "sorted.cu", inc), "rounds": (OUT / "rounds.cu", inc)}


def build(srcs: dict) -> dict:
    procs = {name: subprocess.Popen([NVCC, *FLAGS, *inc, "-o", str(OUT / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (src, inc) in srcs.items()}
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"adc_ab: nvcc failed for {name}:\n{err[-4000:]}")
        for ln in err.splitlines():
            if "Function properties" in ln or "Used" in ln or "spill" in ln:
                print(f"[{name}] {ln.strip()[:160]}")
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


def compare(libs, name, args, kk, is_l2, nib, reps=10, **desc):
    import torch

    import chip_smoke

    args = tuple(None if a is None else a.contiguous() for a in args)
    res = {n: launch(lib, args, kk, is_l2, nib) for n, lib in libs.items()}
    torch.cuda.synchronize()
    ref_s, ref_p = res["other"]
    line = dict(case=name, kk=kk, is_l2=is_l2, nib=nib, mask=args[-1] is not None, empty_tasks=int((args[1] <= 0).sum()),
                **desc)
    for n, (s, p) in res.items():
        line[f"{n}_bit_equal"] = bool(torch.equal(s.view(torch.int32), ref_s.view(torch.int32)) and torch.equal(p, ref_p))
    times = {n: [] for n in libs}
    for n in list(libs) + list(libs)[::-1]:
        times[n].append(chip_smoke.time_ms(lambda n=n: launch(libs[n], args, kk, is_l2, nib), reps=reps))
    line.update({f"{n}_ms": t for n, t in times.items()})
    print("adc_ab", json.dumps(line), flush=True)
    return line


def table_cases(libs):
    """check_adc_kernel's cases on the same inputs, and kk=32 unmasked."""
    import torch

    import chip_smoke

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = [
        (4096, 2048, 128, 16, 8, 256, False, [(16, False, True), (32, True, True), (16, False, False), (32, False, True)]),
        (4096, 2048, 128, 64, 2, 16, True, [(16, False, True)]),
        (512, 256, 1024, 96, 10, 256, False, [(16, False, True), (16, True, True)]),
    ]
    out = []
    for n_tasks, n_blocks, d, m, sub, ksub, nib, cases in shapes:
        blk, nrows, lids, q, books, clut, cents, nb_pad = chip_smoke._adc_case(g, dev, n_tasks, n_blocks, 128, d, m,
                                                                               sub, ksub)
        mb = m // 2 if nib else m
        codes = torch.randint(0, 256 if nib else ksub, (nb_pad + 2048, mb), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        keep = torch.rand(nb_pad + 2048, generator=g, device=dev) < 0.5
        for kk, masked, is_l2 in cases:
            args = (blk, nrows, lids, q, books, clut, cents, codes, keep if masked else None)
            out.append(compare(libs, f"m{m}_d{d}", args, kk, is_l2, nib))
        if nib or d != 128:
            continue
        nrows_e = nrows.clone()
        nrows_e[::4] = 0
        out.append(compare(libs, "empty_quarter", (blk, nrows_e, lids, q, books, clut, cents, codes, keep), 32, True,
                           nib))
        g2 = torch.Generator(device=dev).manual_seed(5)
        qg, books_g, clut_g, cents_g, codes_g = chip_smoke._adc_grid(g2, dev, m, ksub, sub, d, 1024, n_tasks, 128,
                                                                    nb_pad + 2048)
        for kk, masked, is_l2 in [(32, True, True), (16, False, False)]:
            args = (blk, nrows, lids, qg, books_g, clut_g, cents_g, codes_g, keep if masked else None)
            out.append(compare(libs, "ties", args, kk, is_l2, nib, reps=3))
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
        print(f"adc_ab: {n} bit-equal to other on every case:", all(ln[f"{n}_bit_equal"] for ln in lines))
    return 0 if all(ln["this_bit_equal"] for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
