"""A/B of the kernels of knowhere_tpu_torch/csrc/flat_scan.cu on one card.

The file holds FLAT's three-pass group max, FLAT's select, and the fused
scan's single-pass group max (another instance of the same template) and
rescore. Builds with ``nvcc -Xptxas -v`` (every kernel's registers and
spills are printed) into ``build/fused_ab/``:

- ``other``: the same file of another tree (``--other DIR``, a checkout such
  as ``git archive`` of an earlier commit unpacked into a gitignored
  directory);
- ``this``: this tree's ``flat_scan.cu`` as the port builds it;
- ``noepi``: a copy that runs the group-max epilogue for the last query
  tile only (its maxima are wrong, so it is timed and not compared): what
  the products, loads and barriers cost without the epilogue.

Then, on chip_smoke's inputs (the 1M x 128 SIFT-like corpus, 1,024 queries):

- whether each kernel of the file compiles to the same SASS in ``other``
  and ``this`` (``cuobjdump -sass``, addresses and encodings dropped; the
  count of differing instructions otherwise; a kernel the other tree lacks
  is reported so);
- FLAT's group maxima and select outputs of ``this`` against ``other``, bit
  for bit (L2 k=10 and 100, IP k=10, and d=256 on a random corpus), and both
  launches' times in turns (other, this, this, other);
- the single-pass group max of ``this`` and ``noepi`` in turns (L2 and IP,
  and d=256), with the other tree's where it has the fused scan (its group
  maxima and rescore outputs then held to this tree's bit for bit), and the
  select and rescore launches' times at k=10 and 100.

Each case prints one JSON line (medians of CUDA events). Exits 1 if an
output of a kernel both trees hold differs.
Run from the repository root on the card:

    python3 fused_ab.py --other .scratch/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "knowhere_tpu_torch" / "csrc"
OUT = ROOT / "build" / "fused_ab"
CUDA_BIN = Path("/usr/local/cuda/bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]
# copies of this tree's file, each with one edit; timed only (their outputs are wrong)
VARIANTS = {
    # the epilogue of the last query tile alone
    "noepi": ("    if (kc != kc_n - 1) continue;\n", "    if (kc != kc_n - 1 || s + 1 < steps) continue;\n"),
}
# SASS function names: FLAT's group max (the other tree's may predate the
# template), FLAT's select, the single-pass group max, the rescore
KERNELS = {"flat_group_max": ("flat_group_max_kernel", "group_max_kernelILb1E"), "flat_select": ("flat_select_kernel",),
           "fused_group_max": ("group_max_kernelILb0E",), "fused_rescore": ("fused_rescore_kernel",)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "kw_flat_group_max": [_P] * 4 + [_I] * 3 + [_F, _P],
    "kw_fused_group_max": [_P] * 4 + [_I] * 3 + [_F, _P],
    "kw_flat_select": [_P, _I, _I, _I, _P, _P, _P],
    "kw_fused_rescore": [_P] * 4 + [_I] * 4 + [_F, _P, _P, _P],
}


def sources(other: Path) -> dict:
    """name -> source file; the variants' copies are written into OUT and
    built with an include path back to csrc."""
    src = CSRC / "flat_scan.cu"
    text = src.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    out = {"other": other / "knowhere_tpu_torch" / "csrc" / "flat_scan.cu", "this": src}
    for name, (old, new) in VARIANTS.items():
        if text.count(old) != 1:
            raise SystemExit(f"fused_ab: the {name} edit no longer applies: {old!r}")
        (OUT / f"{name}.cu").write_text(text.replace(old, new))
        out[name] = OUT / f"{name}.cu"
    return out


def sass(so: Path) -> dict:
    """cuobjdump -sass of a library: function name -> its instructions."""
    text = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", ln)
        if m and name:
            funcs[name].append(m.group(1))
    return funcs


def sass_compare(libs_so: dict) -> dict:
    """The file's kernels in other and this: identical instructions, or how many differ."""
    a, b = sass(libs_so["other"]), sass(libs_so["this"])
    out = {}
    for kernel, keys in KERNELS.items():
        fa = [n for n in a if any(k in n for k in keys)]
        fb = [n for n in b if any(k in n for k in keys)]
        if not fa and len(fb) == 1:
            out[kernel] = "not in the other tree"
            continue
        if len(fa) != 1 or len(fb) != 1:
            out[kernel] = f"not found: {fa} / {fb}"
            continue
        ia, ib = a[fa[0]], b[fb[0]]
        diff = sum(x != y for x, y in zip(ia, ib)) + abs(len(ia) - len(ib))
        out[kernel] = {"identical": ia == ib, "instructions": [len(ia), len(ib)], "differing": diff,
                       "hgmma": [sum("HGMMA" in x for x in ia), sum("HGMMA" in x for x in ib)]}
    return out


def build(srcs: dict) -> dict:
    procs = {name: subprocess.Popen([str(CUDA_BIN / "nvcc"), *FLAGS, "-I", str(CSRC), "-o", str(OUT / f"{name}.so"),
                                     str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, src in srcs.items()}
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"fused_ab: nvcc failed for {name}:\n{err[-4000:]}")
        for ln in err.splitlines():
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln or "arning" in ln:
                print(f"[{name}] {ln.strip()[:220]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn, argtypes in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, fn: str, *args) -> None:
    import torch

    code = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn} failed: cudaError {code}")


def group_max(lib, fn, base, nrm, q_op, a):
    import torch

    nb_pad, d = base.shape
    nq_pad = q_op.shape[0] * 128
    gmax = torch.empty((nq_pad, nb_pad // 16), dtype=torch.float32, device=base.device)
    _call(lib, fn, base.data_ptr(), nrm.data_ptr(), q_op.data_ptr(), gmax.data_ptr(), nb_pad, nq_pad, d, a)
    return gmax


def select(lib, gmax, nq, k):
    import torch

    v = torch.empty((nq, k), dtype=torch.float32, device=gmax.device)
    g = torch.empty((nq, k), dtype=torch.int32, device=gmax.device)
    _call(lib, "kw_flat_select", gmax.data_ptr(), gmax.shape[1], nq, k, v.data_ptr(), g.data_ptr())
    return v, g


def rescore(lib, q, base, nrm, gids, k, a):
    import torch

    nq, kg = gids.shape
    s = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    _call(lib, "kw_fused_rescore", q.data_ptr(), base.data_ptr(), nrm.data_ptr(), gids.data_ptr(), nq, kg,
          base.shape[1], k, a, s.data_ptr(), i.data_ptr())
    return s, i


def same_bits(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def in_turns(names, fn, reps=5) -> dict:
    """Median ms of fn(name) for each name, in turns: forwards, then backwards."""
    import chip_smoke

    times = {n: [] for n in names}
    for n in list(names) + list(names)[::-1]:
        times[n].append(chip_smoke.time_ms(lambda n=n: fn(n), reps=reps))
    return times


def flat_cases(libs, cases) -> list:
    """cases: (desc, FlatScanStore, queries, k)."""
    from knowhere_tpu_torch.ops import cuda_flat

    lines, pair = [], ("other", "this")
    for desc, store, q, k in cases:
        q_op = cuda_flat.query_operand(q)
        gm = {n: group_max(libs[n], "kw_flat_group_max", store.base, store.nrm, q_op, store.a_coef) for n in pair}
        sel = {n: select(libs[n], gm[n], q.shape[0], k) for n in pair}
        line = dict(desc, nq=q.shape[0], d=store.d_pad, k=k, gmax_equal=same_bits(gm["other"], gm["this"]),
                    select_equal=same_bits(*[sel[n][0] for n in pair]) and same_bits(*[sel[n][1] for n in pair]))
        line["group_max_ms"] = in_turns(pair, lambda n: group_max(
            libs[n], "kw_flat_group_max", store.base, store.nrm, q_op, store.a_coef))
        line["select_ms"] = in_turns(pair, lambda n: select(libs[n], gm["this"], q.shape[0], k))
        print("fused_ab flat", json.dumps(line), flush=True)
        lines.append(line)
        del gm, sel
    return lines


def fused_cases(libs, base, q, cases) -> list:
    """base (nb_pad, d_pad) as fused_topk.pad_base pads it, q (nq, d_pad);
    cases: (desc, padded norms, a, ks)."""
    from knowhere_tpu_torch.ops import cuda_flat

    both = ("other", "this") if hasattr(libs["other"], "kw_fused_group_max") else ("this",)
    lines, names = [], (*both, *VARIANTS)
    q_op = cuda_flat.query_operand_hi(q)
    for desc, nrm, a, ks in cases:
        gm = {v: group_max(libs[v], "kw_fused_group_max", base, nrm, q_op, a) for v in both}
        line = dict(desc, nq=q.shape[0], d=base.shape[1], equal=same_bits(gm[both[0]], gm["this"]))
        line["group_max_ms"] = in_turns(names, lambda v: group_max(libs[v], "kw_fused_group_max", base, nrm, q_op, a))
        for k in ks:
            kg = min(k, base.shape[0] // 16)
            _, gids = select(libs["this"], gm["this"], q.shape[0], kg)
            out = {v: rescore(libs[v], q, base, nrm, gids, k, a) for v in both}
            line["equal"] = line["equal"] and all(same_bits(x, y) for x, y in zip(out[both[0]], out["this"]))
            line[f"k{k}_select_ms"] = in_turns(("this",), lambda v: select(libs[v], gm["this"], q.shape[0], kg))
            line[f"k{k}_rescore_ms"] = in_turns(both, lambda v: rescore(libs[v], q, base, nrm, gids, k, a))
        print("fused_ab fused", json.dumps(line), flush=True)
        lines.append(line)
        del gm
    return lines


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other tree (a checkout)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from knowhere_tpu_torch.ops import cuda_flat, fused_topk

    print(chip_smoke.card_line(), flush=True)
    srcs = sources(a.other.resolve())
    libs = build(srcs)
    print("fused_ab sass", json.dumps(sass_compare({n: OUT / f"{n}.so" for n in srcs})), flush=True)
    dev = torch.device("cuda")
    xb, xq = chip_smoke.gen_corpus(1_000_000, 1024, 128, seed=0)
    base = torch.from_numpy(xb).to(dev)
    q = torch.from_numpy(xq).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    l2, ip = cuda_flat.FlatScanStore(base, None, True), cuda_flat.FlatScanStore(base, None, False)
    d256 = cuda_flat.FlatScanStore(torch.randn((65536, 256), generator=g, device=dev), None, True)
    q256 = torch.randn((300, 256), generator=g, device=dev)
    flat = flat_cases(libs, [({"metric": "L2"}, l2, q, 10), ({"metric": "L2"}, l2, q, 100),
                             ({"metric": "IP"}, ip, q, 10), ({"metric": "L2"}, d256, q256, 10)])
    del l2, ip
    torch.cuda.empty_cache()
    base_p, nrm_l2 = fused_topk.pad_base(base, (base * base).sum(1))
    nrm_ip = fused_topk.pad_base(base, torch.zeros(len(base), device=dev))[1]
    fused = fused_cases(libs, base_p, q, [({"metric": "L2"}, nrm_l2, 2.0, (10, 100)), ({"metric": "IP"}, nrm_ip, 1.0, (10,))])
    del base_p
    fused += fused_cases(libs, d256.base, q256, [({"metric": "L2"}, d256.nrm, 2.0, (10,))])
    ok_flat = all(ln["gmax_equal"] and ln["select_equal"] for ln in flat)
    ok_fused = all(ln["equal"] for ln in fused)
    print("fused_ab: FLAT equal to the other tree:", ok_flat, "; the fused scan's launches equal (where it has them):",
          ok_fused)
    return 0 if ok_flat and ok_fused else 1


if __name__ == "__main__":
    sys.exit(main())
