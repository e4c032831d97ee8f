"""Build and load the port's CUDA kernels (``knowhere_tpu_torch/csrc``).

Every ``*.cu`` under ``csrc/`` is compiled by its own ``nvcc`` for ``sm_90a``
(all at once) and linked into one shared library with a plain C interface,
loaded with ctypes. The library is
built at first use into ``build/knowhere_tpu_torch/`` at the repository root
and rebuilt whenever the hash of the sources changes. Nothing is built or
imported when this module is imported: the CPU tests import every module.

Each launcher takes its pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after the launch; :func:`check` raises on a
non-zero code. There is no fallback: a kernel that does not build or launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "knowhere_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # blk, nrows, q, sz, codes, nrm, keep, out_s, out_p, T, Qg, d, kk, is_l2, u8, stream
    "kw_ivf_int8_scan": [_P] * 9 + [_I] * 6 + [_P],
    # blk, nrows, q, data, keep, out_s, out_p, T, Qg, d, kk, is_l2, three_pass, stream
    "kw_ivf_f32_scan": [_P] * 7 + [_I] * 6 + [_P],
    # blk, nrows, q, codes, vmin, vdiff, keep, out_s, out_p, T, Qg, d, kk,
    # levels, is_l2, three_pass, stream
    "kw_ivf_sq_scan": [_P] * 9 + [_I] * 7 + [_P],
    # blk, nrows, lids, q, cents, signs, rn, t, keep, out_s, out_p, T, Qg, d,
    # kk, is_l2, three_pass, stream
    "kw_ivf_rbq_scan": [_P] * 11 + [_I] * 6 + [_P],
    # blk, nrows, lids, q, books, clut, cents, codes, keep, out_s, out_p,
    # T, Qg, d, m, ksub, sub, kk, is_l2, nib, stream
    "kw_ivf_adc_scan": [_P] * 11 + [_I] * 9 + [_P],
    # m, ksub, sub, nib: the kernel's dynamic shared memory of a block
    "kw_ivf_adc_smem_bytes": [_I] * 4,
    # base, nrm, q_op, gmax, nb_pad, nq_pad, d, a, stream
    "kw_flat_group_max": [_P] * 4 + [_I] * 3 + [ctypes.c_float, _P],
    # gmax, n, nq, k, out_v, out_g, stream
    "kw_flat_select": [_P, _I, _I, _I, _P, _P, _P],
    # base, nrm, q, part_s, part_i, out_s, out_i, nb, nq, nq_pad, d, k,
    # rows_per_split, n_splits, a, stream
    "kw_fused_knn": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last build, None if cached


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(c)} ({p.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))


def _build() -> ctypes.CDLL:
    global build_seconds
    so = _BUILD_DIR / f"libknowhere_kernels_{_source_hash()}.so"
    if not so.exists():
        t0 = time.perf_counter()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        srcs = sorted(_CSRC.glob("*.cu"))
        objs = [_BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
        # one nvcc per source, all at once, then one link
        _run_all([[_nvcc(), *compile_flags, "-c", str(s), "-o", str(o)] for s, o in zip(srcs, objs)])
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
