"""Host-payload spill: demote large resident host arrays to disk-backed
memmaps.

The device (HBM) store is the search structure; the host payload exists for
serialization / GetVectorByIds / CC re-merges. Keeping it resident doubles
memory versus the reference, which keeps ONE copy (RAM or mmap —
src/index/sparse/block_inverted_index.h mmap sections, ivf.cc mmap
deserialize). Spilling moves that copy to a temp file so resident host RAM
drops to ~0 for built indexes while every consumer keeps working (memmaps are
ndarray subclasses).

Controlled by KNOWHERE_HOST_SPILL (default on) and
KNOWHERE_HOST_SPILL_THRESHOLD (bytes, default 64MB per array).
"""

import atexit
import os
import tempfile
import threading
import uuid
from typing import Optional

import numpy as np

_lock = threading.Lock()
_files: set = set()


def _spill_dir() -> str:
    d = os.environ.get("KNOWHERE_SPILL_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "knowhere_spill")
    os.makedirs(d, exist_ok=True)
    return d


def _cleanup() -> None:  # pragma: no cover - process teardown
    with _lock:
        for f in list(_files):
            try:
                os.unlink(f)
            except OSError:
                pass
        _files.clear()


atexit.register(_cleanup)


def spill_enabled() -> bool:
    return os.environ.get("KNOWHERE_HOST_SPILL", "1") != "0"


def spill_threshold() -> int:
    return int(os.environ.get("KNOWHERE_HOST_SPILL_THRESHOLD", str(64 << 20)))


def spill_array(a: np.ndarray, threshold: Optional[int] = None) -> np.ndarray:
    """Returns a read-only disk-backed memmap of `a` when spilling applies,
    else `a` unchanged. The caller should drop its reference to `a`."""
    if not spill_enabled() or not isinstance(a, np.ndarray):
        return a
    if isinstance(a, np.memmap) or isinstance(a.base, np.memmap):
        return a  # already disk-backed
    thr = spill_threshold() if threshold is None else threshold
    if a.nbytes < thr:
        return a
    path = os.path.join(_spill_dir(), f"{uuid.uuid4().hex}.bin")
    try:
        mm = np.memmap(path, dtype=a.dtype, mode="w+", shape=a.shape)
        mm[...] = a
        mm.flush()
        ro = np.memmap(path, dtype=a.dtype, mode="r", shape=a.shape)
    except OSError:  # disk full etc: keep the resident copy
        try:
            os.unlink(path)
        except OSError:
            pass
        return a
    with _lock:
        _files.add(path)
    return ro


def release_spill(a: np.ndarray) -> None:
    """Delete the backing file of a spilled array (call when replacing it)."""
    mm = a if isinstance(a, np.memmap) else getattr(a, "base", None)
    if isinstance(mm, np.memmap) and getattr(mm, "filename", None):
        path = str(mm.filename)
        with _lock:
            if path in _files:
                _files.discard(path)
                try:
                    os.unlink(path)
                except OSError:  # pragma: no cover
                    pass


def spill_dict(d: dict, threshold: Optional[int] = None) -> None:
    """In-place spill of every large ndarray value of `d`."""
    for k, v in list(d.items()):
        if isinstance(v, np.ndarray):
            d[k] = spill_array(v, threshold)
