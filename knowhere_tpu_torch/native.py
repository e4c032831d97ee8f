"""ctypes bindings for the port's native host runtime
(``csrc/host/knowhere_native.cpp``; counterpart of knowhere_tpu/native.py).

The library is compiled with ``g++ -O3`` at first use into
``build/knowhere_tpu_torch/`` at the repository root (gitignored), named by
the hash of its source, and rebuilt when the source changes. Every entry
point has a numpy fallback that produces the same bytes, so the port works
without a toolchain; :func:`available` says which path serves. The pieces
mirror the reference's host-side native layers: posting-list codecs
(src/index/sparse/codec/), row gathers from a file (DiskANN's
linux_aligned_file_reader), popcount.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "host" / "knowhere_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "knowhere_tpu_torch"
_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libknowhere_native_{h}.so"


def _compile(so: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, so)  # atomic: a concurrent loader never maps a partial file


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _so_path()
        try:
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):  # no g++: the numpy fallbacks serve
            return None
        c = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kn_varint_encode.restype = c
        lib.kn_varint_encode.argtypes = [u32p, c, u8p]
        lib.kn_varint_decode.restype = c
        lib.kn_varint_decode.argtypes = [u8p, c, u32p, c]
        lib.kn_delta_encode.restype = None
        lib.kn_delta_encode.argtypes = [u32p, c, u32p]
        lib.kn_delta_decode.restype = None
        lib.kn_delta_decode.argtypes = [u32p, c, u32p]
        lib.kn_bitpack_encode.restype = c
        lib.kn_bitpack_encode.argtypes = [u32p, c, ctypes.c_int, u8p]
        lib.kn_bitpack_decode.restype = c
        lib.kn_bitpack_decode.argtypes = [u8p, c, ctypes.c_int, u32p]
        lib.kn_max_bits.restype = ctypes.c_int
        lib.kn_max_bits.argtypes = [u32p, c]
        lib.kn_popcount.restype = c
        lib.kn_popcount.argtypes = [u8p, c]
        lib.kn_gather_rows.restype = ctypes.c_int
        lib.kn_gather_rows.argtypes = [ctypes.c_char_p, c, c, i64p, c, u8p]
        lib.kn_gather_rows_mt.restype = ctypes.c_int
        lib.kn_gather_rows_mt.argtypes = [ctypes.c_char_p, c, c, i64p, c, u8p, ctypes.c_int]
        _LIB = lib
        return lib


def available() -> bool:
    """True when the C++ library is built and loaded (else the numpy
    fallbacks serve)."""
    return _build_and_load() is not None


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _leb128(values: np.ndarray) -> bytes:
    """LEB128 bytes of u32 values (numpy): 7 bits a byte, low first, the
    high bit set on every byte but an element's last."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size == 0:
        return b""
    nbytes = np.ones(v.size, np.int64)
    for s in (7, 14, 21, 28):
        nbytes += v >= (np.uint64(1) << np.uint64(s))
    pos = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    out = np.zeros(int(nbytes.sum()), np.uint8)
    for j in range(5):
        sel = nbytes > j
        byte = ((v[sel] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        out[pos[sel] + j] = byte | np.where(nbytes[sel] > j + 1, 0x80, 0).astype(np.uint8)
    return out.tobytes()


def _leb128_decode(buf: np.ndarray, n: int) -> np.ndarray:
    """The first n LEB128 values of ``buf`` as u32 (numpy)."""
    if n == 0:
        return np.zeros(0, np.uint32)
    ends = np.nonzero(buf < 0x80)[0]
    if ends.size < n:
        raise ValueError("truncated varint blob")
    ends = ends[:n]
    starts = np.concatenate([[0], ends[:-1] + 1])
    out = np.zeros(n, np.uint64)
    for j in range(5):
        sel = starts + j <= ends
        out[sel] |= (buf[starts[sel] + j].astype(np.uint64) & np.uint64(0x7F)) << np.uint64(7 * j)
    return out.astype(np.uint32)


# ---------------------------------------------------------------------------
# raw varint (no delta)
# ---------------------------------------------------------------------------


def varint_encode(values: np.ndarray) -> bytes:
    vals = np.ascontiguousarray(values, dtype=np.uint32)
    lib = _build_and_load()
    if lib is None:
        return _leb128(vals)
    out = np.empty(len(vals) * 5 + 8, dtype=np.uint8)
    n = lib.kn_varint_encode(_u32p(vals), len(vals), _u8p(out))
    return out[:n].tobytes()


def varint_decode(blob: bytes, n: int) -> np.ndarray:
    buf = np.ascontiguousarray(np.frombuffer(blob, dtype=np.uint8))
    lib = _build_and_load()
    if lib is None:
        return _leb128_decode(buf, n)
    out = np.empty(n, dtype=np.uint32)
    if lib.kn_varint_decode(_u8p(buf), len(buf), _u32p(out), n) < 0:
        raise ValueError("truncated varint blob")
    return out


# ---------------------------------------------------------------------------
# row-major CSR column indices: per-row deltas, one varint stream
# ---------------------------------------------------------------------------


def _csr_deltas(indices: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    deltas = idx.copy()
    deltas[1:] -= idx[:-1]
    starts = np.asarray(indptr[1:-1], dtype=np.int64)
    starts = starts[starts < idx.size]
    deltas[starts] = idx[starts]  # the delta chain restarts at each row
    return deltas.astype(np.uint32)


def _csr_from_deltas(deltas: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    c = np.cumsum(deltas.astype(np.int64))
    row_start = np.asarray(indptr[:-1], dtype=np.int64)
    lens = np.diff(indptr).astype(np.int64)
    nonempty = lens > 0
    base = np.zeros(len(row_start), np.int64)
    base[nonempty] = c[row_start[nonempty]] - deltas[row_start[nonempty]].astype(np.int64)
    return (c - np.repeat(base, lens)).astype(np.int32)


def encode_csr_indices(indices: np.ndarray, indptr: np.ndarray) -> bytes:
    """Row-major CSR column indices (ascending within a row) -> per-row
    deltas as one varint stream (reference src/index/sparse/codec/)."""
    if np.asarray(indices).size == 0:
        return b""
    return varint_encode(_csr_deltas(indices, indptr))


def decode_csr_indices(blob: bytes, indptr: np.ndarray) -> np.ndarray:
    nnz = int(indptr[-1])
    if nnz == 0:
        return np.empty(0, np.int32)
    return _csr_from_deltas(varint_decode(blob, nnz), indptr)


# ---------------------------------------------------------------------------
# posting list: strictly increasing doc ids, delta + varint
# ---------------------------------------------------------------------------


def encode_postings(doc_ids: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(doc_ids, dtype=np.uint32)
    lib = _build_and_load()
    if lib is None:
        return _leb128(np.diff(ids, prepend=np.uint32(0)))
    deltas = np.empty_like(ids)
    lib.kn_delta_encode(_u32p(ids), len(ids), _u32p(deltas))
    out = np.empty(len(ids) * 5 + 8, dtype=np.uint8)
    n = lib.kn_varint_encode(_u32p(deltas), len(ids), _u8p(out))
    return out[:n].tobytes()


def decode_postings(blob: bytes, n: int) -> np.ndarray:
    buf = np.ascontiguousarray(np.frombuffer(blob, dtype=np.uint8))
    lib = _build_and_load()
    if lib is None:
        return np.cumsum(_leb128_decode(buf, n).astype(np.int64))
    deltas = np.empty(n, dtype=np.uint32)
    if lib.kn_varint_decode(_u8p(buf), len(buf), _u32p(deltas), n) < 0:
        raise ValueError("truncated posting blob")
    out = np.empty(n, dtype=np.uint32)
    lib.kn_delta_decode(_u32p(deltas), n, _u32p(out))
    return out.astype(np.int64)


# ---------------------------------------------------------------------------
# fixed-width bitpack (little-endian bit order)
# ---------------------------------------------------------------------------


def bitpack(values: np.ndarray) -> Tuple[bytes, int]:
    """Pack u32 values at the width of the largest; returns (blob, bits)."""
    vals = np.ascontiguousarray(values, dtype=np.uint32)
    lib = _build_and_load()
    if lib is None:
        bits = max(int(vals.max(initial=1)).bit_length(), 1)
        planes = ((vals[:, None] >> np.arange(bits, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
        return np.packbits(planes, bitorder="little").tobytes(), bits
    bits = lib.kn_max_bits(_u32p(vals), len(vals))
    out = np.empty((len(vals) * bits + 7) // 8 + 8, dtype=np.uint8)
    n = lib.kn_bitpack_encode(_u32p(vals), len(vals), bits, _u8p(out))
    return out[:n].tobytes(), bits


def bitunpack(blob: bytes, n: int, bits: int) -> np.ndarray:
    buf = np.ascontiguousarray(np.frombuffer(blob, dtype=np.uint8))
    lib = _build_and_load()
    if lib is None:
        planes = np.unpackbits(buf, bitorder="little")[: n * bits].reshape(n, bits)
        return (planes.astype(np.uint32) << np.arange(bits, dtype=np.uint32)[None, :]).sum(1, dtype=np.uint32)
    # kn_bitpack_decode loads 8 bytes at each value's first byte: pad the
    # stream so the last loads stay inside the buffer
    padded = np.zeros(buf.size + 8, np.uint8)
    padded[: buf.size] = buf
    out = np.empty(n, dtype=np.uint32)
    lib.kn_bitpack_decode(_u8p(padded), n, bits, _u32p(out))
    return out


def encode_csr_indices_adaptive(indices: np.ndarray, indptr: np.ndarray) -> Tuple[bytes, str]:
    """The smaller of delta-varint and delta-bitpack for the stream
    (reference codec/adaptive.h); returns (blob, codec name)."""
    if np.asarray(indices).size == 0:
        return b"", "delta_varint"
    deltas = _csr_deltas(indices, indptr)
    vb = varint_encode(deltas)
    bp, bits = bitpack(deltas)
    if len(bp) + 1 < len(vb):
        return bytes([bits]) + bp, "delta_bitpack"
    return vb, "delta_varint"


def decode_csr_indices_any(blob: bytes, indptr: np.ndarray, codec: str) -> np.ndarray:
    nnz = int(indptr[-1])
    if nnz == 0:
        return np.empty(0, np.int32)
    if codec == "delta_bitpack":
        return _csr_from_deltas(bitunpack(blob[1:], nnz, int(blob[0])), indptr)
    return decode_csr_indices(blob, indptr)


# ---------------------------------------------------------------------------
# popcount, row gathers from a file
# ---------------------------------------------------------------------------


def popcount(buf: np.ndarray) -> int:
    b = np.ascontiguousarray(buf, dtype=np.uint8)
    lib = _build_and_load()
    if lib is None:
        return int(np.unpackbits(b).sum())
    return int(lib.kn_popcount(_u8p(b), b.size))


def gather_rows(path: str, base_offset: int, row_bytes: int, row_ids: np.ndarray) -> np.ndarray:
    """Rows ``row_ids`` of ``row_bytes`` each from a file, after
    ``base_offset`` bytes: (n, row_bytes) uint8."""
    ids = np.ascontiguousarray(row_ids, dtype=np.int64)
    out = np.empty(len(ids) * row_bytes, dtype=np.uint8)
    lib = _build_and_load()
    if lib is None:
        with open(path, "rb") as f:
            for i, rid in enumerate(ids):
                f.seek(base_offset + int(rid) * row_bytes)
                out[i * row_bytes : (i + 1) * row_bytes] = np.frombuffer(f.read(row_bytes), np.uint8)
        return out.reshape(len(ids), row_bytes)
    if lib.kn_gather_rows(path.encode(), base_offset, row_bytes, _i64p(ids), len(ids), _u8p(out)) != 0:
        raise OSError(f"kn_gather_rows failed for {path}")
    return out.reshape(len(ids), row_bytes)


def gather_rows_mt(
    path: str, base_offset: int, row_bytes: int, row_ids: np.ndarray, n_threads: int = 0
) -> Optional[np.ndarray]:
    """:func:`gather_rows` with ``n_threads`` preads in flight (the
    reference's libaio reader analog); None without the native library."""
    lib = _build_and_load()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = min(16, os.cpu_count() or 1)
    ids = np.ascontiguousarray(row_ids, dtype=np.int64)
    out = np.empty(len(ids) * row_bytes, dtype=np.uint8)
    rc = lib.kn_gather_rows_mt(path.encode(), base_offset, row_bytes, _i64p(ids), len(ids), _u8p(out), int(n_threads))
    if rc != 0:
        raise OSError(f"kn_gather_rows_mt failed for {path}")
    return out.reshape(len(ids), row_bytes)
