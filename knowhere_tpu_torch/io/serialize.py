"""Versioned, mmap-able binary section format for index serialization.

Role parity: the reference serializes each index through faiss write_index
into a MemoryIOWriter and stores it as a named blob in a BinarySet
(reference: src/io/memory_io.h, src/index/ivf/ivf.cc:1723-1842), with
IO_FLAG_MMAP zero-copy loads from file (ivf.cc:1844-1903; binaryset.h).

This framework defines its own layout (not faiss-compatible on purpose —
the wire format is a contract of THIS framework):

    [magic "KWTPU\\x01"][u32 header_len][header json utf-8][pad to 64]
    [section 0 bytes, 64-byte aligned][section 1 bytes ...]

The header maps section name -> {offset, nbytes, dtype, shape} plus a free-form
"meta" dict (index params needed to reconstruct). Arrays read back from a
memoryview are zero-copy views (np.frombuffer), so DeserializeFromFile via
np.memmap feeds device DMA without a host copy.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from ..status import KnowhereException, Status
from ..utils.bf16 import BF16_NAME

MAGIC = b"KWTPU\x01"
ALIGN = 64
FORMAT_VERSION = 1


def _pad(n: int) -> int:
    return (ALIGN - n % ALIGN) % ALIGN


def write_sections(
    arrays: Dict[str, np.ndarray], meta: Optional[Dict[str, Any]] = None, bf16: Tuple[str, ...] = ()
) -> bytes:
    """The KWTPU bytes of ``arrays`` and ``meta``. The sections named in
    ``bf16`` hold bf16 rows as uint16 bit patterns (utils/bf16.py): they are
    written under the dtype name "bfloat16", as the reference writes its
    ml_dtypes rows, over the same bytes."""
    header: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "meta": meta or {},
        "sections": {},
    }
    # First pass: compute layout with a fixed-point on header size (header is
    # itself variable length; iterate until offsets stabilize).
    blobs = {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        blobs[name] = arr

    def layout(header_len: int) -> Tuple[Dict[str, Any], int]:
        off = len(MAGIC) + 4 + header_len
        off += _pad(off)
        sections = {}
        for name, arr in blobs.items():
            sections[name] = {
                "offset": off,
                "nbytes": arr.nbytes,
                "dtype": BF16_NAME if name in bf16 else str(arr.dtype),
                "shape": list(arr.shape),
            }
            off += arr.nbytes
            off += _pad(off)
        return sections, off

    header_len = 0
    for _ in range(8):
        header["sections"], _total = layout(header_len)
        encoded = json.dumps(header, separators=(",", ":")).encode("utf-8")
        if len(encoded) == header_len:
            break
        header_len = len(encoded)
    else:
        raise KnowhereException("serialize header failed to stabilize", Status.internal_error)

    sections, total = layout(header_len)
    buf = bytearray(total)
    buf[: len(MAGIC)] = MAGIC
    buf[len(MAGIC) : len(MAGIC) + 4] = np.uint32(header_len).tobytes()
    buf[len(MAGIC) + 4 : len(MAGIC) + 4 + header_len] = encoded
    for name, arr in blobs.items():
        s = sections[name]
        buf[s["offset"] : s["offset"] + s["nbytes"]] = arr.tobytes()
    return bytes(buf)


def _dtype(name: str) -> np.dtype:
    """numpy dtype of a section; a "bfloat16" section (bf16 rows) reads as
    its uint16 bit patterns (utils/bf16.py)."""
    return np.dtype(np.uint16) if name == BF16_NAME else np.dtype(name)


def read_sections(
    data: Union[bytes, bytearray, memoryview, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns ({name: zero-copy array view}, meta)."""
    if isinstance(data, np.ndarray):
        mv = memoryview(data).cast("B")
    else:
        mv = memoryview(data).cast("B")
    if bytes(mv[: len(MAGIC)]) != MAGIC:
        raise KnowhereException("bad magic in serialized index", Status.invalid_binary_set)
    header_len = int(np.frombuffer(mv[len(MAGIC) : len(MAGIC) + 4], dtype=np.uint32)[0])
    header = json.loads(bytes(mv[len(MAGIC) + 4 : len(MAGIC) + 4 + header_len]))
    if header.get("format_version", 0) > FORMAT_VERSION:
        raise KnowhereException(
            f"serialized format version {header.get('format_version')} is newer than supported",
            Status.invalid_serialized_index_type,
        )
    arrays = {}
    for name, s in header["sections"].items():
        raw = mv[s["offset"] : s["offset"] + s["nbytes"]]
        arrays[name] = np.frombuffer(raw, dtype=_dtype(s["dtype"])).reshape(s["shape"])
    return arrays, header.get("meta", {})


def write_sections_streaming(
    path: str,
    specs: Dict[str, Tuple[tuple, str]],
    meta: Optional[Dict[str, Any]] = None,
    bf16: Tuple[str, ...] = (),
):
    """Open a section file for STREAMING writes: the payload arrays are not
    materialized in memory (disk-resident builds whose data exceeds the DRAM
    budget write chunk-by-chunk). Same wire layout as write_sections; the
    sections named in ``bf16`` take uint16 bit patterns and are written
    under the dtype name "bfloat16", as write_sections writes them.

    specs: name -> (shape, dtype-string). Returns a writer object:
        w.write(name, row_start, array)  # rows into section `name`
        w.close()
    """
    header: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "meta": meta or {},
        "sections": {},
    }

    def layout(header_len: int) -> Tuple[Dict[str, Any], int]:
        off = len(MAGIC) + 4 + header_len
        off += _pad(off)
        sections = {}
        for name, (shape, dtype) in specs.items():
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            sections[name] = {
                "offset": off,
                "nbytes": nbytes,
                "dtype": BF16_NAME if name in bf16 else str(np.dtype(dtype)),
                "shape": list(shape),
            }
            off += nbytes
            off += _pad(off)
        return sections, off

    header_len = 0
    for _ in range(8):
        header["sections"], total = layout(header_len)
        encoded = json.dumps(header, separators=(",", ":")).encode("utf-8")
        if len(encoded) == header_len:
            break
        header_len = len(encoded)
    else:
        raise KnowhereException("serialize header failed to stabilize", Status.internal_error)
    sections, total = layout(header_len)

    f = open(path, "wb")
    f.write(MAGIC)
    f.write(np.uint32(header_len).tobytes())
    f.write(encoded)
    f.truncate(total)

    class _Writer:
        def write(self, name: str, row_start: int, arr: np.ndarray) -> None:
            s = sections[name]
            shape, dtype = specs[name]
            row_bytes = int(np.prod(shape[1:])) * np.dtype(dtype).itemsize if len(shape) > 1 else np.dtype(dtype).itemsize
            arr = np.ascontiguousarray(arr, dtype=np.dtype(dtype))
            f.seek(s["offset"] + row_start * row_bytes)
            f.write(arr.tobytes())

        def close(self) -> None:
            f.close()

    return _Writer()
