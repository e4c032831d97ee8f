"""Fixed-width bitpacked doc ids with decode-on-gather (counterpart of
knowhere_tpu/ops/bitpack.py).

The sparse tail store keeps its doc ids packed at ceil(log2(nb)) bits an id
(reference: postings kept bitpacked, src/index/sparse/codec/). The width is
fixed, so random access survives: element i lives at bits [i*b, (i+1)*b) of
a little-endian u32 stream, and a gather decodes it from words w and w+1.
The host side (:func:`pack_fixed`, :func:`unpack_all`) is the reference's
numpy; :func:`unpack_gather` decodes on the device in int64, since torch
has few uint32 operations.
"""

from __future__ import annotations

import numpy as np
import torch


def width_for(n_values: int) -> int:
    """Bits needed to represent ids in [0, n_values)."""
    return max(1, int(np.ceil(np.log2(max(int(n_values), 2)))))


def pack_fixed(a: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned ints < 2**bits into a little-endian u32 bitstream.

    Element i occupies bits [i*bits, (i+1)*bits). One spare word is
    appended so decode-on-gather can always load word w+1.
    """
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if bits < 1 or bits > 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if a.size and int(a.max()) >> bits:
        raise ValueError("value does not fit the requested bit width")
    n = a.size
    nwords = (n * bits + 31) // 32 + 1
    out = np.zeros(nwords, np.uint32)
    if n == 0:
        return out
    bitpos = np.arange(n, dtype=np.int64) * bits
    w = (bitpos >> 5).astype(np.int64)
    ofs = (bitpos & 31).astype(np.uint64)
    shifted = a << ofs  # fits u64: bits + ofs <= 32 + 31
    np.bitwise_or.at(out, w, (shifted & 0xFFFFFFFF).astype(np.uint32))
    np.bitwise_or.at(out, w + 1, (shifted >> np.uint64(32)).astype(np.uint32))
    return out


def unpack_gather(packed: torch.Tensor, idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Elements ``idx`` of a pack_fixed stream, held as the int32 view of
    its words -> int64 values, on the stream's device.

    Words w and w+1 are widened to their unsigned value in int64 and joined
    into one 64-bit window, so no shift is by 32 or more: the reference's
    ``ofs == 0`` case (where ``hi << (32 - ofs)`` would shift by 32) takes
    nothing from w+1 here.
    """
    bitpos = idx.to(torch.int64) * bits
    w = bitpos >> 5
    ofs = bitpos & 31
    lo = packed[w].to(torch.int64) & 0xFFFFFFFF
    # an element ends at bit ofs + bits - 1 <= 62 of the window, so word
    # w+1's top bit is never needed: dropping it keeps the window positive
    hi = packed[w + 1].to(torch.int64) & 0x7FFFFFFF
    window = lo | (hi << 32)
    mask = (1 << bits) - 1
    return (window >> ofs) & mask


def unpack_all(packed: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Host-side full decode (serialization / oracle checks) -> uint32."""
    if n == 0:
        return np.zeros(0, np.uint32)
    bitpos = np.arange(n, dtype=np.int64) * bits
    w = bitpos >> 5
    ofs = (bitpos & 31).astype(np.uint64)
    lo = packed[w].astype(np.uint64)
    hi = packed[w + 1].astype(np.uint64)
    mask = np.uint64((1 << bits) - 1)
    return (((lo | (hi << np.uint64(32))) >> ofs) & mask).astype(np.uint32)
