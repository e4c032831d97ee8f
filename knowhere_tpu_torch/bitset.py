"""BitsetView — the filtered-search mask.

Parity with the reference's `knowhere::BitsetView`
(reference: include/knowhere/bitsetview.h:24-130): bit i == 1 means row i is
FILTERED OUT. Carries an optional precomputed filtered count (popcount cache),
an `id_offset` for chunked bases, and `filter_ratio()` used by index-side
strategy heuristics (e.g. HNSW's kAlpha and brute-force fallback).

Device addition: `device_mask(n)` materializes (and caches) the unpacked
boolean keep-mask as a device tensor so the kernels consume it directly —
the packed uint8 form stays the host/serialization format.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# LSB-first bit order within each byte, matching faiss/knowhere packing.
_BIT = np.array([1, 2, 4, 8, 16, 32, 64, 128], dtype=np.uint8)


class BitsetView:
    __slots__ = ("_bits", "_num_bits", "_filtered_cnt", "_id_offset", "_out_ids", "_dev_cache")

    def __init__(
        self,
        bits: Optional[np.ndarray] = None,
        num_bits: int = 0,
        filtered_out_num: Optional[int] = None,
    ):
        if bits is None:
            self._bits = None
            self._num_bits = 0
        else:
            self._bits = np.asarray(bits, dtype=np.uint8).reshape(-1)
            self._num_bits = int(num_bits) if num_bits else self._bits.size * 8
        self._filtered_cnt = filtered_out_num
        self._id_offset = 0
        self._out_ids: Optional[np.ndarray] = None
        self._dev_cache = None

    # --- constructors -----------------------------------------------------
    @classmethod
    def from_bool_array(cls, filtered_out: np.ndarray) -> "BitsetView":
        """filtered_out[i] == True -> row i is excluded from results."""
        filtered_out = np.asarray(filtered_out, dtype=bool)
        packed = np.packbits(filtered_out, bitorder="little")
        return cls(packed, num_bits=filtered_out.size, filtered_out_num=int(filtered_out.sum()))

    @classmethod
    def empty(cls) -> "BitsetView":
        return cls(None, 0)

    # --- reference API ------------------------------------------------------
    def empty_view(self) -> bool:
        return self._bits is None or self._num_bits == 0

    def size(self) -> int:
        return self._num_bits

    def byte_size(self) -> int:
        return 0 if self._bits is None else int(self._bits.size)

    def data(self) -> Optional[np.ndarray]:
        return self._bits

    def test(self, i: int) -> bool:
        """True if row i is filtered out."""
        if self.empty_view():
            return False
        i = int(i) + self._id_offset
        return bool(self._bits[i >> 3] & _BIT[i & 7])

    def count(self) -> int:
        """Number of filtered-out rows (popcount, cached)."""
        if self.empty_view():
            return 0
        if self._filtered_cnt is None:
            self._filtered_cnt = int(
                np.unpackbits(self._bits, count=self._num_bits, bitorder="little").sum()
            )
        return self._filtered_cnt

    def filter_ratio(self) -> float:
        if self.empty_view():
            return 0.0
        return self.count() / float(self._num_bits)

    def set_id_offset(self, offset: int) -> None:
        self._id_offset = int(offset)
        self._dev_cache = None

    def id_offset(self) -> int:
        return self._id_offset

    # out-id indirection (bitsetview.h out_ids_): bitset indexed by external id
    def set_out_ids(self, out_ids: np.ndarray) -> None:
        self._out_ids = np.asarray(out_ids, dtype=np.int64)
        self._dev_cache = None

    def has_out_ids(self) -> bool:
        return self._out_ids is not None

    # --- reference predicates (bitsetview.h) ----------------------------------
    def all_bits_set(self) -> bool:
        """True iff every row is filtered out (bitsetview.h all_bits_set)."""
        return not self.empty_view() and self.count() >= self._num_bits

    def get_filtered_out_num_(self) -> int:
        """Raw filtered-out count (reference keeps the trailing underscore)."""
        return self.count() if not self.empty_view() else 0

    def get_first_valid_index(self) -> int:
        """Index of the first surviving row; num_bits when none survive."""
        if self.empty_view():
            return 0
        bits = np.unpackbits(self._bits, bitorder="little")[: self._num_bits]
        surv = np.nonzero(~bits.astype(bool))[0]
        return int(surv[0]) if surv.size else self._num_bits

    def range_all_filtered(self, start: int, end: int) -> bool:
        """True iff every row in [start, end) is filtered out."""
        if self.empty_view() or end <= start:
            return False
        bits = np.unpackbits(self._bits, bitorder="little")[: self._num_bits]
        s, e = max(0, int(start)), min(self._num_bits, int(end))
        return bool(bits[s:e].all()) if e > s else False

    def to_string(self, start: int = 0, end: Optional[int] = None) -> str:
        """'01' string of the filter bits in [start, end) (debugging aid)."""
        if self.empty_view():
            return ""
        bits = np.unpackbits(self._bits, bitorder="little")[: self._num_bits]
        e = self._num_bits if end is None else min(int(end), self._num_bits)
        return "".join("1" if b else "0" for b in bits[int(start) : e])

    # --- device-side materialization -------------------------------------------
    def host_mask(self, n: int) -> np.ndarray:
        """Boolean keep-mask of length n: True == candidate survives the filter."""
        if self.empty_view():
            return np.ones(n, dtype=bool)
        bits = np.unpackbits(self._bits, bitorder="little")
        lo = self._id_offset
        filt = np.zeros(n, dtype=bool)
        if self._out_ids is not None:
            ext = self._out_ids[:n]
            valid = (ext >= 0) & (ext + lo < bits.size)
            filt[valid] = bits[(ext[valid] + lo)].astype(bool)
        else:
            m = min(n, bits.size - lo)
            if m > 0:
                filt[:m] = bits[lo : lo + m].astype(bool)
        return ~filt

    def device_mask(self, n: int):
        """Keep-mask as a torch bool tensor on the port's device (cached per
        (n, offset))."""
        from .device import get_device, to_device

        key = (n, self._id_offset, get_device())
        if self._dev_cache is not None and self._dev_cache[0] == key:
            return self._dev_cache[1]
        mask = to_device(self.host_mask(n))
        self._dev_cache = (key, mask)
        return mask

    def __repr__(self) -> str:
        return f"BitsetView(bits={self._num_bits}, filtered={self.count() if not self.empty_view() else 0})"
