"""BinarySet — named binary blobs for index (de)serialization.

Parity with the reference's `knowhere::Binary`/`BinarySet`
(reference: include/knowhere/binaryset.h:24-60). Blobs are bytes-like
(bytes / bytearray / memoryview / np.uint8 array); mmap-backed memoryviews are
supported so deserialize-from-file can stay zero-copy on the host side.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np

Blob = Union[bytes, bytearray, memoryview, np.ndarray]


class Binary:
    __slots__ = ("name", "data", "size")

    def __init__(self, name: str, data: Blob):
        self.name = name
        self.data = data
        self.size = len(memoryview(data).cast("B")) if not isinstance(data, np.ndarray) else data.nbytes

    def tobytes(self) -> bytes:
        if isinstance(self.data, np.ndarray):
            return self.data.tobytes()
        return bytes(self.data)


class BinarySet:
    def __init__(self) -> None:
        self._map: Dict[str, Binary] = {}

    def Append(self, name: str, data: Blob) -> None:
        self._map[name] = Binary(name, data)

    def GetByName(self, name: str) -> Optional[Binary]:
        return self._map.get(name)

    def Contains(self, name: str) -> bool:
        return name in self._map

    def GetByNames(self, names) -> Dict[str, Optional[Binary]]:
        """reference binaryset.h GetByNames: name -> Binary (None if absent)."""
        return {n: self._map.get(n) for n in names}

    def Erase(self, name: str) -> bool:
        return self._map.pop(name, None) is not None

    def clear(self) -> None:  # noqa: N802 (reference casing)
        self._map.clear()

    def Size(self) -> int:
        return sum(b.size for b in self._map.values())

    def keys(self) -> Iterator[str]:
        return iter(self._map.keys())

    def __iter__(self) -> Iterator[str]:
        return iter(self._map.keys())

    def __len__(self) -> int:
        return len(self._map)

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}:{v.size}B" for k, v in self._map.items())
        return f"BinarySet({parts})"
