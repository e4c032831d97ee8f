"""bfloat16 rows on the host, without ml_dtypes.

numpy has no bfloat16 type of its own. The port holds a bf16 host array as
its uint16 bit patterns, and a uint16 array of rows is always that: the
bf16 IVF and FLAT corpora, the cosine copy of a typed IVF corpus, the BF16
refine rows and the SQ BF16 rows.
Rounding goes through torch's bfloat16 (round to nearest even, as
ml_dtypes rounds), widening is a shift, and the serialized section keeps
the dtype name "bfloat16" over the same bytes (io/serialize.py), so
blobs cross-load with the JAX package, which writes ml_dtypes arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_device

BF16_NAME = "bfloat16"  # the dtype name a KWTPU section of bf16 rows carries


def bf16_bits(x) -> np.ndarray:
    """uint16 bit patterns of ``x`` as bf16: uint16 bits as they are, a
    bfloat16 array of another library viewed as its bits, any other number
    widened to f32 and rounded to nearest even."""
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return x
    if x.dtype.name == BF16_NAME:
        return x.view(np.uint16)
    x = np.ascontiguousarray(x, dtype=np.float32)
    if not x.flags.writeable:  # a read-only view (a spilled memmap): torch wants its own copy
        x = x.copy()
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits) -> np.ndarray:
    """bf16 bit patterns (uint16) -> the f32 values they hold (exact)."""
    return (np.asarray(bits).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def as_f32(x) -> np.ndarray:
    """Rows as f32 values: bf16 rows (uint16 bit patterns, or a bfloat16
    array of another library) widened, any other dtype cast."""
    x = np.asarray(x)
    if x.dtype == np.uint16 or x.dtype.name == BF16_NAME:
        return bf16_to_f32(x)
    return np.asarray(x, dtype=np.float32)


def rows_to_device(a: np.ndarray) -> torch.Tensor:
    """Host rows -> a device tensor of their width: bf16 bit patterns as
    torch.bfloat16, any other dtype as it is."""
    if a.dtype == np.uint16:
        return to_device(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return to_device(a)
