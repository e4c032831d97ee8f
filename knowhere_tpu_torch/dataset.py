"""DataSet — the universal input/output container.

Equivalent of the reference's `knowhere::DataSet`
(reference: include/knowhere/dataset.h:29-356 and result constructors
dataset.h:384-483). A DataSet is a small typed dict carrying either input
vectors (tensor/rows/dim, dense or sparse or chunked) or results
(ids/distance[/lims]).

Design differences from the reference (deliberate):
- Arrays are numpy on the host by default; `tensor_device()` returns (and
  caches) the device tensor copy so repeated searches do not re-upload the base.
- No mutex: Python-side DataSets are effectively frozen after construction
  (setters exist for builder-style use, matching the reference API).

Result contract parity (dataset.h:405-474):
- kNN: ids shape (nq*k,) int64 with -1 padding, distance shape (nq*k,) f32.
- Range search: CSR ids/distance + lims (nq+1,) uint64-like int64.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .status import KnowhereException, Status

ArrayLike = Union[np.ndarray, Sequence]


class DataSet:
    def __init__(self, **fields: Any):
        self._data: Dict[str, Any] = {}
        self._device_cache: Dict[str, Any] = {}
        self._is_sparse: bool = False
        for k, v in fields.items():
            self._data[k] = v

    # --- generic access -------------------------------------------------
    def set(self, key: str, value: Any) -> "DataSet":
        self._data[key] = value
        self._device_cache.pop(key, None)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def cached_device(self, key: str, builder) -> Any:
        """Memoize a device-resident derivation of this dataset (e.g. padded
        prepped queries). DataSets are immutable after construction (reference
        contract), and host->device uploads cost ~50MB/s + ~30ms latency on
        this platform once the process is past its first d2h — re-searching
        the same DataSet must not re-upload."""
        hit = self._device_cache.get(key)
        if hit is None:
            hit = builder()
            self._device_cache[key] = hit
        return hit

    def __contains__(self, key: str) -> bool:
        return key in self._data

    # --- typed accessors (mirroring the reference getters) ---------------
    @property
    def tensor(self) -> Optional[np.ndarray]:
        return self._data.get("tensor")

    @tensor.setter
    def tensor(self, v: ArrayLike) -> None:
        self.set("tensor", v)

    @property
    def ids(self) -> Optional[np.ndarray]:
        return self._data.get("ids")

    @ids.setter
    def ids(self, v: ArrayLike) -> None:
        self.set("ids", np.asarray(v, dtype=np.int64))

    @property
    def distance(self) -> Optional[np.ndarray]:
        return self._data.get("distance")

    @distance.setter
    def distance(self, v: ArrayLike) -> None:
        self.set("distance", np.asarray(v, dtype=np.float32))

    @property
    def lims(self) -> Optional[np.ndarray]:
        return self._data.get("lims")

    @lims.setter
    def lims(self, v: ArrayLike) -> None:
        self.set("lims", np.asarray(v, dtype=np.int64))

    @property
    def rows(self) -> int:
        r = self._data.get("rows")
        if r is None:
            t = self.tensor
            if t is not None:
                r = len(t) if self._is_sparse or isinstance(t, list) else t.shape[0]
            else:
                r = 0
        return int(r)

    @rows.setter
    def rows(self, v: int) -> None:
        self.set("rows", int(v))

    @property
    def dim(self) -> int:
        d = self._data.get("dim")
        if d is None:
            t = self.tensor
            if t is not None and hasattr(t, "shape") and getattr(t, "ndim", 0) >= 2:
                d = t.shape[-1]
            else:
                d = 0
        return int(d)

    @dim.setter
    def dim(self, v: int) -> None:
        self.set("dim", int(v))

    @property
    def is_sparse(self) -> bool:
        return self._is_sparse

    @is_sparse.setter
    def is_sparse(self, v: bool) -> None:
        self._is_sparse = bool(v)

    # reference dataset.h chunked-mode + metadata accessors (Set/Get pairs
    # dataset.h:296-317; stored as plain dict keys here)
    @property
    def is_chunk(self) -> bool:
        return bool(self._data.get("is_chunk", False))

    @is_chunk.setter
    def is_chunk(self, v: bool) -> None:
        self.set("is_chunk", bool(v))

    @property
    def num_chunk(self) -> int:
        return int(self._data.get("num_chunk", 1))

    @num_chunk.setter
    def num_chunk(self, v: int) -> None:
        self.set("num_chunk", int(v))

    @property
    def tensor_begin_id(self) -> int:
        return int(self._data.get("tensor_begin_id", 0))

    @tensor_begin_id.setter
    def tensor_begin_id(self, v: int) -> None:
        self.set("tensor_begin_id", int(v))

    @property
    def json_info(self) -> Optional[str]:
        return self._data.get("json_info")

    @json_info.setter
    def json_info(self, v: str) -> None:
        self.set("json_info", v)

    @property
    def json_id_set(self) -> Optional[str]:
        return self._data.get("json_id_set")

    @json_id_set.setter
    def json_id_set(self, v: str) -> None:
        self.set("json_id_set", v)

    # --- device transfer --------------------------------------------------
    def tensor_device(self):
        """Return the tensor as a torch.Tensor on the port's device, cached on
        this DataSet.

        The reference keeps raw data in host RAM and lets SIMD kernels stream
        it; on the GPU the hot path wants the base resident in device memory
        once, so the device copy is memoized here.
        """
        if "tensor" in self._device_cache:
            return self._device_cache["tensor"]
        from .device import to_device

        t = self.tensor
        if t is None:
            raise KnowhereException("DataSet has no tensor", Status.invalid_args)
        dev = to_device(np.asarray(t))
        self._device_cache["tensor"] = dev
        return dev

    def __repr__(self) -> str:
        keys = ", ".join(sorted(self._data.keys()))
        return f"DataSet(rows={self.rows}, dim={self.dim}, fields=[{keys}])"


# ---------------------------------------------------------------------------
# Constructors (reference dataset.h:358-483 GenDataSet/GenResultDataSet family)
# ---------------------------------------------------------------------------


def GenDataSet(rows: int, dim: int, tensor: ArrayLike, ids: Optional[ArrayLike] = None) -> DataSet:
    ds = DataSet()
    arr = np.asarray(tensor)
    if arr.ndim == 1:
        arr = arr.reshape(rows, -1)
    ds.tensor = arr
    ds.rows = rows
    ds.dim = dim
    if ids is not None:
        ds.ids = ids
    return ds


def GenDataSetFromArray(arr: np.ndarray) -> DataSet:
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise KnowhereException("expect 2-D array (rows, dim)", Status.invalid_args)
    return GenDataSet(arr.shape[0], arr.shape[1], arr)


def GenSparseDataSet(rows_list: List[Dict[int, float]], dim: int) -> DataSet:
    """Sparse dataset: list of {dim_index: value} rows (reference SparseRow,
    sparse_utils.h:62-201)."""
    ds = DataSet()
    ds.set("tensor", rows_list)
    ds._is_sparse = True
    ds.rows = len(rows_list)
    ds.dim = dim
    return ds


def GenIdsDataSet(ids: ArrayLike, rows: Optional[int] = None) -> DataSet:
    ds = DataSet()
    ids_arr = np.asarray(ids, dtype=np.int64)
    ds.ids = ids_arr
    ds.rows = rows if rows is not None else len(ids_arr)
    return ds


def GenResultDataSet(
    nq: int,
    k: int,
    ids: ArrayLike,
    distance: ArrayLike,
) -> DataSet:
    """kNN result: flat ids (nq*k,) with -1 padding + distances (nq*k,)."""
    ds = DataSet()
    ds.ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    ds.distance = np.asarray(distance, dtype=np.float32).reshape(-1)
    ds.rows = nq
    ds.dim = k
    return ds


def GenRangeResultDataSet(
    nq: int,
    ids: ArrayLike,
    distance: ArrayLike,
    lims: ArrayLike,
) -> DataSet:
    """Range-search result: CSR ids/distances with lims[nq+1]."""
    ds = DataSet()
    ds.ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    ds.distance = np.asarray(distance, dtype=np.float32).reshape(-1)
    ds.lims = np.asarray(lims, dtype=np.int64).reshape(-1)
    ds.rows = nq
    return ds


def GenTensorDataSet(tensor: np.ndarray, rows: int, dim: int) -> DataSet:
    """GetVectorByIds-style output dataset (tensor in stored dtype)."""
    ds = DataSet()
    ds.set("tensor", tensor)
    ds.rows = rows
    ds.dim = dim
    return ds
