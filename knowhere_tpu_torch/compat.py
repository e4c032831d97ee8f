"""Drop-in compatibility shim for the reference Python bindings
(counterpart of knowhere_tpu/compat.py).

Mirrors the SWIG-module surface (reference python/knowhere/__init__.py:1-221
+ knowhere.i IndexWrap): existing Knowhere-python callers can
`import knowhere_tpu_torch.compat as knowhere` and keep their code. The
IndexWrap methods take JSON **strings** (SWIG contract) and return
(result, Status) pairs exactly like the wrapped C++ calls. bf16 rows are
their uint16 bit patterns (utils/bf16.py): the bf16 type object is
torch.bfloat16 or any numpy type named "bfloat16".
"""

from __future__ import annotations

import json as _json
from typing import Optional, Tuple

import numpy as np
import torch

from .binaryset import BinarySet
from .bitset import BitsetView
from .brute_force import BruteForce as _BF
from .dataset import DataSet, GenDataSetFromArray, GenSparseDataSet
from .factory import IndexFactory
from .feature import Version
from .knowhere_config import KnowhereConfig
from .status import Status  # noqa: F401  (re-export)
from .utils.bf16 import BF16_NAME, as_f32, bf16_bits

_DTYPE_TAG = {
    np.float32: "fp32",
    np.float16: "fp16",
    np.int8: "int8",
    np.uint8: "bin1",
}


def _tag_of(np_type) -> str:
    if np_type is torch.bfloat16:
        return "bf16"
    try:
        if np.dtype(np_type).name == BF16_NAME:
            return "bf16"
    except TypeError:
        pass
    return _DTYPE_TAG.get(np_type, "fp32")


class IndexWrap:
    """reference python/knowhere/knowhere.i:171-235."""

    def __init__(self, name: str, version: Optional[int] = None, type=np.float32):  # noqa: A002
        created = IndexFactory.Instance().Create(
            name, version=version, data_type=_tag_of(type)
        )
        if not created.has_value():
            raise ValueError(created.what())
        self._index = created.value()

    def Build(self, dataset: DataSet, json_str: str) -> Status:
        return self._index.Build(dataset, _json.loads(json_str))

    def Train(self, dataset: DataSet, json_str: str) -> Status:
        return self._index.Train(dataset, _json.loads(json_str))

    def Add(self, dataset: DataSet, json_str: str) -> Status:
        return self._index.Add(dataset, _json.loads(json_str))

    def Search(self, dataset: DataSet, json_str: str, bitset=None) -> Tuple[Optional[DataSet], Status]:
        res = self._index.Search(dataset, _json.loads(json_str), bitset)
        return (res.value(), Status.success) if res.has_value() else (None, res.error())

    def RangeSearch(self, dataset: DataSet, json_str: str, bitset=None) -> Tuple[Optional[DataSet], Status]:
        res = self._index.RangeSearch(dataset, _json.loads(json_str), bitset)
        return (res.value(), Status.success) if res.has_value() else (None, res.error())

    def GetVectorByIds(self, dataset: DataSet) -> Tuple[Optional[DataSet], Status]:
        res = self._index.GetVectorByIds(dataset)
        return (res.value(), Status.success) if res.has_value() else (None, res.error())

    def HasRawData(self, metric_type: str = "L2") -> bool:
        return self._index.HasRawData(metric_type)

    def Serialize(self, binset: BinarySet) -> Status:
        return self._index.Serialize(binset)

    def Deserialize(self, binset: BinarySet, json_str: str = "{}") -> Status:
        return self._index.Deserialize(binset, _json.loads(json_str))

    def DeserializeFromFile(self, filename: str, json_str: str = "{}") -> Status:
        return self._index.DeserializeFromFile(filename, _json.loads(json_str))

    def Dim(self) -> int:
        return self._index.Dim()

    def Count(self) -> int:
        return self._index.Count()

    def Size(self) -> int:
        return self._index.Size()

    def Type(self) -> str:
        return self._index.Type()


def CreateIndex(name, version=None, type=np.float32):  # noqa: A002
    return IndexWrap(name, version, type)


def GetCurrentVersion() -> int:
    return Version.GetCurrentVersion().VersionCode()


def CreateBinarySet() -> BinarySet:
    return BinarySet()


GetBinarySet = CreateBinarySet


def GetNullDataSet() -> DataSet:
    return DataSet()


def GetNullBitSetView():
    return BitsetView.empty()


def CreateBitSet(bits_num: int) -> BitsetView:
    return BitsetView.from_bool_array(np.zeros(bits_num, dtype=bool))


def ArrayToDataSet(arr: np.ndarray) -> DataSet:
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 2:
        raise ValueError("expect 2-D array")
    if arr.dtype == np.uint8:
        ds = DataSet()
        ds.set("tensor", arr)
        ds.rows = arr.shape[0]
        ds.dim = arr.shape[1] * 8  # packed binary: dim is bits
        return ds
    return GenDataSetFromArray(arr)


def ArrayToSparseDataSet(data, indices, indptr) -> DataSet:
    rows = [
        {int(d): float(v) for d, v in zip(indices[indptr[i] : indptr[i + 1]], data[indptr[i] : indptr[i + 1]])}
        for i in range(len(indptr) - 1)
    ]
    dim = int(max((max(r) for r in rows if r), default=0)) + 1
    return GenSparseDataSet(rows, dim)


def DataSetToArray(ans: DataSet):
    nq, k = ans.rows, ans.dim
    return ans.distance.reshape(nq, k).copy(), ans.ids.reshape(nq, k).copy()


def RangeSearchDataSetToArray(ans: DataSet):
    lims = ans.lims
    return ans.distance.copy(), ans.ids.copy(), lims.copy()


def GetVectorDataSetToArray(ans: DataSet):
    return as_f32(ans.tensor)


def BruteForceSearch(base, query, json_str: str, bitset=None):
    res = _BF.Search(base, query, _json.loads(json_str), bitset)
    return (res.value(), Status.success) if res.has_value() else (None, res.error())


def BruteForceRangeSearch(base, query, json_str: str, bitset=None):
    res = _BF.RangeSearch(base, query, _json.loads(json_str), bitset)
    return (res.value(), Status.success) if res.has_value() else (None, res.error())


def Dump(binset: BinarySet, file_name: str) -> None:
    blobs = {name: binset.GetByName(name).tobytes() for name in binset.keys()}
    from .io.serialize import write_sections

    arrays = {k: np.frombuffer(v, dtype=np.uint8) for k, v in blobs.items()}
    with open(file_name, "wb") as f:
        f.write(write_sections(arrays, meta={"compat_dump": True}))


def Load(binset: BinarySet, file_name: str) -> bool:
    from .io.serialize import read_sections

    data = np.memmap(file_name, dtype=np.uint8, mode="r")
    arrays, meta = read_sections(memoryview(data))
    for name, arr in arrays.items():
        binset.Append(name, arr)
    return True


def SetSimdType(type):  # noqa: A002
    KnowhereConfig.SetSimdType(str(type))


def SetBuildThreadPool(num_threads: int) -> None:
    KnowhereConfig.SetBuildThreadPoolSize(num_threads)


def SetSearchThreadPool(num_threads: int) -> None:
    KnowhereConfig.SetSearchThreadPoolSize(num_threads)


# --- SWIG-surface helpers (reference python/knowhere/knowhere.i) -------------


class BitSet:
    """Mutable bitset (reference knowhere.i:306-331): SetBit marks a
    row filtered-out; GetBitSetView yields the view passed to Search. The
    reference view reads live C++ memory, so mutations after a view is taken
    must stay visible — our BitsetView caches its popcount and device mask,
    so SetBit invalidates every issued view's caches."""

    def __init__(self, num_bits: int):
        self._bits = np.zeros((num_bits + 7) // 8, dtype=np.uint8)
        self._num_bits = int(num_bits)
        self._views = []

    def SetBit(self, idx: int) -> None:
        self._bits[idx >> 3] |= 1 << (idx & 7)
        for v in self._views:
            v._filtered_cnt = None
            v._dev_cache = None

    def GetBitSetView(self):
        from .bitset import BitsetView

        v = BitsetView(self._bits, self._num_bits)
        self._views.append(v)
        return v


class AnnIteratorWrap:
    """reference knowhere.i:140-168: HasNext/Next over an index iterator."""

    def __init__(self, it):
        if it is None:
            raise RuntimeError("ann iterator must not be nullptr.")
        self._it = it

    def HasNext(self) -> bool:
        return self._it.HasNext()

    def Next(self):
        return self._it.Next()


def GetAnnIterator(index: "IndexWrap", dataset: DataSet, json_str: str, bitset=None):
    """reference knowhere.i:216-230 (IndexWrap::GetAnnIterator)."""
    res = index._index.AnnIterator(dataset, _json.loads(json_str or "{}"), bitset)
    if not res.has_value():
        raise RuntimeError(f"GetAnnIterator failed: {res.what()}")
    return [AnnIteratorWrap(it) for it in res.value()]


def default_json_str() -> str:
    return "{}"


def DataSetTensor2Array(ds: DataSet) -> np.ndarray:
    return as_f32(ds.tensor).reshape(ds.rows, ds.dim)


def Float16DataSetTensor2Array(ds: DataSet) -> np.ndarray:
    return as_f32(ds.tensor).astype(np.float16).reshape(ds.rows, ds.dim)


def BFloat16DataSetTensor2Array(ds: DataSet) -> np.ndarray:
    """The rows as bf16 uint16 bit patterns (utils/bf16.py)."""
    return bf16_bits(ds.tensor).reshape(ds.rows, ds.dim)


def Int8DataSetTensor2Array(ds: DataSet) -> np.ndarray:
    return as_f32(ds.tensor).astype(np.int8).reshape(ds.rows, ds.dim)


def BinaryDataSetTensor2Array(ds: DataSet) -> np.ndarray:
    t = np.asarray(ds.tensor).view(np.uint8)
    return t.reshape(ds.rows, -1)


def DataSet2Array(ds: DataSet):
    """kNN result -> (dists (nq,k), ids (nq,k)) float64/int64 arrays."""
    nq = ds.rows
    ids = np.asarray(ds.ids, dtype=np.int64).reshape(nq, -1)
    dis = np.asarray(ds.distance, dtype=np.float32).reshape(nq, -1)
    return dis, ids


def DataSet_Rows(ds: DataSet) -> int:
    return ds.rows


def DataSet_Dim(ds: DataSet) -> int:
    return ds.dim


def DumpRangeResultIds(ds: DataSet) -> np.ndarray:
    return np.asarray(ds.ids, dtype=np.int64).reshape(-1)


def DumpRangeResultDis(ds: DataSet) -> np.ndarray:
    return np.asarray(ds.distance, dtype=np.float32).reshape(-1)


def DumpRangeResultLimits(ds: DataSet) -> np.ndarray:
    return np.asarray(ds.get("lims"), dtype=np.int64).reshape(-1)


def setOffsets(ds: DataSet, offsets) -> None:
    """Attach per-document emb_list offsets (reference knowhere.i:332-339,
    meta::EMB_LIST_OFFSET = 'lims')."""
    ds.set("lims", np.asarray(offsets, dtype=np.int64))


def WriteIndexToDisk(binset: BinarySet, index_name: str, file_name: str) -> None:
    """Persist one named blob from a BinarySet to disk (reference knowhere.i
    WriteIndexToDisk); pairs with Index.DeserializeFromFile."""
    b = binset.GetByName(index_name)
    if b is None:
        raise KeyError(index_name)
    with open(file_name, "wb") as f:
        f.write(bytes(b.tobytes()))
