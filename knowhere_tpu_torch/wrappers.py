"""IndexNode wrappers (counterpart of knowhere_tpu/wrappers.py).

- IndexNodeDataMockWrapper: converts fp16/bf16/int8 datasets to fp32 before
  delegating (reference include/knowhere/index/index_node_data_mock_wrapper.h,
  used by KNOWHERE_MOCK_REGISTER_GLOBAL). bf16 rows are their uint16 bit
  patterns on the host (utils/bf16.py) and widen exactly, never as numbers.
- IndexNodeThreadPoolWrapper: serializes access to the wrapped node
  (reference include/knowhere/index/index_node_thread_pool_wrapper.h: GPU
  indexes get a dedicated serializing pool; here a per-node lock keeps
  device-state mutations exclusive).
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from .dataset import DataSet
from .index_node import IndexNode
from .utils.bf16 import as_f32


def _to_fp32_dataset(dataset: DataSet) -> DataSet:
    t = dataset.tensor
    if t is None or dataset.is_sparse:
        return dataset
    arr = np.asarray(t)
    if arr.dtype in (np.float32, np.uint8):
        return dataset
    ds = DataSet()
    ds.set("tensor", as_f32(arr))
    ds.rows = dataset.rows
    ds.dim = dataset.dim
    if dataset.ids is not None:
        ds.ids = dataset.ids
    if dataset.lims is not None:
        ds.lims = dataset.lims
    return ds


class IndexNodeDataMockWrapper(IndexNode):
    def __init__(self, inner: IndexNode):
        super().__init__(inner.version, inner.object)
        self._inner = inner
        self.index_type = inner.Type()
        self.data_type = "fp32"

    def Train(self, dataset, cfg):
        return self._inner.Train(_to_fp32_dataset(dataset), cfg)

    def Add(self, dataset, cfg):
        return self._inner.Add(_to_fp32_dataset(dataset), cfg)

    def Search(self, dataset, cfg, bitset):
        return self._inner.Search(_to_fp32_dataset(dataset), cfg, bitset)

    def RangeSearch(self, dataset, cfg, bitset):
        return self._inner.RangeSearch(_to_fp32_dataset(dataset), cfg, bitset)

    def AnnIterator(self, dataset, cfg, bitset, use_knowhere_search_pool=True):
        return self._inner.AnnIterator(_to_fp32_dataset(dataset), cfg, bitset, use_knowhere_search_pool)

    def GetVectorByIds(self, dataset):
        return self._inner.GetVectorByIds(dataset)

    def HasRawData(self, metric_type="L2"):
        return self._inner.HasRawData(metric_type)

    def Serialize(self, binset):
        return self._inner.Serialize(binset)

    def Deserialize(self, binset, cfg):
        return self._inner.Deserialize(binset, cfg)

    def DeserializeFromFile(self, filename, cfg):
        return self._inner.DeserializeFromFile(filename, cfg)

    def Dim(self):
        return self._inner.Dim()

    def Size(self):
        return self._inner.Size()

    def Count(self):
        return self._inner.Count()

    def Type(self):
        return self._inner.Type()

    def CreateConfig(self):
        return self._inner.CreateConfig()


class IndexNodeThreadPoolWrapper(IndexNode):
    """Serializes every call into the wrapped node behind one lock."""

    def __init__(self, inner: IndexNode):
        super().__init__(inner.version, inner.object)
        self._inner = inner
        self._lock = threading.Lock()
        self.index_type = inner.Type()
        self.data_type = getattr(inner, "data_type", "fp32")

    def _locked(self, fn, *args, **kw):
        with self._lock:
            return fn(*args, **kw)

    def Train(self, dataset, cfg):
        return self._locked(self._inner.Train, dataset, cfg)

    def Add(self, dataset, cfg):
        return self._locked(self._inner.Add, dataset, cfg)

    def Search(self, dataset, cfg, bitset):
        return self._locked(self._inner.Search, dataset, cfg, bitset)

    def RangeSearch(self, dataset, cfg, bitset):
        return self._locked(self._inner.RangeSearch, dataset, cfg, bitset)

    def AnnIterator(self, dataset, cfg, bitset, use_knowhere_search_pool=True):
        return self._locked(self._inner.AnnIterator, dataset, cfg, bitset, use_knowhere_search_pool)

    def GetVectorByIds(self, dataset):
        return self._locked(self._inner.GetVectorByIds, dataset)

    def HasRawData(self, metric_type="L2"):
        return self._inner.HasRawData(metric_type)

    def Serialize(self, binset):
        return self._locked(self._inner.Serialize, binset)

    def Deserialize(self, binset, cfg):
        return self._locked(self._inner.Deserialize, binset, cfg)

    def DeserializeFromFile(self, filename, cfg):
        return self._locked(self._inner.DeserializeFromFile, filename, cfg)

    def Dim(self):
        return self._inner.Dim()

    def Size(self):
        return self._inner.Size()

    def Count(self):
        return self._inner.Count()

    def Type(self):
        return self._inner.Type()

    def CreateConfig(self):
        return self._inner.CreateConfig()
