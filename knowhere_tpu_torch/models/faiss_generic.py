"""Generic "FAISS" node: faiss index_factory description strings
(counterpart of knowhere_tpu/models/faiss_generic.py).

Parity target: reference src/index/faiss/faiss.cc:73-429 (FaissIndexNode):
a thin node that builds an index from a faiss factory description
("Flat", "IVF1024,Flat", "IVF256,PQ16", "IVF64,SQ8", "HNSW32", ...) so hosts
that speak description strings keep working. The string is parsed and
mapped onto the port's FLAT, IVF_FLAT, IVF_PQ, IVF_SQ8 and HNSW nodes; the
description travels in a FAISS_DESC blob beside the inner node's, so a
BinarySet loads in either package.

An Add after Deserialize loads the caller's config (with the description's
parameters) into the inner node's config; the JAX package keeps the train
config only from Train and fails there.
"""

from __future__ import annotations

import re
from typing import Optional

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum
from ..index_node import IndexNode
from ..status import KnowhereException, Status, expected


class FaissConfig(BaseConfig):
    index_description = Entry(str, default="Flat", stages=[Stage.TRAIN])
    nprobe = Entry(int, default=8, range=(1, 65536), stages=[Stage.SEARCH, Stage.ITERATOR, Stage.RANGE_SEARCH])
    ef = Entry(int, range=(1, None), stages=[Stage.SEARCH, Stage.ITERATOR], allow_empty=True)
    reorder_k = Entry(int, range=(1, None), stages=[Stage.SEARCH], allow_empty=True)
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])


def _parse_description(desc: str):
    """description string -> (inner index type, extra train params)."""
    desc = desc.strip()
    if desc.upper() in ("FLAT", "IDMAP"):
        return IndexEnum.INDEX_FAISS_IDMAP, {}
    m = re.fullmatch(r"HNSW(\d+)", desc, re.I)
    if m:
        return IndexEnum.INDEX_HNSW, {"M": int(m.group(1))}
    m = re.fullmatch(r"IVF(\d+)\s*,\s*(.+)", desc, re.I)
    if m:
        nlist, sub = int(m.group(1)), m.group(2).strip()
        if sub.upper() == "FLAT":
            return IndexEnum.INDEX_FAISS_IVFFLAT, {"nlist": nlist}
        pm = re.fullmatch(r"PQ(\d+)(?:x(\d+))?", sub, re.I)
        if pm:
            params = {"nlist": nlist, "m": int(pm.group(1))}
            if pm.group(2):
                params["nbits"] = int(pm.group(2))
            return IndexEnum.INDEX_FAISS_IVFPQ, params
        sm = re.fullmatch(r"SQ(\d+|fp16|bf16)", sub, re.I)
        if sm:
            return IndexEnum.INDEX_FAISS_IVFSQ8, {"nlist": nlist, "sq_type": f"SQ{sm.group(1)}".upper() if sm.group(1).isdigit() else sm.group(1).upper()}
    raise KnowhereException(f"unsupported faiss description '{desc}'", Status.invalid_param_in_json)


class FaissIndexNode(IndexNode):
    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_FAISS
        self.data_type = "fp32"
        self._inner: Optional[IndexNode] = None
        self._desc = "Flat"
        self._inner_train_cfg: Optional[Config] = None

    def _make_inner(self, name: str) -> IndexNode:
        from ..factory import IndexFactory

        factory = IndexFactory.Instance()
        ctor, _ = factory._registry[(name, self.data_type)]
        node = ctor(version=self.version)
        return node

    def _inner_build_cfg(self, cfg: Config) -> Config:
        """The inner node's TRAIN config: the caller's keys and the
        description's parameters."""
        inner_cfg = self._inner.CreateConfig()
        raw = cfg.to_dict()
        raw.update(_parse_description(self._desc)[1])
        st, msg = Config.load(inner_cfg, raw, Stage.TRAIN)
        if st != Status.success:
            raise KnowhereException(msg, st)
        return inner_cfg

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._desc = cfg.get("index_description", "Flat") or "Flat"
        name, _ = _parse_description(self._desc)
        self._inner = self._make_inner(name)
        self._inner_train_cfg = self._inner_build_cfg(cfg)
        return self._inner.Train(dataset, self._inner_train_cfg)

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        if self._inner is None:
            return Status.empty_index
        if self._inner_train_cfg is None:  # loaded, not trained here
            self._inner_train_cfg = self._inner_build_cfg(cfg)
        return self._inner.Add(dataset, self._inner_train_cfg)

    def _inner_search_cfg(self, cfg: Config, stage: Stage) -> Config:
        inner_cfg = self._inner.CreateConfig()
        st, msg = Config.load(inner_cfg, cfg.to_dict(), stage)
        if st != Status.success:
            raise KnowhereException(msg, st)
        return inner_cfg

    def Search(self, dataset, cfg, bitset) -> "expected[DataSet]":
        if self._inner is None:
            return expected.Err(Status.empty_index, "not built")
        return self._inner.Search(dataset, self._inner_search_cfg(cfg, Stage.SEARCH), bitset)

    def RangeSearch(self, dataset, cfg, bitset) -> "expected[DataSet]":
        if self._inner is None:
            return expected.Err(Status.empty_index, "not built")
        return self._inner.RangeSearch(dataset, self._inner_search_cfg(cfg, Stage.RANGE_SEARCH), bitset)

    def AnnIterator(self, dataset, cfg, bitset, use_knowhere_search_pool=True):
        if self._inner is None:
            return expected.Err(Status.empty_index, "not built")
        return self._inner.AnnIterator(dataset, self._inner_search_cfg(cfg, Stage.ITERATOR), bitset)

    def GetVectorByIds(self, dataset) -> "expected[DataSet]":
        if self._inner is None:
            return expected.Err(Status.empty_index, "not built")
        return self._inner.GetVectorByIds(dataset)

    def HasRawData(self, metric_type: str = "L2") -> bool:
        return self._inner.HasRawData(metric_type) if self._inner else False

    def Serialize(self, binset: BinarySet) -> Status:
        if self._inner is None:
            return Status.empty_index
        st = self._inner.Serialize(binset)
        if st == Status.success:
            binset.Append("FAISS_DESC", self._desc.encode())
        return st

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        desc_blob = binset.GetByName("FAISS_DESC")
        if desc_blob is None:
            return Status.invalid_binary_set
        self._desc = desc_blob.tobytes().decode()
        name, _ = _parse_description(self._desc)
        self._inner = self._make_inner(name)
        self._inner_train_cfg = None
        return self._inner.Deserialize(binset, cfg)

    def Dim(self) -> int:
        return self._inner.Dim() if self._inner else 0

    def Size(self) -> int:
        return self._inner.Size() if self._inner else 0

    def Count(self) -> int:
        return self._inner.Count() if self._inner else 0

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return FaissConfig()


register_index(
    IndexEnum.INDEX_FAISS, ("fp32",), feature.FLOAT32 | feature.KNN
)(FaissIndexNode)
