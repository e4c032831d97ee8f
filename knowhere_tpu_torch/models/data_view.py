"""SCANN_DVR: data-view dense index, the index does NOT own raw vectors
(counterpart of knowhere_tpu/models/data_view.py).

Behavioral parity target: reference src/index/data_view_dense_index/
(data_view_dense_index.h:41-60 ViewDataOp callback fetching rows from caller
memory, index_node_with_data_view_refiner.h wrapping a base ANN (SCANN) with a
data-view refine stage, refine_computer.h quantized in-memory refine copies
UINT8/FP16/BF16 per RefineType, index_param.h:286-291).

The injected `object` (the reference's Pack DI) must expose
`view_data(ids: np.ndarray) -> np.ndarray` returning the raw rows. The coarse
stage is the port's SCANN node (under FAST, the ADC scan kernel over its
nibble codes); refine fetches either through the view (DATA_VIEW) or from a
quantized device copy (ops/refine.refine_topk).

The quantized copy holds every added row, in id order: an Add after the
first appends its rows encoded with the first Add's codec (UINT8_QUANT: the
SQ8 grid trained there), as the IVF refine stores grow. The JAX package
replaces the copy with the rows of the last Add, so the candidate ids of
earlier rows index the wrong rows there. bf16 rows widen from their uint16
bit patterns (utils/bf16.py) before the base and the copy see them.

Deserialize restores neither refine_type nor the refine copy (neither is in
the blob, as in the JAX package): a loaded node refines through the view,
or answers invalid_args without one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import Config, Entry, Stage
from ..dataset import DataSet, GenDataSetFromArray, GenResultDataSet
from ..device import to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum, RefineType, metric as M, normalize_metric
from ..index_node import IndexNode
from ..ops import quant as Q
from ..ops.refine import RefineStore, refine_topk
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import as_f32, bf16_bits, rows_to_device
from .ivf import ScannConfig, ScannNode


class ScannDvrConfig(ScannConfig):
    refine_type = Entry(int, default=RefineType.DATA_VIEW, range=(0, 3), stages=[Stage.TRAIN])


def _normalized(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    n[n == 0] = 1.0
    return x / n


class ScannDvrNode(IndexNode):
    """IndexNodeWithDataViewRefiner(SCANN) equivalent."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_FAISS_SCANN_DVR
        self.data_type = "fp32"
        self.view = object  # must provide view_data(ids)
        self._base = ScannNode(version=version)
        self._base.index_type = IndexEnum.INDEX_FAISS_SCANN
        self._refine_type = RefineType.DATA_VIEW
        self._refine_store: Optional[RefineStore] = None
        self._sq = None  # the UINT8_QUANT codec of the first Add
        self._metric = M.L2
        self._count = 0

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        self._refine_type = int(cfg.get("refine_type", RefineType.DATA_VIEW) or 0)
        base_cfg = self._base.CreateConfig()
        raw = cfg.to_dict()
        raw["with_raw_data"] = False  # DVR never duplicates raw data in the index
        st, msg = Config.load(base_cfg, raw, Stage.TRAIN)
        if st != Status.success:
            raise KnowhereException(msg, st)
        self._base_cfg_train = base_cfg
        return self._base.Train(GenDataSetFromArray(as_f32(dataset.tensor)), base_cfg)

    def _encode(self, x: np.ndarray) -> torch.Tensor:
        """Device refine rows of ``x`` (f32) in this node's refine type."""
        if self._refine_type == RefineType.UINT8_QUANT:
            if self._sq is None:
                self._sq = Q.sq_train(x, "SQ8")
            return to_device(Q.sq_encode(self._sq, x))
        if self._refine_type == RefineType.FLOAT16_QUANT:
            return to_device(x.astype(np.float16))
        return rows_to_device(bf16_bits(x))

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        x = as_f32(dataset.tensor)
        st = self._base.Add(GenDataSetFromArray(x), self._base_cfg_train)
        if st != Status.success:
            return st
        self._count = self._base.Count()
        if self._refine_type not in (
            RefineType.UINT8_QUANT, RefineType.FLOAT16_QUANT, RefineType.BFLOAT16_QUANT
        ):
            self._refine_store = None  # fetch through the data view per search
            return Status.success
        rows = self._encode(x)
        if self._refine_store is not None:
            rows = torch.cat([self._refine_store.data, rows])
        if self._refine_type == RefineType.UINT8_QUANT:
            self._refine_store = RefineStore(
                "sq8", rows, to_device(self._sq.vmin), to_device(self._sq.vdiff)
            )
        else:
            self._refine_store = RefineStore("raw", rows)
        return Status.success

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(Status.invalid_metric_type, "metric mismatch")
        k = cfg.k
        reorder_k = cfg.get("reorder_k") or max(4 * k, 100)
        # filtered search: widen the coarse stage so enough candidates survive
        # the bitset; materialized-view hints (reference comp/
        # materialized_view.h:21-45, feature::MV consumer) mark clustered
        # filters (pure-AND over few categories), which strand coarse
        # candidates harder: widen further.
        if not bitset.empty_view():
            ratio = bitset.filter_ratio()
            widen = 1.0 / max(1.0 - ratio, 0.05)
            mv = cfg.get("materialized_view_search_info")
            if isinstance(mv, dict):
                touched = mv.get("field_id_to_touched_categories_cnt", {})
                if (
                    mv.get("is_pure_and", False)
                    and not mv.get("has_not", False)
                    and touched
                    and max(touched.values()) <= 2
                ):
                    widen *= 2.0
            reorder_k = int(min(reorder_k * widen, max(self._count, 1)))
        kc = int(min(reorder_k, max(self._count, 1)))
        coarse_cfg = self._base.CreateConfig()
        Config.load(
            coarse_cfg,
            {"metric_type": metric, "k": kc, "nprobe": cfg.get("nprobe", 8) or 8},
            Stage.SEARCH,
        )
        xq = as_f32(dataset.tensor)
        res = self._base.Search(GenDataSetFromArray(xq), coarse_cfg, bitset)
        if not res.has_value():
            return res
        nq = dataset.rows
        cand = res.value().ids.reshape(nq, kc).astype(np.int32)
        is_l2 = metric == M.L2
        if self._metric == M.COSINE:
            xq = _normalized(xq)

        if self._refine_store is not None:
            dists, ids = refine_topk(xq, self._refine_store, cand, k, is_l2)
        else:
            if self.view is None or not hasattr(self.view, "view_data"):
                return expected.Err(
                    Status.invalid_args, "SCANN_DVR with DATA_VIEW refine requires a view_data object"
                )
            uniq = np.unique(cand[cand >= 0])
            rows = as_f32(self.view.view_data(uniq))
            if self._metric == M.COSINE:
                rows = _normalized(rows)
            # vectorized remap (np.unique output is sorted)
            local = np.full_like(cand, -1)
            pos = cand >= 0
            local[pos] = np.searchsorted(uniq, cand[pos]).astype(cand.dtype)
            store = RefineStore("raw", to_device(rows))
            dists, loc = refine_topk(xq, store, local, k, is_l2)
            ids = np.where(loc >= 0, uniq[np.clip(loc, 0, None)], -1)
        return expected.Ok(GenResultDataSet(nq, k, ids.astype(np.int64), dists))

    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        return self._base.RangeSearch(GenDataSetFromArray(as_f32(dataset.tensor)), cfg, bitset)

    def AnnIterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True):
        return self._base.AnnIterator(
            GenDataSetFromArray(as_f32(dataset.tensor)), cfg, bitset, use_knowhere_search_pool
        )

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        return expected.Err(Status.not_implemented, "SCANN_DVR does not own raw data")

    def IsAdditionalScalarSupported(self, is_mv_only: bool = False) -> bool:
        # consumes MV hints (coarse-stage widening): reference feature::MV
        return True

    def HasRawData(self, metric_type: str = "L2") -> bool:
        return False

    def Serialize(self, binset: BinarySet) -> Status:
        return self._base.Serialize(binset)

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        st = self._base.Deserialize(binset, cfg)
        if st == Status.success:
            self._count = self._base.Count()
            self._metric = self._base._metric
        return st

    def Dim(self) -> int:
        return self._base.Dim()

    def Size(self) -> int:
        return self._base.Size()

    def Count(self) -> int:
        return self._base.Count()

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return ScannDvrConfig()


register_index(
    IndexEnum.INDEX_FAISS_SCANN_DVR,
    ("fp32", "fp16", "bf16", "int8"),
    feature.ALL_DENSE_TYPE | feature.KNN | feature.MV,
)(ScannDvrNode)
