"""SVS registrations, Intel Scalable Vector Search's surface (counterpart of
knowhere_tpu/models/svs.py).

Parity target: reference src/index/svs/svs_vamana.cc:522-526 + svs_config.h:
SVS_FLAT and SVS_VAMANA (plus the LVQ and LeanVec stores) with the svs_*
parameter names (index_param.h:211-219). SVS_FLAT is FLAT's exact scan;
SVS_VAMANA maps its graph knobs onto the flat diversified graph engine of
models/hnsw.py (svs_graph_max_degree -> M, svs_construction_window_size ->
efConstruction, svs_search_window_size -> ef); SVS_VAMANA_LVQ keeps a
per-vector 8-bit LVQ store (ops/quant.py lvq_*), decoded inside the walks;
SVS_VAMANA_LEANVEC walks a PCA-reduced store and reranks at full width.
"""

from __future__ import annotations

from ..config import Entry, Stage, Status
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum
from .flat import FlatIndexNode
from .hnsw import BaseHnswConfig, HnswFlatNode


class SvsVamanaConfig(BaseHnswConfig):
    svs_graph_max_degree = Entry(int, range=(2, 2048), stages=[Stage.TRAIN], allow_empty=True)
    svs_construction_window_size = Entry(int, range=(1, None), stages=[Stage.TRAIN], allow_empty=True)
    svs_search_window_size = Entry(int, range=(1, None), stages=[Stage.SEARCH, Stage.ITERATOR], allow_empty=True)
    svs_search_buffer_capacity = Entry(int, range=(1, None), stages=[Stage.SEARCH], allow_empty=True)
    svs_alpha = Entry(float, range=(0.5, 4.0), stages=[Stage.TRAIN], allow_empty=True)
    svs_storage_kind = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    svs_leanvec_dim = Entry(int, range=(1, 65536), stages=[Stage.TRAIN], allow_empty=True)

    def check_and_adjust(self, stage):
        st, msg = super().check_and_adjust(stage)
        if st != Status.success:
            return st, msg
        # the svs_* knobs onto the graph engine's
        if self.svs_graph_max_degree is not None:
            object.__setattr__(self, "M", self.svs_graph_max_degree)
        if self.svs_construction_window_size is not None:
            object.__setattr__(self, "efConstruction", self.svs_construction_window_size)
        if self.svs_search_window_size is not None and self.ef is None:
            object.__setattr__(self, "ef", self.svs_search_window_size)
        return Status.success, ""


class SvsVamanaNode(HnswFlatNode):
    @classmethod
    def CreateConfig(cls):
        return SvsVamanaConfig()


class SvsVamanaLvqNode(HnswFlatNode):
    """The LVQ store: a per-vector 8-bit grid over the mean-centred residual,
    decoded on the device inside the walks (the inline walk reranks by the
    exact decode)."""

    VARIANT = "lvq"

    @classmethod
    def CreateConfig(cls):
        return SvsVamanaConfig()


class SvsVamanaLeanVecNode(HnswFlatNode):
    """LeanVec: the walk scores in a PCA-reduced store of svs_leanvec_dim
    dims (default dim / 2) and the whole window reranks at full width from
    the raw refine store before the top k is returned."""

    VARIANT = "leanvec"

    @classmethod
    def CreateConfig(cls):
        return SvsVamanaConfig()


_F = feature
_DENSE = ("fp32", "fp16", "bf16", "int8")

register_index(IndexEnum.INDEX_SVS_FLAT, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.NO_TRAIN)(FlatIndexNode)
register_index(IndexEnum.INDEX_SVS_VAMANA, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN)(SvsVamanaNode)
register_index(IndexEnum.INDEX_SVS_VAMANA_LVQ, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN)(SvsVamanaLvqNode)
register_index(IndexEnum.INDEX_SVS_VAMANA_LEANVEC, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN)(SvsVamanaLeanVecNode)
# the deprecated registrations: hnswlib's (reference src/index/hnsw/hnsw.cc)
# and faiss's (faiss_hnsw.cc:3255-3261), over every dense type and binary
for _name in (IndexEnum.INDEX_HNSW_DEPRECATED, "HNSW_DEPRECATED"):
    register_index(_name, _DENSE + ("bin1",), _F.ALL_DENSE_TYPE | _F.BINARY | _F.KNN)(HnswFlatNode)
