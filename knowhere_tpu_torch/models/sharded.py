"""SHARDED_* index nodes — the sharding layer on the public API (counterpart
of knowhere_tpu/models/sharded.py).

SHARDED_FLAT, SHARDED_IVF_FLAT, SHARDED_IVF_SQ8, SHARDED_IVF_PQ and
SHARDED_HNSW build ONE logical index whose rows are spread over a list of
devices, with the Build / Search / Serialize / Deserialize surface (and
bitset filtering) of the single-device nodes. The devices are every visible
CUDA device while the port's device is CUDA (the port's device itself when
the caller selected the CPU), or the list the factory's ``object`` carries:
``Create("SHARDED_IVF_PQ", object=[torch.device("cuda", 0)] * 4)`` puts
four shards on one card.

Serialization stores the LOGICAL index (global payload and list
assignment, or the per-shard graphs), not the placement: Deserialize
re-distributes onto the loader's device list, and the sections are the
JAX package's, so a BinarySet written by either package loads in the
other.

Engines: parallel/sharding.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import Config
from ..dataset import DataSet, GenResultDataSet, GenTensorDataSet
from ..device import to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum, normalize_metric
from ..index_node import IndexNode, PrecomputedDistanceIterator
from ..io.serialize import read_sections, write_sections
from ..status import Status, expected
from .ivf import IvfFlatConfig, IvfPqConfig, IvfSqConfig, match_nlist

_DENSE_METRICS = ("L2", "IP", "COSINE")


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x.astype(np.float32), axis=1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(np.float32)


class _ShardedDenseBase(IndexNode):
    """Shared plumbing: metric validation, cosine as normalize-then-IP, the
    bitset's host keep-mask, the device list."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.data_type = "fp32"
        self._metric = "L2"
        self._dim = 0
        self._rows = 0
        # `object` may carry an explicit device list; the default is
        # parallel/sharding.default_devices()
        self._devices = None
        if object is not None and hasattr(object, "__iter__"):
            self._devices = list(object)

    def _devs(self):
        from ..parallel.sharding import make_devices

        return make_devices(self._devices)

    def _check_metric(self, cfg: Config) -> Optional[Status]:
        metric = normalize_metric(cfg.metric_type)
        if metric not in _DENSE_METRICS:
            return Status.invalid_metric_type
        self._metric = metric
        return None

    def _engine_metric(self) -> str:
        # cosine = normalized rows and queries, then IP; the distances
        # returned are similarities
        return "IP" if self._metric == "COSINE" else self._metric

    def _prep_base(self, xb: np.ndarray) -> np.ndarray:
        xb = np.asarray(xb, dtype=np.float32)
        return _normalize_rows(xb) if self._metric == "COSINE" else xb

    def _prep_queries(self, xq: np.ndarray) -> np.ndarray:
        xq = np.asarray(xq, dtype=np.float32)
        return _normalize_rows(xq) if self._metric == "COSINE" else xq

    def _keep(self, bitset: BitsetView) -> Optional[np.ndarray]:
        return None if bitset.empty_view() else bitset.host_mask(self.Count())

    def Dim(self) -> int:
        return self._dim

    def Count(self) -> int:
        return self._rows

    def Type(self) -> str:
        return self.index_type


# ---------------------------------------------------------------------------
# SHARDED_FLAT
# ---------------------------------------------------------------------------


class ShardedFlatIndexNode(_ShardedDenseBase):
    """Exact search over row-sharded devices: a top-k a shard, merged on the
    first device (parallel/sharding.sharded_search)."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_SHARDED_FLAT
        self._xb: Optional[np.ndarray] = None
        self._engine = None

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        st = self._check_metric(cfg)
        return st or Status.success

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        xb = np.asarray(dataset.tensor, dtype=np.float32)
        self._dim = dataset.dim
        self._xb = xb if self._xb is None else np.concatenate([self._xb, xb])
        self._rows = self._xb.shape[0]
        self._engine = None
        return Status.success

    def _ensure_engine(self):
        if self._engine is None:
            from ..parallel.sharding import ShardedFlatIndex

            eng = ShardedFlatIndex(self._devs(), metric=self._engine_metric())
            eng.build(self._prep_base(self._xb))
            self._engine = eng
        return self._engine

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        st = self._check_metric(cfg)
        if st:
            return expected.Err(st, f"unsupported metric {cfg.metric_type}")
        if self._xb is None:
            return expected.Err(Status.empty_index, "index not built")
        eng = self._ensure_engine()
        xq = self._prep_queries(dataset.tensor)
        dists, ids = eng.search(xq, cfg.k, bitset_keep=self._keep(bitset))
        return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))

    def AnnIterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView,
                    use_knowhere_search_pool: bool = True) -> "expected[list]":
        # the exact distance row of each query over the logical base
        from ..ops import distances as D

        if self._xb is None:
            return expected.Err(Status.empty_index, "index not built")
        st = self._check_metric(cfg)
        if st:
            return expected.Err(st, f"unsupported metric {cfg.metric_type}")
        metric = self._engine_metric()
        xq = self._prep_queries(dataset.tensor)
        base = to_device(self._prep_base(self._xb))
        aux = D.base_aux(metric, base)
        keep = self._keep(bitset)
        larger = D.larger_is_better(metric)
        its = []
        for s in range(0, xq.shape[0], 256):
            dmat = D.pairwise_distance(metric, to_device(xq[s : s + 256]), base, aux).cpu().numpy()
            for r in range(dmat.shape[0]):
                its.append(PrecomputedDistanceIterator(dmat[r], keep, larger))
        return expected.Ok(its)

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        if self._xb is None:
            return expected.Err(Status.empty_index, "index not built")
        ids = np.asarray(dataset.ids, dtype=np.int64)
        if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self._rows:
            return expected.Err(Status.invalid_args, "id out of range")
        return expected.Ok(GenTensorDataSet(self._xb[ids], len(ids), self._dim))

    @staticmethod
    def HasRawData(metric_type: str) -> bool:
        return True

    def Serialize(self, binset: BinarySet) -> Status:
        if self._xb is None:
            return Status.empty_index
        blob = write_sections(
            {"xb": self._xb},
            meta={"dim": self._dim, "metric": self._metric, "index_type": self.Type()},
        )
        binset.Append(self.Type(), blob)
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        self._xb = np.array(arrays["xb"])
        self._dim = int(meta["dim"])
        self._metric = meta["metric"]
        self._rows = self._xb.shape[0]
        self._engine = None
        return Status.success

    def Size(self) -> int:
        return 0 if self._xb is None else self._xb.nbytes

    @staticmethod
    def CreateConfig() -> Config:
        from .flat import FlatConfig

        return FlatConfig()


# ---------------------------------------------------------------------------
# SHARDED_IVF_{FLAT,SQ8,PQ}
# ---------------------------------------------------------------------------

_IVF_VARIANT = {
    IndexEnum.INDEX_SHARDED_IVFFLAT: "flat",
    IndexEnum.INDEX_SHARDED_IVFSQ8: "sq8",
    IndexEnum.INDEX_SHARDED_IVFPQ: "pq",
}


class ShardedIVFIndexNode(_ShardedDenseBase):
    """IVF with global centroids and codecs and its inverted lists balanced
    over the devices (parallel/sharding.ShardedIVFIndex)."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_SHARDED_IVFFLAT
        self._engine = None

    def _variant(self) -> str:
        return _IVF_VARIANT[self.index_type]

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        st = self._check_metric(cfg)
        if st:
            return st
        self._train_cfg = cfg
        return Status.success

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        from ..parallel.sharding import ShardedIVFIndex

        if self._engine is not None:
            # a second Add would re-encode and re-balance the lists: it is
            # refused, as in the reference (the single-device IVF nodes
            # take Adds)
            return Status.not_implemented
        xb = np.asarray(dataset.tensor, dtype=np.float32)
        self._dim = dataset.dim
        self._rows = xb.shape[0]
        tc = getattr(self, "_train_cfg", cfg)
        nlist = match_nlist(self._rows, int(tc.get("nlist", 128)))
        variant = self._variant()
        m = tc.get("m") if variant == "pq" else 16
        if variant == "pq" and m is None:
            m = max(1, self._dim // 2)
        if variant == "pq" and self._dim % int(m) != 0:
            return Status.invalid_args
        eng = ShardedIVFIndex(devices=self._devs(), metric=self._engine_metric())
        eng.build(
            self._prep_base(xb),
            nlist=nlist,
            variant=variant,
            m=int(m),
            nbits=int(tc.get("nbits", 8)),
            refine=bool(tc.get("refine", False)),
        )
        self._engine = eng
        return Status.success

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        if self._engine is None:
            return expected.Err(Status.empty_index, "index not built")
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(
                Status.invalid_metric_type,
                f"index built with {self._metric}, searched with {metric}",
            )
        xq = self._prep_queries(dataset.tensor)
        dists, ids = self._engine.search(
            xq, cfg.k, nprobe=int(cfg.get("nprobe", 8)),
            bitset_keep=self._keep(bitset),
            refine_k=int(cfg.get("refine_k", 1) or 1),
        )
        return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        eng = self._engine
        if eng is None:
            return expected.Err(Status.empty_index, "index not built")
        if eng._kind != "raw":
            return expected.Err(Status.not_implemented, "quantized sharded IVF holds no raw data")
        ids = np.asarray(dataset.ids, dtype=np.int64)
        if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self._rows:
            return expected.Err(Status.invalid_args, "id out of range")
        return expected.Ok(GenTensorDataSet(eng._payload[ids], len(ids), self._dim))

    def HasRawData(self, metric_type: str) -> bool:  # type: ignore[override]
        return self.index_type == IndexEnum.INDEX_SHARDED_IVFFLAT and self._metric != "COSINE"

    def Serialize(self, binset: BinarySet) -> Status:
        eng = self._engine
        if eng is None:
            return Status.empty_index
        arrays = {
            "centroids": eng._centroids,
            "assign": eng._assign,
            "payload": eng._payload,
        }
        meta = {
            "dim": self._dim,
            "rows": self._rows,
            "metric": self._metric,
            "variant": eng._variant,
            "nlist": eng._nlist,
            "index_type": self.Type(),
        }
        if eng._kind == "pq":
            arrays["codebooks"] = eng._pq.codebooks
            meta["m"] = eng._pq.m
            meta["nbits"] = eng._pq.nbits
            if eng._refine_payload is not None:
                arrays["refine_payload"] = eng._refine_payload
        elif eng._kind == "sq":
            arrays["vmin"] = eng._sq.vmin
            arrays["vdiff"] = eng._sq.vdiff
            meta["sq_type"] = eng._sq.sq_type
        binset.Append(self.Type(), write_sections(arrays, meta=meta))
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        from ..ops.quant import PQCodec, SQCodec
        from ..parallel.sharding import ShardedIVFIndex

        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        self._dim = int(meta["dim"])
        self._rows = int(meta["rows"])
        self._metric = meta["metric"]
        eng = ShardedIVFIndex(devices=self._devs(), metric=self._engine_metric())
        eng._rows = self._rows
        eng._nlist = int(meta["nlist"])
        eng._variant = meta["variant"]
        eng._centroids = np.array(arrays["centroids"])
        eng._assign = np.array(arrays["assign"])
        eng._payload = np.array(arrays["payload"])
        if eng._variant == "pq":
            eng._pq = PQCodec(np.array(arrays["codebooks"]), int(meta["m"]), int(meta["nbits"]))
            eng._kind = "pq"
            eng._refine_payload = np.array(arrays["refine_payload"]) if "refine_payload" in arrays else None
        elif eng._variant == "sq8":
            eng._sq = SQCodec(meta["sq_type"], np.array(arrays["vmin"]), np.array(arrays["vdiff"]), dim=self._dim)
            eng._kind = "sq"
            eng._sq_levels = eng._sq.levels
        else:
            eng._kind = "raw"
        eng._distribute()
        self._engine = eng
        return Status.success

    def Size(self) -> int:
        eng = self._engine
        if eng is None:
            return 0
        return eng._payload.nbytes + eng._centroids.nbytes + eng._assign.nbytes

    def CreateConfig(self) -> Config:  # type: ignore[override]
        if self.index_type == IndexEnum.INDEX_SHARDED_IVFPQ:
            return IvfPqConfig()
        if self.index_type == IndexEnum.INDEX_SHARDED_IVFSQ8:
            return IvfSqConfig()
        return IvfFlatConfig()


# ---------------------------------------------------------------------------
# SHARDED_HNSW
# ---------------------------------------------------------------------------


class ShardedHNSWIndexNode(_ShardedDenseBase):
    """A diversified flat graph a contiguous row shard; each device walks its
    shards (the inline walk where eligible) and the host merges the
    per-shard top-k (parallel/sharding.ShardedGraphIndex)."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_SHARDED_HNSW
        self._engine = None

    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        st = self._check_metric(cfg)
        if st:
            return st
        self._train_cfg = cfg
        return Status.success

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        from ..parallel.sharding import ShardedGraphIndex

        if self._engine is not None:
            return Status.not_implemented
        xb = np.asarray(dataset.tensor, dtype=np.float32)
        self._dim = dataset.dim
        self._rows = xb.shape[0]
        tc = getattr(self, "_train_cfg", cfg)
        eng = ShardedGraphIndex(devices=self._devs(), metric=self._engine_metric())
        eng.build(
            self._prep_base(xb),
            M=int(tc.get("M", 30)),
            ef_construction=int(tc.get("efConstruction", 360)),
        )
        self._engine = eng
        return Status.success

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        if self._engine is None:
            return expected.Err(Status.empty_index, "index not built")
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(
                Status.invalid_metric_type,
                f"index built with {self._metric}, searched with {metric}",
            )
        k = cfg.k
        ef = cfg.get("ef")
        ef = int(max(ef if ef is not None else max(k, 16), k))
        keep = self._keep(bitset)
        # a dense filter goes to the exact scan (the reference's conditional
        # wrapper): a graph walk strands when most nodes are filtered out
        if keep is not None and keep.mean() < 0.12 and not cfg.get("disable_fallback_brute_force", False):
            return self._bf_fallback(dataset, k, keep)
        xq = self._prep_queries(dataset.tensor)
        dists, ids = self._engine.search(xq, k, ef=ef, bitset_keep=keep)
        return expected.Ok(GenResultDataSet(dataset.rows, k, ids, dists))

    def _bf_fallback(self, dataset: DataSet, k: int, keep: np.ndarray) -> "expected[DataSet]":
        from ..ops import distances as D
        from ..ops import topk as T

        xq = self._prep_queries(dataset.tensor)
        base = to_device(self._prep_base(self._engine._xb))
        metric = self._engine_metric()
        ids, dists = T.knn_search(
            xq, base, k, metric, bitset_mask=to_device(keep), aux=D.base_aux(metric, base),
        )
        return expected.Ok(GenResultDataSet(dataset.rows, k, ids, dists))

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        eng = self._engine
        if eng is None:
            return expected.Err(Status.empty_index, "index not built")
        ids = np.asarray(dataset.ids, dtype=np.int64)
        if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self._rows:
            return expected.Err(Status.invalid_args, "id out of range")
        return expected.Ok(GenTensorDataSet(eng._xb[ids], len(ids), self._dim))

    def HasRawData(self, metric_type: str) -> bool:  # type: ignore[override]
        return self._metric != "COSINE"

    def Serialize(self, binset: BinarySet) -> Status:
        eng = self._engine
        if eng is None:
            return Status.empty_index
        arrays = {"xb": eng._xb}
        shards_meta = []
        for i, hg in enumerate(eng._host_graphs):
            arrays[f"graph_{i}"] = hg["graph"]
            arrays[f"entry_{i}"] = hg["entry"]
            shards_meta.append({"row0": int(hg["row0"]), "rows": int(hg["rows"]), "deg": int(hg["deg"])})
        meta = {
            "dim": self._dim,
            "rows": self._rows,
            "metric": self._metric,
            "shards": shards_meta,
            "index_type": self.Type(),
        }
        binset.Append(self.Type(), write_sections(arrays, meta=meta))
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        from ..parallel.sharding import ShardedGraphIndex

        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        self._dim = int(meta["dim"])
        self._rows = int(meta["rows"])
        self._metric = meta["metric"]
        eng = ShardedGraphIndex(devices=self._devs(), metric=self._engine_metric())
        eng._rows = self._rows
        eng._xb = np.array(arrays["xb"])
        eng._host_graphs = [
            {"graph": np.array(arrays[f"graph_{i}"]), "entry": np.array(arrays[f"entry_{i}"]),
             "row0": sm["row0"], "rows": sm["rows"], "deg": sm["deg"]}
            for i, sm in enumerate(meta["shards"])
        ]
        eng._distribute()
        self._engine = eng
        return Status.success

    def Size(self) -> int:
        eng = self._engine
        if eng is None:
            return 0
        return eng._xb.nbytes + sum(hg["graph"].nbytes for hg in eng._host_graphs)

    @staticmethod
    def CreateConfig() -> Config:
        from .hnsw import HnswConfig

        return HnswConfig()


_SHARDED_FEAT = feature.FLOAT32 | feature.KNN
register_index(IndexEnum.INDEX_SHARDED_FLAT, ("fp32",), _SHARDED_FEAT | feature.NO_TRAIN)(ShardedFlatIndexNode)
register_index(IndexEnum.INDEX_SHARDED_IVFFLAT, ("fp32",), _SHARDED_FEAT)(ShardedIVFIndexNode)
register_index(IndexEnum.INDEX_SHARDED_IVFSQ8, ("fp32",), _SHARDED_FEAT)(ShardedIVFIndexNode)
register_index(IndexEnum.INDEX_SHARDED_IVFPQ, ("fp32",), _SHARDED_FEAT)(ShardedIVFIndexNode)
register_index(IndexEnum.INDEX_SHARDED_HNSW, ("fp32",), _SHARDED_FEAT)(ShardedHNSWIndexNode)
