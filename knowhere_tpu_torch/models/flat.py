"""FLAT and BIN_FLAT — exact scan index (counterpart of
knowhere_tpu/models/flat.py).

FLAT takes fp32, fp16, bf16 and int8 rows, and BIN_FLAT (BINFLAT) bin1 rows
packed eight bits a byte, LSB first. The stored base lives on the device
once, at its own width (a bf16 corpus as torch.bfloat16, held on the host as
its uint16 bit patterns, utils/bf16.py); a binary base is unpacked to {0,1}
int8 planes there, and binary queries are unpacked the same way. Unfiltered
L2/IP/COSINE searches over nb >= 16384 rows with k <= 1024 take the
two-phase exact scan (ops/cuda_flat.py, CUDA group-scan kernel) on any
device; filtered, small and binary searches take the streaming tiled scan
(ops/topk.py), as in the reference. RangeSearch runs the tiled range scan
(ops/range.py); AnnIterator and CalcDistByIDs score full f32 distances on
the device (AnnIterator keeps one nb-float row a query on the host, so
callers keep nq small). GetVectorByIds returns the stored rows: packed bits
for BIN_FLAT. TPU_BRUTE_FORCE, GPU_CUVS_BRUTE_FORCE, GPU_BRUTE_FORCE and
GPU_FAISS_FLAT name the same index.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config
from ..dataset import DataSet, GenRangeResultDataSet, GenResultDataSet, GenTensorDataSet
from ..device import to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import BINARY_METRICS, IndexEnum, normalize_metric
from ..index_node import IndexNode, PrecomputedDistanceIterator
from ..io.serialize import read_sections, write_sections
from ..ops import distances as D
from ..ops import range as R
from ..ops import topk as T
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import as_f32, bf16_bits, rows_to_device
from ..utils.spill import release_spill, spill_array

# the two-phase scan serves corpora at least this large (as the reference)
TWO_PHASE_MIN_ROWS = 16384
TWO_PHASE_MAX_K = 1024


class FlatConfig(BaseConfig):
    """reference src/index/flat/flat_config.h:19 — BaseConfig only."""


class FlatIndexNode(IndexNode):
    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_FAISS_IDMAP
        self.data_type = "fp32"
        self._xb: Optional[np.ndarray] = None  # stored rows (host; packed bits for bin1)
        self._dim = 0
        self._metric = "L2"
        self._dev = None  # device copy of the rows
        self._scan_stores = {}  # metric -> cuda_flat.FlatScanStore

    def _is_binary(self) -> bool:
        return self.data_type == "bin1"

    def _ensure_device(self):
        if self._dev is None:
            if self._xb is None:
                raise KnowhereException("index is empty", Status.empty_index)
            if self._is_binary():
                self._dev = to_device(D.unpack_bits_host(self._xb, self._dim))
            else:
                self._dev = rows_to_device(bf16_bits(self._xb) if self.data_type == "bf16" else self._xb)
            # the device copy is the search structure; the host copy (read by
            # Serialize, GetVectorByIds and Add) becomes a disk-backed memmap
            self._xb = spill_array(self._xb)
        return self._dev

    def _rows(self, x) -> np.ndarray:
        """Query or stored rows as the scans take them: {0,1} planes for
        bin1, f32 otherwise (bf16 bit patterns widened)."""
        x = np.asarray(x)
        if self._is_binary():
            return D.unpack_bits_host(x.view(np.uint8), self._dim)
        return as_f32(x)

    def _check_metric(self, metric: str) -> None:
        if (metric in BINARY_METRICS) != self._is_binary():
            raise KnowhereException(
                f"metric {metric} incompatible with data type {self.data_type}",
                Status.invalid_metric_type,
            )

    # --- lifecycle -----------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        self._check_metric(self._metric)
        return Status.success

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        xb = np.asarray(dataset.tensor)
        self._dim = dataset.dim
        old = self._xb
        self._xb = xb if old is None else np.concatenate([old, xb], axis=0)
        if old is not None:
            release_spill(old)
        self._dev = None
        self._scan_stores = {}
        return Status.success

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Install the state a FLAT node serializes: arrays {"xb"}, meta
        {dim, metric, data_type}."""
        if self._xb is not None:
            release_spill(self._xb)
        self._xb = np.asarray(arrays["xb"])
        self._dim = int(meta["dim"])
        self._metric = meta["metric"]
        self.data_type = meta.get("data_type", self.data_type)
        self._dev = None
        self._scan_stores = {}

    # --- queries -----------------------------------------------------------
    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        metric = normalize_metric(cfg.metric_type)
        self._check_metric(metric)
        dev = self._ensure_device()
        xq = self._rows(dataset.tensor)
        if (
            bitset.empty_view()
            and metric in ("L2", "IP", "COSINE")
            and self.Count() >= TWO_PHASE_MIN_ROWS
            and cfg.k <= TWO_PHASE_MAX_K
        ):
            dists, ids = self._two_phase_search(xq, cfg.k, metric)
            return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))
        mask = bitset.device_mask(self.Count()) if not bitset.empty_view() else None
        ids, dists = T.knn_search(
            xq, dev, cfg.k, metric, bitset_mask=mask, aux=D.base_aux(metric, dev)
        )
        return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))

    def _two_phase_search(self, xq: np.ndarray, k: int, metric: str):
        """Two-phase exact scan; COSINE runs as IP over normalized copies."""
        from ..ops.cuda_flat import FlatScanStore, flat_topk

        store = self._scan_stores.get(metric)
        if store is None:
            dev = self._ensure_device().float()
            if metric == "COSINE":
                nrm = dev.norm(dim=1, keepdim=True)
                store = FlatScanStore(dev / nrm.clamp(min=1e-12), None, False)
            else:
                store = FlatScanStore(dev, None, metric == "L2")
            self._scan_stores[metric] = store
        if metric == "COSINE":
            qn = np.linalg.norm(xq, axis=1, keepdims=True)
            xq = xq / np.maximum(qn, 1e-12)
        return flat_topk(xq, store, k)

    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        metric = normalize_metric(cfg.metric_type)
        self._check_metric(metric)
        dev = self._ensure_device()
        mask = bitset.device_mask(self.Count()) if not bitset.empty_view() else None
        return expected.Ok(range_result(self._rows(dataset.tensor), dev, cfg, metric, mask))

    def AnnIterator(
        self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True
    ) -> "expected[List]":
        metric = normalize_metric(cfg.metric_type)
        self._check_metric(metric)
        dev = self._ensure_device()
        keep = bitset.host_mask(self.Count()) if not bitset.empty_view() else None
        return expected.Ok(precomputed_iterators(self._rows(dataset.tensor), dev, metric, keep))

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        if self._xb is None:
            return expected.Err(Status.empty_index, "index not built")
        ids = np.asarray(dataset.ids, dtype=np.int64)
        if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self.Count():
            return expected.Err(Status.invalid_args, "id out of range")
        return expected.Ok(GenTensorDataSet(self._xb[ids], len(ids), self._dim))

    def CalcDistByIDs(self, query_ds, bitset, ids, rows) -> "expected[np.ndarray]":
        """Exact distances of every query to the stored rows ``ids`` under
        the build metric: (nq, len(ids)) f32."""
        if self._xb is None:
            return expected.Err(Status.empty_index, "index not built")
        sub = to_device(self._rows(self._xb[np.asarray(ids, dtype=np.int64)]))
        q = to_device(self._rows(query_ds.tensor))
        dmat = D.pairwise_distance(self._metric, q, sub, D.base_aux(self._metric, sub))
        return expected.Ok(dmat.cpu().numpy())

    @staticmethod
    def HasRawData(metric_type: str) -> bool:
        return True

    # --- serialization ---------------------------------------------------------
    def Serialize(self, binset: BinarySet) -> Status:
        if self._xb is None:
            return Status.empty_index
        blob = write_sections(
            {"xb": self._xb},
            meta={
                "dim": self._dim,
                "metric": self._metric,
                "data_type": self.data_type,
                "index_type": self.Type(),
            },
            bf16=("xb",) if self._xb.dtype == np.uint16 else (),
        )
        binset.Append(self.Type(), blob)
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        self.load_state(arrays, meta)
        return Status.success

    # --- introspection -----------------------------------------------------------
    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        return 0 if self._xb is None else self._xb.nbytes

    def Count(self) -> int:
        return 0 if self._xb is None else self._xb.shape[0]

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return FlatConfig()


def range_result(xq: np.ndarray, base, cfg: Config, metric: str, mask) -> DataSet:
    """RangeSearch over a device ``base`` (FLAT's and BruteForce's): the
    window (ops/range.range_search, ``mask`` the device keep-mask or None),
    then range_search_k, as a CSR dataset."""
    ids, dists, lims = R.range_search(
        xq, base, cfg.radius, cfg.range_filter, metric, bitset_mask=mask, aux=D.base_aux(metric, base)
    )
    ids, dists, lims = R.apply_range_search_k(
        ids, dists, lims, cfg.get("range_search_k", -1), D.larger_is_better(metric)
    )
    return GenRangeResultDataSet(xq.shape[0], ids, dists, lims)


def precomputed_iterators(xq: np.ndarray, base, metric: str, keep: Optional[np.ndarray], chunk: int = 256) -> list:
    """One PrecomputedDistanceIterator a query over its full distance row to
    ``base`` (a device tensor), computed on the device ``chunk`` queries at a
    time; ``keep`` is the host keep-mask or None."""
    larger = D.larger_is_better(metric)
    aux = D.base_aux(metric, base)
    iterators = []
    for s in range(0, xq.shape[0], chunk):
        dmat = D.pairwise_distance(metric, to_device(xq[s : s + chunk]), base, aux).cpu().numpy()
        iterators.extend(PrecomputedDistanceIterator(row, keep, larger) for row in dmat)
    return iterators


_DENSE_TYPES = ("fp32", "fp16", "bf16", "int8")
_BINARY = feature.BINARY | feature.MMAP | feature.KNN | feature.NO_TRAIN
_GPU = feature.ALL_DENSE_TYPE | feature.KNN | feature.NO_TRAIN | feature.GPU

register_index(
    IndexEnum.INDEX_FAISS_IDMAP,
    _DENSE_TYPES,
    feature.ALL_DENSE_TYPE | feature.MMAP | feature.KNN | feature.NO_TRAIN | feature.EMB_LIST,
)(FlatIndexNode)
# BINFLAT: the legacy name the reference registers beside BIN_FLAT (flat.cc:418)
for _name in (IndexEnum.INDEX_FAISS_BIN_IDMAP, "BINFLAT"):
    register_index(_name, ("bin1",), _BINARY)(FlatIndexNode)
# the brute-force names (TPU_BRUTE_FORCE is the reference's counterpart of
# GPU_CUVS_BRUTE_FORCE) and the legacy faiss-GPU name
for _name in (
    IndexEnum.INDEX_TPU_BRUTEFORCE, IndexEnum.INDEX_CUVS_BRUTEFORCE, IndexEnum.INDEX_GPU_BRUTEFORCE,
    IndexEnum.INDEX_FAISS_GPU_IDMAP,
):
    register_index(_name, _DENSE_TYPES, _GPU)(FlatIndexNode)
