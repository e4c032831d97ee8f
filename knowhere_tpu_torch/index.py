"""Index — the public facade.

Parity with the reference `Index<IndexNode>` handle
(reference: include/knowhere/index/index.h:142-217; src/index/index.cc:30-407):
per-call JSON is parsed into the node's typed config for the right stage
(LoadConfig, index.cc:30-39), the bitset size is sanity-checked against
Count() (index.cc:146-151), latencies are observed (index.cc:91-95,179-185)
as the duration of each Search, RangeSearch or load's root span
(utils/tracing.request, index.cc:163-177), and every method is
exception-safe, returning Status/expected (GuardedCall).

Async build parity: `BuildAsync` returns an `Interrupt` holding a future
(reference index.cc:41-81, interrupt.h) backed by a Python thread — index
builds are dominated by device compute, which releases the GIL.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Dict, Optional

from .binaryset import BinarySet
from .bitset import BitsetView
from .config import Config, Stage, load_config
from .dataset import DataSet
from .index_node import IndexNode
from .status import Status, expected, guarded_call, guarded_expected
from .utils import metrics as _metrics
from .utils import tracing as _tracing
from .utils.logging import log_info


class Interrupt:
    """Async-build handle (reference include/knowhere/index/interrupt.h)."""

    def __init__(self, future: concurrent.futures.Future):
        self._future = future
        self._stop_evt = threading.Event()

    def Get(self, timeout: Optional[float] = None) -> Status:
        try:
            return self._future.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            return Status.timeout
        except Exception:  # pylint: disable=broad-except
            return Status.internal_error

    def Stop(self) -> None:
        self._stop_evt.set()
        self._future.cancel()

    def IsStopped(self) -> bool:
        return self._stop_evt.is_set()


_build_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2, thread_name_prefix="kw-build")


class Index:
    """Ref-counted index handle (the Python object is the refcount)."""

    def __init__(self, node: IndexNode):
        self._node = node
        self._emb = None  # EmbListIndex adapter when metric is MAX_SIM_*/DTW_*

    @property
    def node(self) -> IndexNode:
        return self._node

    def _make_underlying(self):
        clone = type(self._node)(version=self._node.version, object=self._node.object)
        clone.index_type = self._node.Type()
        clone.data_type = getattr(self._node, "data_type", "fp32")
        return clone

    @staticmethod
    def _maybe_emb_list(json_cfg) -> bool:
        """emb_list dispatch (reference BuildEmbListIfNeed, index_node.h:388-408)."""
        from .models.emb_list import is_emb_list_metric

        return is_emb_list_metric(str((json_cfg or {}).get("metric_type", "")))

    # --- config plumbing ---------------------------------------------------
    def _load_cfg(self, json_cfg: Optional[Dict[str, Any]], stage: Stage):
        cfg = self._node.CreateConfig()
        st, msg = Config.load(cfg, json_cfg or {}, stage)
        return cfg, st, msg

    # --- build -------------------------------------------------------------
    def Build(self, dataset: DataSet, json_cfg: Optional[Dict[str, Any]] = None) -> Status:
        def impl() -> Status:
            cfg, st, msg = self._load_cfg(json_cfg, Stage.TRAIN)
            if st != Status.success:
                log_info(f"Build config load failed: {msg}")
                return st
            t0 = time.perf_counter()
            if self._maybe_emb_list(json_cfg):
                from .feature import KnowhereCheck
                from .models.emb_list import EmbListIndex

                if not KnowhereCheck.SupportEmbListIndexTypeCheck(self._node.Type()):
                    return Status.invalid_metric_type
                self._emb = EmbListIndex(self._make_underlying, self._node.Type())
                st = self._emb.Build(dataset, cfg)
            else:
                st = self._node.Build(dataset, cfg)
            if st == Status.success:
                _metrics.observe_build_latency(self._node.Type(), time.perf_counter() - t0)
            return st

        return guarded_call(impl)

    def BuildAsync(self, dataset: DataSet, json_cfg: Optional[Dict[str, Any]] = None) -> Interrupt:
        fut = _build_pool.submit(self.Build, dataset, json_cfg)
        return Interrupt(fut)

    def Train(self, dataset: DataSet, json_cfg: Optional[Dict[str, Any]] = None) -> Status:
        def impl() -> Status:
            cfg, st, msg = self._load_cfg(json_cfg, Stage.TRAIN)
            if st != Status.success:
                return st
            return self._node.Train(dataset, cfg)

        return guarded_call(impl)

    def Add(self, dataset: DataSet, json_cfg: Optional[Dict[str, Any]] = None) -> Status:
        def impl() -> Status:
            cfg, st, msg = self._load_cfg(json_cfg, Stage.TRAIN)
            if st != Status.success:
                return st
            return self._node.Add(dataset, cfg)

        return guarded_call(impl)

    # --- search ---------------------------------------------------------------
    def _check_bitset(self, bitset: Optional[BitsetView]) -> Optional[Status]:
        """Bitset size sanity check (reference index.cc:146-151)."""
        if bitset is not None and not bitset.empty_view():
            cnt = self._emb.Count() if self._emb is not None else self._node.Count()
            if cnt > 0 and bitset.size() != cnt:
                return Status.invalid_args
        return None

    def Search(
        self,
        dataset: DataSet,
        json_cfg: Optional[Dict[str, Any]] = None,
        bitset: Optional[BitsetView] = None,
        op_context=None,
    ) -> "expected[DataSet]":
        def impl() -> "expected[DataSet]":
            with _tracing.request("knowhere_search", nq=dataset.rows, index=self._node.Type()) as root:
                res, cfg = self._search_call(root, Stage.SEARCH, dataset, json_cfg, bitset, op_context)
                seconds = root.stop()
                if res.has_value():
                    _metrics.observe_search_latency(self._node.Type(), seconds)
                    _metrics.observe_topk(cfg.get("k", 0))
            return res

        return guarded_expected(impl)

    def RangeSearch(
        self,
        dataset: DataSet,
        json_cfg: Optional[Dict[str, Any]] = None,
        bitset: Optional[BitsetView] = None,
        op_context=None,
    ) -> "expected[DataSet]":
        def impl() -> "expected[DataSet]":
            with _tracing.request("knowhere_range_search", nq=dataset.rows, index=self._node.Type()) as root:
                res, _ = self._search_call(root, Stage.RANGE_SEARCH, dataset, json_cfg, bitset, op_context)
                seconds = root.stop()
                if res.has_value():
                    _metrics.observe_range_search_latency(self._node.Type(), seconds)
            return res

        return guarded_expected(impl)

    def _search_call(self, root, stage: Stage, dataset: DataSet, json_cfg, bitset, op_context):
        """(result, config) of Search or RangeSearch under its root span:
        the config load and the bitset check (``search.config``), then the
        node's search in the op's cancellation scope."""
        from .comp import check_cancellation, op_context_scope

        with _tracing.span("search.config"):
            check_cancellation(op_context)
            cfg, st, msg = self._load_cfg(json_cfg, stage)
            if st != Status.success:
                return expected.Err(st, msg), cfg
            bs_err = self._check_bitset(bitset)
            if bs_err is not None:
                return expected.Err(bs_err, "bitset size mismatches index count"), cfg
            bs = bitset or BitsetView.empty()
        root.set(cfg, metric=cfg.get("metric_type"), k=cfg.get("k"), radius=cfg.get("radius"))
        # the scope arms mid-search checks at chunk boundaries (reference
        # checks inside per-query tasks, ivf.cc:962)
        with op_context_scope(op_context):
            if stage == Stage.RANGE_SEARCH:
                return self._node.RangeSearch(dataset, cfg, bs), cfg
            if self._emb is not None:
                return self._emb.Search(dataset, cfg, bs), cfg
            return self._node.Search(dataset, cfg, bs), cfg

    def AnnIterator(
        self,
        dataset: DataSet,
        json_cfg: Optional[Dict[str, Any]] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[list]":
        def impl():
            cfg, st, msg = self._load_cfg(json_cfg, Stage.ITERATOR)
            if st != Status.success:
                return expected.Err(st, msg)
            bs_err = self._check_bitset(bitset)
            if bs_err is not None:
                return expected.Err(bs_err, "bitset size mismatches index count")
            bs = bitset or BitsetView.empty()
            return self._node.AnnIterator(dataset, cfg, bs)

        return guarded_expected(impl)

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        return guarded_expected(lambda: self._node.GetVectorByIds(dataset))

    def GetEmbListByIds(self, dataset: DataSet, metric_type: str = "L2") -> "expected[DataSet]":
        """Per-document vector lists by emb_list ids (reference
        index.h:176-178 / index_node.h:540; error on non-emb_list indexes)."""

        def impl():
            target = self._emb if self._emb is not None else self._node
            fn = getattr(target, "GetEmbListByIds", None)
            if fn is None:
                return expected.Err(
                    Status.not_implemented, "not an emb_list index"
                )
            return fn(dataset, metric_type)

        return guarded_expected(impl)

    def CalcDistByIDs(
        self, query_ds: DataSet, bitset: Optional[BitsetView], ids, rows: int
    ) -> "expected":
        """Exact query-to-stored-row distances for explicit ids (reference
        index.h CalcDistByIDs — emb_list rerank entry point)."""
        bs = bitset or BitsetView.empty()
        import numpy as _np

        return guarded_expected(
            lambda: self._node.CalcDistByIDs(query_ds, bs, _np.asarray(ids), rows)
        )

    def HasRawData(self, metric_type: str = "L2") -> bool:
        return self._node.HasRawData(metric_type)

    def IsAdditionalScalarSupported(self, is_mv_only: bool = False) -> bool:
        """Whether the index consumes materialized-view filter hints
        (reference index.h:187 / index_node.h:240)."""
        fn = getattr(self._node, "IsAdditionalScalarSupported", None)
        return bool(fn(is_mv_only)) if fn is not None else False

    def IsIndexRefineEnabled(self) -> bool:
        """Whether a refine (reorder) stage is configured (reference
        index.h:190 / index_node.h:245)."""
        return bool(self._node.IsIndexRefineEnabled())

    def GetIndexMeta(self, json_cfg: Optional[Dict[str, Any]] = None) -> "expected[DataSet]":
        def impl():
            cfg, st, msg = self._load_cfg(json_cfg, Stage.FEDER)
            if st != Status.success:
                return expected.Err(st, msg)
            return self._node.GetIndexMeta(cfg)

        return guarded_expected(impl)

    # --- serialization --------------------------------------------------------
    def Serialize(self, binset: BinarySet) -> Status:
        if self._emb is not None:
            return guarded_call(lambda: self._emb.Serialize(binset))
        return guarded_call(lambda: self._node.Serialize(binset))

    def Deserialize(
        self, binset: BinarySet, json_cfg: Optional[Dict[str, Any]] = None
    ) -> Status:
        def impl() -> Status:
            with _tracing.request("knowhere_deserialize", index=self._node.Type()) as root:
                cfg, st, msg = self._load_cfg(json_cfg, Stage.DESERIALIZE)
                if st != Status.success:
                    return st
                if binset.Contains("EMB_LIST_META"):
                    from .models.emb_list import EmbListIndex

                    self._emb = EmbListIndex(self._make_underlying, self._node.Type())
                    st = self._emb.Deserialize(binset, cfg)
                else:
                    st = self._node.Deserialize(binset, cfg)
                seconds = root.stop()
                if st == Status.success:
                    _metrics.observe_load_latency(self._node.Type(), seconds)
            return st

        return guarded_call(impl)

    def DeserializeFromFile(
        self, filename: str, json_cfg: Optional[Dict[str, Any]] = None
    ) -> Status:
        def impl() -> Status:
            with _tracing.request("knowhere_deserialize_from_file", index=self._node.Type()) as root:
                cfg, st, msg = self._load_cfg(json_cfg, Stage.DESERIALIZE_FROM_FILE)
                if st != Status.success:
                    return st
                st = self._node.DeserializeFromFile(filename, cfg)
                seconds = root.stop()
                if st == Status.success:
                    _metrics.observe_load_latency(self._node.Type(), seconds)
            return st

        return guarded_call(impl)

    # --- introspection -----------------------------------------------------------
    def Dim(self) -> int:
        return self._node.Dim()

    def Size(self) -> int:
        return self._node.Size()

    def Count(self) -> int:
        if self._emb is not None:
            return self._emb.Count()
        return self._node.Count()

    def Type(self) -> str:
        return self._node.Type()

    # snake_case aliases for pythonic callers
    build = Build
    train = Train
    add = Add
    search = Search
    range_search = RangeSearch
    ann_iterator = AnnIterator
    get_vector_by_ids = GetVectorByIds
    has_raw_data = HasRawData
    serialize = Serialize
    deserialize = Deserialize
    deserialize_from_file = DeserializeFromFile
