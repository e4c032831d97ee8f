"""IndexNode — the abstract index implementation interface + iterator framework.

Equivalent of the reference L4 layer
(reference: include/knowhere/index/index_node.h:88-326 for the abstract
interface and default Build=Train+Add / RangeSearch-via-iterator;
index_node.h:672-937 for the IndexIterator / PrecomputedDistanceIterator
framework). emb_list glue (index_node.h:388-523) lives in models/emb_list.py
and is dispatched from the facade.

Conventions:
- All inputs/outputs are `DataSet`; configs are typed `Config` objects already
  loaded for the right stage by the facade.
- Status-returning methods raise KnowhereException only internally; the facade
  converts to Status via guarded_call.
"""

from __future__ import annotations

import heapq
from abc import ABC, abstractmethod
from typing import Any, Iterator, List, Optional, Tuple, Type

import numpy as np

from .binaryset import BinarySet
from .bitset import BitsetView
from .config import BaseConfig, Config, Stage
from .dataset import DataSet, GenRangeResultDataSet
from .index_param import is_similarity_metric
from .status import KnowhereException, Status, expected


class IndexNode(ABC):
    """Abstract index node (reference index_node.h:118-326)."""

    def __init__(self, version: int, object: Any = None):  # noqa: A002
        self.version = version
        self.object = object

    # --- lifecycle -----------------------------------------------------
    def Build(self, dataset: DataSet, cfg: Config) -> Status:
        """Default Build = Train + Add (reference index_node.h:88-92)."""
        st = self.Train(dataset, cfg)
        if st != Status.success:
            return st
        return self.Add(dataset, cfg)

    @abstractmethod
    def Train(self, dataset: DataSet, cfg: Config) -> Status: ...

    @abstractmethod
    def Add(self, dataset: DataSet, cfg: Config) -> Status: ...

    # --- queries ---------------------------------------------------------
    @abstractmethod
    def Search(
        self, dataset: DataSet, cfg: Config, bitset: BitsetView
    ) -> "expected[DataSet]": ...

    def RangeSearch(
        self, dataset: DataSet, cfg: Config, bitset: BitsetView
    ) -> "expected[DataSet]":
        """Default range search via AnnIterator (reference index_node.h:200-213):
        stream candidates best-first until the radius falls out of range."""
        it_exp = self.AnnIterator(dataset, cfg, bitset, use_knowhere_search_pool=False)
        if not it_exp.has_value():
            return expected.Err(it_exp.error(), it_exp.what())
        iterators = it_exp.value()
        radius = cfg.get("radius", 0.0)
        range_filter = cfg.get("range_filter", float("inf"))
        two_sided = np.isfinite(range_filter)
        range_search_k = cfg.get("range_search_k", -1)
        is_ip = is_similarity_metric(cfg.get("metric_type", "L2"))
        range_search_level = cfg.get("range_search_level", 0.01)

        nq = len(iterators)
        all_ids: List[np.ndarray] = []
        all_dists: List[np.ndarray] = []
        lims = np.zeros(nq + 1, dtype=np.int64)
        for qi, it in enumerate(iterators):
            ids_i: List[int] = []
            dists_i: List[float] = []
            # Expanding consumption: keep pulling while the frontier distance
            # remains in range; tolerate a margin of out-of-range results
            # proportional to range_search_level before stopping (mirrors the
            # reference's tolerance heuristic for non-monotonic iterators).
            out_of_range_budget = max(64, int(range_search_level * 8192))
            misses = 0
            while it.HasNext():
                i, d = it.Next()
                if is_ip:
                    in_range = d > radius and (not two_sided or d <= range_filter)
                else:
                    in_range = d < radius and (not two_sided or d >= range_filter)
                if in_range:
                    ids_i.append(i)
                    dists_i.append(d)
                    misses = 0
                else:
                    misses += 1
                    if misses > out_of_range_budget:
                        break
                if range_search_k >= 0 and len(ids_i) >= range_search_k:
                    break
            all_ids.append(np.asarray(ids_i, dtype=np.int64))
            all_dists.append(np.asarray(dists_i, dtype=np.float32))
            lims[qi + 1] = lims[qi] + len(ids_i)
        ids = np.concatenate(all_ids) if all_ids else np.empty(0, np.int64)
        dists = np.concatenate(all_dists) if all_dists else np.empty(0, np.float32)
        return expected.Ok(GenRangeResultDataSet(nq, ids, dists, lims))

    def AnnIterator(
        self,
        dataset: DataSet,
        cfg: Config,
        bitset: BitsetView,
        use_knowhere_search_pool: bool = True,
    ) -> "expected[List[IndexIterator]]":
        return expected.Err(
            Status.not_implemented, f"AnnIterator not supported for {self.Type()}"
        )

    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        return expected.Err(Status.not_implemented, "GetVectorByIds not supported")

    def CalcDistByIDs(
        self, query_ds: DataSet, bitset: BitsetView, ids: np.ndarray, rows: int
    ) -> "expected[np.ndarray]":
        """Exact distances between all query rows and the given stored ids —
        used by emb_list rerank (reference index_node.h:167-172)."""
        return expected.Err(Status.not_implemented, "CalcDistByIDs not supported")

    @staticmethod
    def HasRawData(metric_type: str) -> bool:
        return False

    def IsAdditionalScalarSupported(self, is_mv_only: bool = False) -> bool:
        """Whether the node consumes materialized-view filter hints
        (reference index_node.h:240; default false)."""
        return False

    def IsIndexRefineEnabled(self) -> bool:
        """Whether a refine (reorder) stage is configured
        (reference index_node.h:245)."""
        return getattr(self, "_refine_store", None) is not None

    def GetIndexMeta(self, cfg: Config) -> "expected[DataSet]":
        return expected.Err(Status.not_implemented, "GetIndexMeta not supported")

    # --- serialization -----------------------------------------------------
    @abstractmethod
    def Serialize(self, binset: BinarySet) -> Status: ...

    @abstractmethod
    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status: ...

    def DeserializeFromFile(self, filename: str, cfg: Config) -> Status:
        """Default: mmap the file as one blob named after the index type
        (mmap-equivalent of reference DeserializeFromFile, ivf.cc:1844-1903)."""
        try:
            data = np.memmap(filename, dtype=np.uint8, mode="r")
        except OSError as e:
            raise KnowhereException(str(e), Status.disk_file_error) from e
        binset = BinarySet()
        binset.Append(self.Type(), memoryview(data))
        return self.Deserialize(binset, cfg)

    # --- introspection ------------------------------------------------------
    @staticmethod
    @abstractmethod
    def CreateConfig() -> Config: ...

    @abstractmethod
    def Dim(self) -> int: ...

    def Size(self) -> int:
        return 0

    def MemoryStats(self) -> dict:
        """Resident memory accounting (BASELINE.md 'equal recall at equal
        memory' north star): walks the node's object graph and classifies
        every array as host RAM, host mmap (disk-backed, ~0 resident), or
        device memory (CUDA tensors). Arrays shared between attributes count once.

        Returns {"host_bytes", "mmap_bytes", "device_bytes",
                 "bytes_per_vector", "host", "mmap", "device"} where the last
        three map attribute paths to byte counts.
        """
        import numpy as _np

        import torch as _torch

        host: dict = {}
        mm: dict = {}
        dev: dict = {}
        seen = set()

        def visit(path: str, obj, depth: int) -> None:
            if obj is None or depth > 5 or id(obj) in seen:
                return
            seen.add(id(obj))
            if isinstance(obj, _np.memmap):
                mm[path] = int(obj.nbytes)
            elif isinstance(obj, _np.ndarray):
                base = obj.base
                if isinstance(base, _np.memmap):
                    mm[path] = int(obj.nbytes)
                else:
                    host[path] = int(obj.nbytes)
            elif isinstance(obj, _torch.Tensor):
                nbytes = int(obj.numel() * obj.element_size())
                if obj.is_cuda:
                    dev[path] = nbytes
                else:
                    host[path] = nbytes
            elif isinstance(obj, dict):
                for k, v in obj.items():
                    visit(f"{path}.{k}", v, depth + 1)
            elif isinstance(obj, (list, tuple)):
                for i, v in enumerate(obj):
                    visit(f"{path}[{i}]", v, depth + 1)
            elif (
                depth < 4
                and hasattr(obj, "__dict__")
                and obj.__class__.__module__.startswith("knowhere_tpu_torch")
            ):
                for k, v in vars(obj).items():
                    visit(f"{path}.{k}", v, depth + 1)

        for k, v in vars(self).items():
            visit(k, v, 1)
        n = max(1, self.Count())
        hb, mb, db = sum(host.values()), sum(mm.values()), sum(dev.values())
        return {
            "host_bytes": hb,
            "mmap_bytes": mb,
            "device_bytes": db,
            "bytes_per_vector": round((hb + db) / n, 2),
            "host": host,
            "mmap": mm,
            "device": dev,
        }

    @abstractmethod
    def Count(self) -> int: ...

    @abstractmethod
    def Type(self) -> str: ...


# ---------------------------------------------------------------------------
# Iterator framework (reference index_node.h:672-937)
# ---------------------------------------------------------------------------


class IndexIterator:
    """Buffered best-first iterator.

    Subclasses implement `next_batch()` -> (ids int64[], dists f32[]) in the
    index's native approximate order; this base maintains a refine-capable
    min-heap exactly like the reference IndexIterator (index_node.h:672-808):
    if `refine_fn` is given, raw distances re-score candidates before they are
    surfaced, with `refine_ratio` controlling the lookahead buffer.
    """

    def __init__(
        self,
        larger_is_closer: bool,
        refine_fn=None,
        refine_ratio: float = 0.0,
        retain_order: bool = False,
    ):
        self.larger_is_closer = larger_is_closer
        self.refine_fn = refine_fn
        self.refine_ratio = refine_ratio
        self.retain_order = retain_order
        self._heap: List[Tuple[float, int]] = []  # (sort_key, id)
        self._exhausted = False
        self._returned = 0

    def _sort_key(self, dist: float) -> float:
        return -dist if self.larger_is_closer else dist

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Produce the next chunk of (ids, dists); empty arrays when done."""
        raise NotImplementedError

    def _refill(self, min_size: int = 1) -> None:
        while not self._exhausted and len(self._heap) < min_size:
            ids, dists = self.next_batch()
            if len(ids) == 0:
                self._exhausted = True
                break
            if self.refine_fn is not None:
                dists = self.refine_fn(ids, dists)
            for i, d in zip(ids.tolist(), dists.tolist()):
                heapq.heappush(self._heap, (self._sort_key(d), int(i)))

    def HasNext(self) -> bool:
        self._refill()
        return len(self._heap) > 0

    def Next(self) -> Tuple[int, float]:
        # Keep a lookahead buffer when refining so surfaced order is closer to
        # exact (reference refine_ratio semantics).
        lookahead = 1
        if self.refine_fn is not None and self.refine_ratio > 0:
            lookahead = max(1, int(1.0 / max(self.refine_ratio, 1e-6)))
        self._refill(lookahead)
        if not self._heap:
            raise KnowhereException("iterator exhausted", Status.empty_index)
        key, idx = heapq.heappop(self._heap)
        dist = -key if self.larger_is_closer else key
        self._returned += 1
        return idx, float(dist)


class PrecomputedDistanceIterator(IndexIterator):
    """Iterator over fully precomputed per-query distances with lazy batched
    partial sort (reference index_node.h:815-937; sort chunks >=50k rows).

    Construction is O(n_valid); sorting happens lazily, one argpartition'd
    chunk at a time, so shallow consumption of a 10M-row result never pays
    a full argsort.
    """

    SORT_CHUNK = 50_000

    def __init__(self, dists: np.ndarray, valid_mask: Optional[np.ndarray], larger_is_closer: bool):
        super().__init__(larger_is_closer)
        self._dists = np.asarray(dists, dtype=np.float32).reshape(-1)
        n = self._dists.size
        if valid_mask is not None:
            self._valid_ids = np.nonzero(valid_mask)[0]
        else:
            self._valid_ids = np.arange(n)
        # lazy state: `_sorted` = fully-ordered prefix (positions into
        # _valid_ids); `_rest` = still-unsorted positions (None until first
        # use so callers may still swap _valid_ids right after construction)
        self._sorted = np.empty(0, np.int64)
        self._rest: Optional[np.ndarray] = None
        self._pos = 0

    def _keys_at(self, positions: np.ndarray) -> np.ndarray:
        vals = self._dists[self._valid_ids[positions]]
        return -vals if self.larger_is_closer else vals

    def _sort_more(self) -> bool:
        """Partial-sort the next SORT_CHUNK candidates; False when none left."""
        if self._rest is None:
            self._rest = np.arange(self._valid_ids.size, dtype=np.int64)
        if self._rest.size == 0:
            return False
        chunk = min(self.SORT_CHUNK, self._rest.size)
        keys = self._keys_at(self._rest)
        if chunk < self._rest.size:
            part = np.argpartition(keys, chunk - 1)
            head, keys_head = self._rest[part[:chunk]], keys[part[:chunk]]
            self._rest = self._rest[part[chunk:]]
        else:
            head, keys_head = self._rest, keys
            self._rest = np.empty(0, np.int64)
        self._sorted = np.concatenate([self._sorted, head[np.argsort(keys_head, kind="stable")]])
        return True

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        while self._pos >= self._sorted.size:
            if not self._sort_more():
                return np.empty(0, np.int64), np.empty(0, np.float32)
        end = min(self._pos + 1024, self._sorted.size)
        sel = self._sorted[self._pos : end]
        self._pos = end
        ids = self._valid_ids[sel].astype(np.int64)
        return ids, self._dists[ids]


class ExpandingIteratorGroup:
    """Batched resume-state shared by the per-query iterators of one
    AnnIterator call.

    The reference iterator RESUMES its underlying walk/scan indefinitely
    (index_node.h:672-808; faiss_hnsw.cc:843-940 graph-walk resume;
    ivf.cc:1538-1607 workspace iterator) — it never exhausts before the
    whole corpus is surfaced. Searches are batched across the query
    axis, so resumption here is batched too: when any per-query iterator
    drains its buffered candidates, the group re-runs the family's search
    with widened knobs via ``round_fn(r)`` and each iterator keeps only ids
    it has not yet buffered. ``round_fn`` returns ``(ids (nq,k), dists
    (nq,k))`` with -1 padding, or None once coverage is complete (the last
    non-None round must cover every reachable row, e.g. a full exact scan).
    """

    def __init__(self, nq: int, count: int, round_fn):
        self._round_fn = round_fn
        self._round = 0
        self._done = False
        self._nq = nq
        self._count = count
        self._seen: List[Optional[np.ndarray]] = [None] * nq
        self._queues: List[List[Tuple[np.ndarray, np.ndarray]]] = [[] for _ in range(nq)]

    def _expand(self) -> None:
        if self._done:
            return
        out = self._round_fn(self._round)
        self._round += 1
        if out is None:
            self._done = True
            return
        ids, dists = out
        for qi in range(self._nq):
            row_ids = np.asarray(ids[qi])
            valid = row_ids >= 0
            row_ids = row_ids[valid].astype(np.int64)
            row_d = np.asarray(dists[qi])[valid].astype(np.float32)
            seen = self._seen[qi]
            if seen is None:
                seen = self._seen[qi] = np.zeros(self._count, dtype=bool)
            fresh = ~seen[row_ids]
            if fresh.any():
                seen[row_ids[fresh]] = True
                self._queues[qi].append((row_ids[fresh], row_d[fresh]))

    def make_iterator(self, qi: int, larger_is_closer: bool) -> "BatchedDistanceIterator":
        def batch_fn():
            q = self._queues[qi]
            while not q and not self._done:
                self._expand()
            if not q:
                return np.empty(0, np.int64), np.empty(0, np.float32)
            return q.pop(0)

        return BatchedDistanceIterator(batch_fn, larger_is_closer=larger_is_closer)


#: device top-k rounds stop growing past this k; the covering final round
#: switches to a host full-sort (avoids giant on-device top-k buffers)
DEVICE_K_MAX = 65_536


class BatchedDistanceIterator(IndexIterator):
    """Iterator fed by a callable producing successive approximate batches —
    used by IVF/graph indexes to stream expanding candidate sets."""

    def __init__(self, batch_fn, larger_is_closer: bool, refine_fn=None, refine_ratio: float = 0.0):
        super().__init__(larger_is_closer, refine_fn=refine_fn, refine_ratio=refine_ratio)
        self._batch_fn = batch_fn

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._batch_fn()
