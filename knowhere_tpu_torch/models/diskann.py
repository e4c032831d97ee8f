"""DISKANN, DISKANN_DEPRECATED and AISAQ: the disk-resident Vamana index
(counterpart of knowhere_tpu/models/diskann.py).

Build takes ``index_prefix`` and ``data_path``; the data file is DiskANN's
bin format ([npts:int32][dim:int32][row-major rows]) and is streamed off a
memmap, never loaded whole. Build writes ``<prefix>_kwtpu_mem.bin`` (the
graph, the entry rows, the PQ codebooks and codes, and the routing
centroids when the corpus is routed) and ``<prefix>_kwtpu_disk.bin`` (the
rows at their native width, or disk-PQ codes under ``disk_pq_dims``)
through the injected FileManager, and leaves the node unloaded. Serialize
is a no-op; Deserialize(index_prefix) puts the graph, the entries and the
PQ store on the device, maps the disk payload zero-copy and pins a node
cache of raw rows on the device within ``search_cache_budget_gb``.

Search is the batched beam search over the PQ store (ops/graph.beam_search,
kind "pq") followed by an exact rerank of its candidates from the node
cache or the disk payload. Corpora of more than ROUTED_MIN_ROWS rows are
routed: k-means centroids seed each query's walk, and the build's kNN
graph runs through the IVF scan (the f32 scan kernel under FAST). A build
whose rows exceed ``build_dram_budget_gb`` builds one graph per k-means
shard (each row in its two nearest shards) and merges the edge lists.

AISAQ writes one inline record per node, [adjacency][own PQ code]
[neighbour PQ codes], so a host-driven walk scores a hop from one record
read and no PQ codes stay resident.

A bf16 data file is read as uint16 bit patterns and widened exactly; its
raw disk payload stays bf16 (a "bfloat16" section). The JAX package reads
it as float32 and fails to build on every bf16 corpus.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet, GenRangeResultDataSet, GenResultDataSet, GenTensorDataSet
from ..device import to_device
from ..factory import register_index
from ..feature import feature
from ..index_node import DEVICE_K_MAX, ExpandingIteratorGroup, IndexNode
from ..index_param import IndexEnum, metric as M, normalize_metric
from ..io.serialize import read_sections, write_sections, write_sections_streaming
from ..ops import distances as D
from ..ops import quant as Q
from ..ops import topk as T
from ..ops.distances import pad_rows_ladder
from ..ops.graph import beam_search, build_graph, pick_entry_points
from ..ops.kmeans import kmeans
from ..ops.refine import RefineStore, refine_topk
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import as_f32
from ..utils.logging import log_info, log_warning

VAMANA_ALPHA = 1.2  # DiskANN default
ROUTED_MIN_ROWS = 65536  # above this the build routes: k-means entries and centroids
PQ_CHUNK = 262144  # rows a PQ training sample holds at most, and a PQ encode step
BRUTE_CHUNK = 131072  # disk rows an exact-scan step reads
SHARD_SAMPLE = 131072  # rows the sharded build's k-means trains on
INLINE_CHUNK = 65536  # AISAQ inline records a write step makes
FILTER_FALLBACK_RATIO = 0.95  # a bitset this dense is answered by the exact scan
_NP_DTYPE = {"fp32": np.float32, "fp16": np.float16, "bf16": np.uint16, "int8": np.int8}


class DiskANNConfig(BaseConfig):
    max_degree = Entry(int, default=48, range=(1, 2048), stages=[Stage.TRAIN])
    search_list_size = Entry(int, range=(1, None), stages=[Stage.TRAIN, Stage.SEARCH, Stage.ITERATOR], allow_empty=True)
    pq_code_budget_gb = Entry(float, range=(0.0, None), stages=[Stage.TRAIN], allow_empty=True)
    pq_code_budget_gb_ratio = Entry(float, range=(0.0, None), stages=[Stage.TRAIN], allow_empty=True)
    build_dram_budget_gb = Entry(float, default=16.0, range=(0.0, None), stages=[Stage.TRAIN])
    disk_pq_dims = Entry(int, default=0, range=(0, None), stages=[Stage.TRAIN])
    accelerate_build = Entry(bool, default=False, stages=[Stage.TRAIN])
    search_cache_budget_gb = Entry(float, default=0.0, range=(0.0, None), stages=[Stage.DESERIALIZE])
    search_cache_budget_gb_ratio = Entry(float, range=(0.0, None), stages=[Stage.DESERIALIZE], allow_empty=True)
    warm_up = Entry(bool, default=False, stages=[Stage.DESERIALIZE])
    use_bfs_cache = Entry(bool, default=False, stages=[Stage.DESERIALIZE])
    beamwidth = Entry(int, default=8, range=(1, 128), stages=[Stage.SEARCH, Stage.ITERATOR])
    min_k = Entry(int, default=100, range=(1, None), stages=[Stage.RANGE_SEARCH])
    max_k = Entry(int, default=10000, range=(1, None), stages=[Stage.RANGE_SEARCH])
    filter_threshold = Entry(float, default=-1.0, range=(-1.0, 1.0), stages=[Stage.SEARCH])


def _read_diskann_bin(path: str, dtype: np.dtype) -> np.ndarray:
    """DiskANN bin format: [npts int32][dim int32][row-major payload]."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=2)
        if header.size != 2:
            raise KnowhereException(f"bad diskann bin file {path}", Status.disk_file_error)
        npts, dim = int(header[0]), int(header[1])
        data = np.fromfile(f, dtype=dtype, count=npts * dim)
    if data.size != npts * dim:
        raise KnowhereException(f"truncated diskann bin file {path}", Status.disk_file_error)
    return data.reshape(npts, dim)


def _pow2ceil(n: int) -> int:
    """The rerank's upload rows: a power of two of at least 1024."""
    p = 1024
    while p < n:
        p *= 2
    return p


class DiskANNIndexNode(IndexNode):
    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_DISKANN
        self.data_type = "fp32"
        self.file_manager = object  # reference: Pack<shared_ptr<FileManager>>
        self._lock = threading.RLock()
        self._metric = M.L2
        self._dim = 0
        self._count = 0
        self._index_prefix: Optional[str] = None
        # loaded state
        self._graph_dev: Optional[torch.Tensor] = None
        self._graph_shape = None
        self._entry: Optional[torch.Tensor] = None
        self._entry_cents: Optional[torch.Tensor] = None  # k-means routing centroids
        self._store: Optional[Dict[str, torch.Tensor]] = None  # PQ codes + codebooks
        self._disk_data: Optional[np.ndarray] = None  # raw rows (or PQ codes) on disk
        self._disk_pq: Optional[Q.PQCodec] = None  # set when disk_pq_dims > 0
        self._build_stats: Dict[str, object] = {}
        self._refine_store: Optional[RefineStore] = None  # every raw row on the device
        # partial node cache (reference: PQFlashIndex node cache, diskann.cc:640-760)
        self._cache_pos: Optional[np.ndarray] = None  # (count,) int32 -> slot or -1
        self._cache_ids: Optional[np.ndarray] = None  # (C,) slot -> id
        self._cache_rows: Optional[torch.Tensor] = None  # (C, d) f32 on the device
        self._loaded = False

    # --- paths --------------------------------------------------------------
    def _mem_path(self, prefix: str) -> str:
        return prefix + "_kwtpu_mem.bin"

    def _disk_path(self, prefix: str) -> str:
        return prefix + "_kwtpu_disk.bin"

    def _fm_load(self, path: str) -> None:
        if self.file_manager is not None and hasattr(self.file_manager, "LoadFile"):
            if not self.file_manager.LoadFile(path):
                raise KnowhereException(f"FileManager failed to load {path}", Status.disk_file_error)

    def _fm_add(self, path: str) -> None:
        if self.file_manager is not None and hasattr(self.file_manager, "AddFile"):
            if not self.file_manager.AddFile(path):
                raise KnowhereException(f"FileManager failed to add {path}", Status.disk_file_error)

    # --- build ---------------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        return self.Build(dataset, cfg)  # reference builds in one shot

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        return Status.success  # Build already wrote everything

    def Build(self, dataset: DataSet, cfg: Config) -> Status:
        if not (cfg.get("index_prefix") and cfg.get("data_path")):
            return Status.invalid_param_in_json
        prefix = cfg.index_prefix
        if os.path.exists(self._mem_path(prefix)):
            log_warning(f"index files already exist under {prefix}")
            return Status.index_already_trained
        self._fm_load(cfg.data_path)
        self._metric = normalize_metric(cfg.metric_type)
        if self._metric not in (M.L2, M.IP, M.COSINE):
            return Status.invalid_metric_type
        with open(cfg.data_path, "rb") as f:
            header = np.fromfile(f, dtype=np.int32, count=2)
        if header.size != 2:
            return Status.disk_file_error
        self._count, self._dim = int(header[0]), int(header[1])
        # the corpus is never loaded whole: build streams slices off this map
        # (bf16 rows as their uint16 bit patterns)
        data_mm = np.memmap(
            cfg.data_path, dtype=_NP_DTYPE.get(self.data_type, np.float32), mode="r", offset=8,
            shape=(self._count, self._dim),
        )

        deg = int(cfg.max_degree)
        efc = int(cfg.get("search_list_size") or 128)
        accel = bool(cfg.get("accelerate_build", False))
        internal = M.IP if self._metric == M.COSINE else self._metric
        normalize = self._metric == M.COSINE

        # DRAM budget (reference build_dram_budget_gb, diskann_config.h:88-164;
        # the sharded build + merge of DiskANN's build_merged_vamana_index):
        # rows above the budget build one Vamana graph per shard of 2-way
        # overlapping k-means partitions and merge the edge lists
        budget_gb = float(cfg.get("build_dram_budget_gb", 16.0) or 16.0)
        row_cost = self._dim * 8 + deg * 16  # shard rows + graph working set
        rows_in_budget = max(int(budget_gb * 1e9 // row_cost), 4096)
        sharded = self._count > rows_in_budget
        self._build_stats = {
            "sharded": sharded,
            "n_shards": 1,
            "accelerated": accel,
            "rows_in_budget": rows_in_budget,
        }
        if sharded:
            graph, entry, entry_cents = self._sharded_build(
                data_mm, deg, efc, rows_in_budget, accel, internal, normalize
            )
        else:
            graph, entry, entry_cents = self._single_build(data_mm, deg, efc, accel, internal, normalize)

        # PQ codes on the device sized by pq_code_budget_gb (bytes a row);
        # trained on a stride sample, encoded a chunk at a time
        budget_pq = cfg.get("pq_code_budget_gb")
        if budget_pq:
            m = int(max(1, min(self._dim, budget_pq * 1e9 / max(self._count, 1))))
        else:
            m = max(1, self._dim // 4)
        while m > 1 and self._dim % m != 0:
            m -= 1
        sample = self._sample_rows(data_mm, normalize, cap=PQ_CHUNK)
        pq = Q.pq_train(sample, m, 8)
        codes = np.empty((self._count, m), np.uint8)
        for s in range(0, self._count, PQ_CHUNK):
            e = min(s + PQ_CHUNK, self._count)
            codes[s:e] = Q.pq_encode(pq, self._load_rows(data_mm, slice(s, e), normalize))

        # AISAQ's num_entry_points caps the entry list (diskann_aisaq.cc);
        # DISKANN's config does not declare the key
        nep = int(cfg.get("num_entry_points", 0) or 0)
        if nep > 0:
            entry = np.asarray(entry)[:nep]
            if entry_cents is not None:
                entry_cents = entry_cents[:nep]
        mem_sections = {
            "graph": graph,
            "entry": entry,
            "pq_codebooks": pq.codebooks,
            "pq_codes": codes,
        }
        if entry_cents is not None:
            mem_sections["entry_cents"] = entry_cents
        mem_blob = write_sections(
            mem_sections,
            meta={
                "metric": self._metric,
                "dim": self._dim,
                "count": self._count,
                "data_type": self.data_type,
                "max_degree": deg,
            },
        )
        with open(self._mem_path(prefix), "wb") as f:
            f.write(mem_blob)

        # disk payload: raw rows, or disk-PQ codes when disk_pq_dims > 0
        # (reference disk_pq compresses the disk-resident rows)
        disk_pq_dims = int(cfg.get("disk_pq_dims", 0) or 0)
        self._write_disk_payload(prefix, data_mm, normalize, sample, disk_pq_dims)
        self._fm_add(self._mem_path(prefix))
        self._fm_add(self._disk_path(prefix))
        log_info(
            f"diskann build complete: {self._count} rows -> {prefix} "
            f"(sharded={sharded}, shards={self._build_stats['n_shards']}, accel={accel})"
        )
        # reference leaves the node unloaded after Build; Deserialize loads it
        return Status.success

    # --- build helpers -------------------------------------------------------
    def _single_build(self, data_mm, deg: int, efc: int, accel: bool, internal: str, normalize: bool):
        """One Vamana graph over every row: (graph, entry rows, routing
        centroids or None). Above ROUTED_MIN_ROWS rows the k-means of the
        kNN graph's IVF route also gives the entries: each centroid's
        nearest row."""
        x = self._load_rows(data_mm, slice(None), normalize)
        # accelerate_build trades graph quality for build time (reference
        # accelerate_build skips the second Vamana pass): kNN-graph only, no
        # wide intermediate diversification
        inter = (
            min(deg, max(self._count - 1, 1))
            if accel
            else min(max(deg * 2, min(efc, 128)), max(self._count - 1, 1))
        )
        cents = assign = None
        if self._count > ROUTED_MIN_ROWS:
            # the pow2 ladder of build_graph's own nlist, or it reruns k-means
            nlist = 1 << int(round(np.log2(max(64, int(np.sqrt(self._count))))))
            cents, assign = kmeans(x, nlist, n_iters=4 if accel else 8)
        x_dev = to_device(x)  # one resident corpus for the graph and the entries
        graph = build_graph(
            x, deg, internal, intermediate_deg=inter, alpha=VAMANA_ALPHA,
            centroids=cents, assign=assign, x_dev=x_dev,
        )
        if cents is not None:
            ids, _ = T.knn_search(cents, x_dev, 1, "L2", aux=D.base_aux("L2", x_dev))
            return graph, ids.reshape(-1).astype(np.int32), cents.astype(np.float32)
        entry = pick_entry_points(x, n_entry=int(min(max(64, self._count // 500), 1024, self._count)), base_dev=x_dev)
        return graph, entry, None

    @staticmethod
    def _load_rows(data_mm: np.ndarray, sel, normalize: bool) -> np.ndarray:
        x = as_f32(data_mm[sel])
        if normalize:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            n[n == 0] = 1.0
            x = x / n
        return x

    def _sample_rows(self, data_mm, normalize: bool, cap: int) -> np.ndarray:
        stride = max(1, self._count // min(self._count, cap))
        return self._load_rows(data_mm, slice(None, None, stride), normalize)

    @staticmethod
    def _merge_edges(cur: np.ndarray, new: np.ndarray, deg: int) -> np.ndarray:
        """Union-dedup-truncate of two edge lists per row (reference merged
        Vamana: concatenate shard neighbour lists, dedupe, keep max_degree;
        aux_utils.cpp build_merged_vamana_index)."""
        cand = np.concatenate([cur, new], axis=1)
        n, w = cand.shape
        sentinel = np.iinfo(np.int64).max
        key = np.where(cand < 0, sentinel, cand.astype(np.int64))
        order = np.argsort(key, axis=1, kind="stable")
        sv = np.take_along_axis(key, order, 1)
        first = np.ones_like(sv, dtype=bool)
        first[:, 1:] = sv[:, 1:] != sv[:, :-1]
        first &= sv != sentinel
        keep = np.zeros((n, w), bool)
        np.put_along_axis(keep, order, first, 1)
        out = np.full((n, deg), -1, np.int32)
        rows, cols = np.nonzero(keep)
        starts = np.searchsorted(rows, np.arange(n))
        cc = np.arange(len(rows)) - starts[rows]
        sel = cc < deg
        out[rows[sel], cc[sel]] = cand[rows[sel], cols[sel]]
        return out

    def _sharded_build(
        self, data_mm, deg: int, efc: int, rows_in_budget: int,
        accel: bool, internal: str, normalize: bool,
    ):
        """Budget-bounded build: k-means partitions of the corpus (each row
        in its 2 nearest, DiskANN's default overlap), one Vamana graph per
        shard over the shard's rows read off disk, the per-row union of the
        shards' edge lists. Peak host memory is one shard, not the
        corpus."""
        count = self._count
        n_shards = max(2, -(-2 * count // rows_in_budget))
        self._build_stats["n_shards"] = n_shards
        sample = self._sample_rows(data_mm, normalize, cap=SHARD_SAMPLE)
        cents, _ = kmeans(sample, n_shards, n_iters=4 if accel else 8)
        cents = cents.astype(np.float32)

        # streaming 2-nearest-partition assignment
        shard_rows: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
        chunk = max(8192, min(262144, rows_in_budget // 2))
        c_sq = np.sum(cents.astype(np.float64) ** 2, axis=1).astype(np.float32)
        entry = np.zeros(n_shards, np.int32)
        entry_best = np.full(n_shards, np.inf, np.float32)
        for s in range(0, count, chunk):
            e = min(s + chunk, count)
            x = self._load_rows(data_mm, slice(s, e), normalize)
            d2 = c_sq[None, :] - 2.0 * (x @ cents.T)  # rank-equivalent to L2^2
            near2 = np.argpartition(d2, 1, axis=1)[:, :2]
            for j in (0, 1):
                a = near2[:, j]
                for si in np.unique(a):
                    shard_rows[si].append((s + np.nonzero(a == si)[0]).astype(np.int64))
            # each shard's entry row: the row closest to its centroid
            a0 = near2[:, 0]
            d0 = np.take_along_axis(d2, a0[:, None], 1).ravel()
            for si in np.unique(a0):
                m_ = a0 == si
                loc = np.argmin(d0[m_])
                if d0[m_][loc] < entry_best[si]:
                    entry_best[si] = d0[m_][loc]
                    entry[si] = s + np.nonzero(m_)[0][loc]

        graph = np.full((count, deg), -1, np.int32)
        for si in range(n_shards):
            if not shard_rows[si]:
                continue
            ids = np.unique(np.concatenate(shard_rows[si]))
            x_local = self._load_rows(data_mm, ids, normalize)
            n_l = len(ids)
            if n_l < 2:
                continue
            deg_l = min(deg, n_l - 1)
            inter = deg_l if accel else min(max(deg_l * 2, min(efc, 128)), n_l - 1)
            g_local = build_graph(x_local, deg_l, internal, intermediate_deg=inter, alpha=VAMANA_ALPHA)
            g_glob = np.where(g_local >= 0, ids[np.clip(g_local, 0, None)], -1).astype(np.int32)
            if g_glob.shape[1] < deg:
                g_glob = np.pad(g_glob, ((0, 0), (0, deg - g_glob.shape[1])), constant_values=-1)
            graph[ids] = self._merge_edges(graph[ids], g_glob, deg)
            log_info(f"diskann shard {si + 1}/{n_shards}: {n_l} rows merged")
        return graph, entry, cents

    def _write_disk_payload(
        self, prefix: str, data_mm, normalize: bool, sample: np.ndarray, disk_pq_dims: int
    ) -> None:
        count, dim = self._count, self._dim
        if disk_pq_dims > 0:
            m_disk = min(disk_pq_dims, dim)
            while m_disk > 1 and dim % m_disk != 0:
                m_disk -= 1
            pq_disk = Q.pq_train(sample, m_disk, 8)
            w = write_sections_streaming(
                self._disk_path(prefix),
                {"codes": ((count, m_disk), "uint8"),
                 "codebooks": (tuple(pq_disk.codebooks.shape), "float32")},
                meta={"dim": dim, "count": count, "disk_pq_dims": m_disk},
            )
            w.write("codebooks", 0, pq_disk.codebooks)
            for s in range(0, count, PQ_CHUNK):
                e = min(s + PQ_CHUNK, count)
                w.write("codes", s, Q.pq_encode(pq_disk, self._load_rows(data_mm, slice(s, e), normalize)))
            w.close()
            return
        # raw rows keep their native width (int8 stays 1 byte a dim, bf16 a
        # "bfloat16" section of uint16 bit patterns); cosine stores normalized
        # f32 copies
        out_dtype = "float32" if normalize else str(data_mm.dtype)
        w = write_sections_streaming(
            self._disk_path(prefix),
            {"data": ((count, dim), out_dtype)},
            meta={"dim": dim, "count": count},
            bf16=("data",) if out_dtype == "uint16" else (),
        )
        for s in range(0, count, PQ_CHUNK):
            e = min(s + PQ_CHUNK, count)
            block = (
                self._load_rows(data_mm, slice(s, e), True)
                if normalize
                else np.asarray(data_mm[s:e])
            )
            w.write("data", s, block)
        w.close()

    # --- load ------------------------------------------------------------------
    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        prefix = cfg.get("index_prefix")
        if not prefix:
            return Status.invalid_param_in_json
        self._fm_load(self._mem_path(prefix))
        self._fm_load(self._disk_path(prefix))
        try:
            mem = np.memmap(self._mem_path(prefix), dtype=np.uint8, mode="r")
            disk = np.memmap(self._disk_path(prefix), dtype=np.uint8, mode="r")
        except OSError as e:
            raise KnowhereException(str(e), Status.disk_file_error) from e
        arrays, meta = read_sections(memoryview(mem))
        d_arrays, _d_meta = read_sections(memoryview(disk))
        with self._lock:
            self._index_prefix = prefix
            self._metric = meta["metric"]
            self._dim = int(meta["dim"])
            self._count = int(meta["count"])
            self.data_type = meta.get("data_type", "fp32")
            graph = np.asarray(arrays["graph"])
            self._graph_dev = to_device(graph)
            self._graph_shape = graph.shape
            self._entry = to_device(np.asarray(arrays["entry"]))
            self._entry_cents = to_device(np.asarray(arrays["entry_cents"])) if "entry_cents" in arrays else None
            self._store = {
                "codes": to_device(np.asarray(arrays["pq_codes"])),
                "codebooks": to_device(np.asarray(arrays["pq_codebooks"])),
            }
            # disk payload: raw rows, or PQ codes when built with disk_pq_dims
            self._disk_pq = None
            if "codes" in d_arrays:
                dbooks = np.array(d_arrays["codebooks"])
                self._disk_pq = Q.PQCodec(dbooks, dbooks.shape[0], int(np.log2(dbooks.shape[1])))
                self._disk_data = d_arrays["codes"]  # zero-copy memmap view
            else:
                self._disk_data = d_arrays["data"]  # zero-copy memmap view
            # node cache: every raw row on the device when the budget holds
            # them; a smaller budget caches a node subset (reference:
            # PQFlashIndex node cache sized by search_cache_budget_gb,
            # BFS-seeded under use_bfs_cache, diskann.cc:640-760) and the
            # rerank reads only the misses from disk
            budget = float(cfg.get("search_cache_budget_gb", 0.0) or 0.0)
            row_bytes = self._dim * 4
            self._refine_store = None
            self._cache_pos = None
            self._cache_ids = None
            self._cache_rows = None
            budget_rows = int(budget * 1e9 // max(row_bytes, 1))
            if budget_rows >= self._count:
                self._refine_store = RefineStore("raw", to_device(self._rows_from_disk(slice(None))))
            elif budget_rows >= 256:
                if cfg.get("use_bfs_cache", False):
                    cache_ids = self._bfs_cache_ids(graph, budget_rows)
                else:
                    # a uniform stride: beam candidates are query-dependent
                    # and spread over the corpus
                    cache_ids = np.arange(0, self._count, max(1, self._count // budget_rows))[
                        :budget_rows
                    ].astype(np.int64)
                self._cache_ids = cache_ids
                self._cache_pos = np.full(self._count, -1, np.int32)
                self._cache_pos[cache_ids] = np.arange(len(cache_ids), dtype=np.int32)
                self._cache_rows = to_device(self._rows_from_disk(cache_ids))
            if cfg.get("warm_up", False):
                _ = np.asarray(self._disk_data[: min(1024, self._count)])  # touch pages
            self._loaded = True
        return Status.success

    def DeserializeFromFile(self, filename: str, cfg: Config) -> Status:
        return self.Deserialize(BinarySet(), cfg)

    def Serialize(self, binset: BinarySet) -> Status:
        # the index lives on disk (reference diskann.cc:133-139)
        return Status.success

    # --- search ----------------------------------------------------------------
    def _prep_q(self, dataset: DataSet) -> np.ndarray:
        xq = as_f32(dataset.tensor)
        if self._metric == M.COSINE:
            n = np.linalg.norm(xq, axis=1, keepdims=True)
            n[n == 0] = 1.0
            xq = xq / n
        return xq

    @staticmethod
    def _bfs_cache_ids(graph: np.ndarray, budget_rows: int) -> np.ndarray:
        """Breadth-first node set from node 0, level by level until the
        budget fills (the reference's cache_bfs_levels, which starts at node
        0 and not at the build's entry rows)."""
        seen = np.zeros(graph.shape[0], bool)
        frontier = np.asarray([0], np.int64)
        seen[0] = True
        out = [frontier]
        total = 1
        while total < budget_rows and frontier.size:
            nxt = np.unique(graph[frontier].reshape(-1))
            nxt = nxt[(nxt >= 0) & ~seen[np.clip(nxt, 0, None)]]
            if not nxt.size:
                break
            seen[nxt] = True
            take = nxt[: budget_rows - total]
            out.append(take.astype(np.int64))
            total += take.size
            frontier = take
        return np.sort(np.concatenate(out))

    def _rows_from_disk(self, sel) -> np.ndarray:
        """f32 rows off the disk payload: widened (bf16, fp16, int8), or
        PQ-decoded when the index was built with disk_pq_dims."""
        block = np.asarray(self._disk_data[sel])
        if self._disk_pq is None:
            return as_f32(block)
        books = self._disk_pq.codebooks  # (m, ksub, sub_dim)
        m = books.shape[0]
        dec = books[np.arange(m)[None, :], block.astype(np.int64), :]
        return np.ascontiguousarray(dec.reshape(block.shape[0], -1), dtype=np.float32)

    def _rerank_from_disk(self, xq: np.ndarray, cand: np.ndarray, k: int, is_l2: bool):
        """Exact rerank of the walk's candidates from raw rows: the device
        cache of every row, the partial cache and disk reads of its misses,
        or disk reads of every candidate."""
        if self._refine_store is not None:
            return refine_topk(xq, self._refine_store, cand, k, is_l2)
        uniq = np.unique(cand[cand >= 0])
        local = np.full_like(cand, -1)
        pos = cand >= 0
        order = np.searchsorted(uniq, cand[pos]).astype(cand.dtype)
        if self._cache_pos is not None and uniq.size:
            # partial node cache: hits index the resident slab; only the
            # misses are read from disk and uploaded
            cpos = self._cache_pos[uniq]
            hit = cpos >= 0
            miss_ids = uniq[~hit]
            C = int(self._cache_rows.shape[0])
            P = _pow2ceil(max(miss_ids.size, 1))
            rows_miss = np.zeros((P, self._dim), np.float32)
            if miss_ids.size:
                rows_miss[: miss_ids.size] = self._rows_from_disk(miss_ids)
            rows_dev = torch.cat([self._cache_rows, to_device(rows_miss)], dim=0)
            # each unique id's local slot: its cache slot, or C + its miss rank
            slot = np.where(hit, cpos, C + np.cumsum(~hit) - 1).astype(np.int32)
            local[pos] = slot[order]
            id_map = np.concatenate([self._cache_ids, miss_ids])
            dists, loc = refine_topk(xq, RefineStore("raw", rows_dev), local, k, is_l2)
            ids = np.where(loc >= 0, id_map[np.clip(loc, 0, None)], -1)
            return dists, ids
        # no cache: upload the unique candidate rows, padded to a power of two
        P = _pow2ceil(max(uniq.size, 1))
        rows = np.zeros((P, self._dim), np.float32)
        if uniq.size:
            rows[: uniq.size] = self._rows_from_disk(uniq)
        local[pos] = order
        dists, loc = refine_topk(xq, RefineStore("raw", to_device(rows)), local, k, is_l2)
        ids = np.where(loc >= 0, uniq[np.clip(loc, 0, None)], -1)
        return dists, ids

    @staticmethod
    def _dense_filter(cfg: Config, bitset: BitsetView) -> bool:
        """A bitset dense enough for the exact disk scan: at filter_threshold
        when set, else at FILTER_FALLBACK_RATIO."""
        ratio = bitset.filter_ratio() if not bitset.empty_view() else 0.0
        thresh = cfg.get("filter_threshold", -1.0)
        return thresh is not None and thresh >= 0 and ratio >= thresh or ratio >= FILTER_FALLBACK_RATIO

    def _fill_stranded(self, xq: np.ndarray, k: int, bitset: BitsetView, dists, ids):
        """Queries a filtered walk left short of min(k, valid rows) get the
        exact disk scan's answer."""
        n_valid = self._count - bitset.count()
        unfilled = (ids >= 0).sum(1) < min(k, n_valid)
        if unfilled.any():
            bd, bi = self._brute_force_disk(xq[unfilled], k, bitset)
            dists[unfilled], ids[unfilled] = bd, bi

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        with self._lock:
            if not self._loaded:
                return expected.Err(Status.empty_index, "diskann index not loaded")
            metric = normalize_metric(cfg.metric_type)
            if metric != self._metric:
                return expected.Err(Status.invalid_metric_type, "metric mismatch")
            k = cfg.k
            L = int(cfg.get("search_list_size") or max(k * 10, 100))
            L = max(L, k)
            xq = self._prep_q(dataset)
            nq = xq.shape[0]
            is_l2 = self._metric == M.L2
            if self._dense_filter(cfg, bitset):
                dists, ids = self._brute_force_disk(xq, k, bitset)
                return expected.Ok(GenResultDataSet(nq, k, ids, dists))
            keep = bitset.device_mask(self._count) if not bitset.empty_view() else None

            # beamwidth: the reference's cached_beam_search knob
            W = int(cfg.get("beamwidth") or max(1, min(8, L // 8)))
            n_seed = 0 if self._entry_cents is None else int(min(max(8, L // 8), 64))
            _, cand = beam_search(
                to_device(pad_rows_ladder(xq)),
                self._store,
                self._graph_dev,
                self._entry,
                keep,
                kind="pq",
                ef=L,
                k=min(L, max(k * 2, 32)),
                deg=self._graph_shape[1],
                max_iters=(2 * L) // max(W, 1) + 32,
                is_l2=is_l2,
                has_mask=keep is not None,
                beam_width=W,
                route_cents=self._entry_cents,
                n_seed=n_seed,
            )
            cand = cand.cpu().numpy()[:nq]
            dists, ids = self._rerank_from_disk(xq, cand, k, is_l2)
            if not bitset.empty_view():
                self._fill_stranded(xq, k, bitset, dists, ids)
            return expected.Ok(GenResultDataSet(nq, k, ids.astype(np.int64), dists))

    def _brute_force_disk(self, xq, k, bitset: BitsetView):
        """Exact scan of the disk payload a BRUTE_CHUNK of rows at a time,
        merged on the host (stable: the earlier row wins a tie), with a
        cancellation check a chunk."""
        from ..comp import check_current_cancellation

        internal = M.IP if self._metric == M.COSINE else self._metric
        is_l2 = internal == M.L2
        q_dev = to_device(np.asarray(xq, np.float32))
        best_d = np.full((xq.shape[0], k), np.inf if is_l2 else -np.inf, np.float32)
        best_i = np.full((xq.shape[0], k), -1, np.int64)
        keep_all = bitset.host_mask(self._count) if not bitset.empty_view() else None
        for s in range(0, self._count, BRUTE_CHUNK):
            check_current_cancellation()  # a chunk (ivf.cc:962 analog)
            e = min(s + BRUTE_CHUNK, self._count)
            block = to_device(self._rows_from_disk(slice(s, e)))
            mask = to_device(keep_all[s:e]) if keep_all is not None else None
            d, i = T.knn_device(q_dev, block, min(k, e - s), internal, mask=mask)
            d, i = d.cpu().numpy(), i.cpu().numpy().astype(np.int64)
            i = np.where(i >= 0, i + s, -1)
            cat_d = np.concatenate([best_d, d], axis=1)
            cat_i = np.concatenate([best_i, i], axis=1)
            sort_d = np.where(cat_i >= 0, cat_d, np.inf if is_l2 else -np.inf)
            order = np.argsort(sort_d if is_l2 else -sort_d, axis=1, kind="stable")[:, :k]
            best_d = np.take_along_axis(cat_d, order, 1)
            best_i = np.take_along_axis(cat_i, order, 1)
        return best_d, best_i

    # --- range search / iterator --------------------------------------------------
    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        """Search rounds that widen k x4 from min_k until every query's k-th
        distance leaves the radius or k reaches max_k (or the row count),
        then the rows inside [radius, range_filter)."""
        with self._lock:
            if not self._loaded:
                return expected.Err(Status.empty_index, "diskann index not loaded")
            radius = cfg.get("radius", 0.0)
            range_filter = cfg.get("range_filter", float("inf"))
            two_sided = np.isfinite(range_filter)
            min_k = int(cfg.get("min_k", 100) or 100)
            max_k = int(cfg.get("max_k", 10000) or 10000)
            larger = self._metric != M.L2
            xq = self._prep_q(dataset)
            nq = xq.shape[0]
            k_cur = min(min_k, self._count)
            cap = min(max_k, self._count)
            while True:
                sub = DataSet()
                sub.set("tensor", xq)
                sub.rows = nq
                sub.dim = self._dim
                scfg = self.CreateConfig()
                Config.load(
                    scfg, {"metric_type": self._metric, "k": k_cur, "search_list_size": max(k_cur, 100)}, Stage.SEARCH
                )
                res = self.Search(sub, scfg, bitset)
                if not res.has_value():
                    return res
                ds = res.value()
                dists = ds.distance.reshape(nq, k_cur)
                ids = ds.ids.reshape(nq, k_cur)
                if k_cur >= cap:
                    break
                frontier = dists[:, -1]
                still = (frontier > radius) if larger else (frontier < radius)
                still &= ids[:, -1] >= 0
                if not still.any():
                    break
                k_cur = min(cap, k_cur * 4)
            lims = np.zeros(nq + 1, np.int64)
            out_i, out_d = [], []
            for i in range(nq):
                keep_i = ids[i] >= 0
                if larger:
                    keep_i &= dists[i] > radius
                    if two_sided:
                        keep_i &= dists[i] <= range_filter
                else:
                    keep_i &= dists[i] < radius
                    if two_sided:
                        keep_i &= dists[i] >= range_filter
                sel = np.nonzero(keep_i)[0]
                out_i.append(ids[i, sel])
                out_d.append(dists[i, sel])
                lims[i + 1] = lims[i] + len(sel)
            ids_cat = np.concatenate(out_i) if out_i else np.empty(0, np.int64)
            d_cat = np.concatenate(out_d) if out_d else np.empty(0, np.float32)
            return expected.Ok(GenRangeResultDataSet(nq, ids_cat, d_cat, lims))

    def AnnIterator(self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True):
        with self._lock:
            if not self._loaded:
                return expected.Err(Status.empty_index, "diskann index not loaded")
        nq = dataset.rows
        larger = self._metric != M.L2
        count = self._count
        n_valid = count - (bitset.count() if not bitset.empty_view() else 0)
        k0 = min(count, 4096)

        # resumable beam rounds (reference IteratorWorkspace over PQFlashIndex,
        # diskann.cc:228-256, 830-871): k and search_list_size x4 a round; the
        # covering last round is the chunked exact scan of the disk payload
        covered = {"done": False}

        def round_fn(r: int):
            if covered["done"]:
                return None
            k_r = min(n_valid, k0 << (2 * r))
            if k_r >= n_valid or k_r > DEVICE_K_MAX:
                covered["done"] = True
                with self._lock:
                    xq = self._prep_q(dataset)
                    d_f, i_f = self._brute_force_disk(xq, max(n_valid, 1), bitset)
                return i_f, d_f
            scfg = self.CreateConfig()
            Config.load(
                scfg,
                {"metric_type": self._metric, "k": k_r, "search_list_size": max(k_r // 2, 100)},
                Stage.SEARCH,
            )
            res = self.Search(dataset, scfg, bitset)
            if not res.has_value():
                raise KnowhereException(res.what(), res.error())
            ds = res.value()
            return ds.ids.reshape(nq, k_r), ds.distance.reshape(nq, k_r)

        group = ExpandingIteratorGroup(nq, count, round_fn)
        return expected.Ok([group.make_iterator(i, larger_is_closer=larger) for i in range(nq)])

    # --- vectors / meta --------------------------------------------------------------
    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        with self._lock:
            if not self._loaded:
                return expected.Err(Status.empty_index, "diskann index not loaded")
            if self._metric == M.COSINE:
                return expected.Err(Status.not_implemented, "cosine diskann stores normalized rows")
            if self._disk_pq is not None:
                return expected.Err(Status.not_implemented, "disk_pq_dims index stores PQ codes, not raw rows")
            ids = np.asarray(dataset.ids, dtype=np.int64)
            if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self._count:
                return expected.Err(Status.invalid_args, "id out of range")
            out = np.asarray(self._disk_data[ids])
            return expected.Ok(GenTensorDataSet(out, len(ids), self._dim))

    def HasRawData(self, metric_type: str = "L2") -> bool:
        return normalize_metric(metric_type) != M.COSINE and self._disk_pq is None

    def GetIndexMeta(self, cfg: Config) -> "expected[DataSet]":
        """Vamana graph overview (reference include/knowhere/feder/DiskANN.h)."""
        if not self._loaded:
            return expected.Err(Status.empty_index, "diskann index not loaded")
        deg = (self._graph_dev >= 0).sum(dim=1).cpu().numpy()
        meta = {
            "index_type": self.Type(),
            "metric_type": self._metric,
            "dim": self._dim,
            "count": self._count,
            "max_degree": int(self._graph_shape[1]),
            "avg_degree": float(deg.mean()),
            "entry_points": self._entry.cpu().numpy().tolist()[:64],
        }
        ds = DataSet()
        ds.set("json_info", json.dumps(meta))
        return expected.Ok(ds)

    def GetFederVisit(self, dataset: DataSet, cfg: Config) -> "expected[DataSet]":
        """trace_visit replay of the beam walk on the host (reference
        feder/DiskANN.h)."""
        from ..feder import instrumented_walk

        if not self._loaded:
            return expected.Err(Status.empty_index, "diskann index not loaded")
        xq = self._prep_q(dataset)
        ef = int(cfg.get("search_list_size") or max(int(cfg.get("k", 10) or 10), 16))
        graph = self._graph_dev.cpu().numpy()
        entry = self._entry.cpu().numpy()
        x_host = self._rows_from_disk(slice(None))
        traces = [instrumented_walk(x_host, graph, entry, q, ef, is_l2=self._metric != M.IP) for q in xq]
        ds = DataSet()
        ds.set("json_id_set", json.dumps(traces))
        return expected.Ok(ds)

    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        if self._store is None:
            return 0
        return int(self._graph_shape[0] * self._graph_shape[1] * 4)

    def Count(self) -> int:
        return self._count

    def Type(self) -> str:
        return self.index_type

    @staticmethod
    def CreateConfig() -> Config:
        return DiskANNConfig()


register_index(
    IndexEnum.INDEX_DISKANN,
    ("fp32", "fp16", "bf16", "int8"),
    feature.ALL_DENSE_FLOAT_TYPE | feature.INT8 | feature.KNN | feature.DISK | feature.LAZY_LOAD,
)(DiskANNIndexNode)
# legacy alias (reference diskann.cc:1070 registers DISKANN_DEPRECATED over
# the same float types)
register_index(
    "DISKANN_DEPRECATED",
    ("fp32", "fp16", "bf16"),
    feature.ALL_DENSE_FLOAT_TYPE | feature.KNN | feature.DISK | feature.LAZY_LOAD,
)(DiskANNIndexNode)


class AisaqIndexNode(DiskANNIndexNode):
    """AISAQ (reference src/index/diskann/diskann_aisaq.cc; All-in-Storage
    ANNS): DiskANN whose PQ codes live on disk, inline with the graph
    records, instead of on the device.

    One record a node: [adjacency deg x i32][own PQ code m x u8][neighbour
    PQ codes deg x m x u8]. One read of an expanded node gives the hop's
    topology and every code it needs to score, so serving holds no PQ codes.
    Search runs a host-driven beam over the record memmap (its page faults
    are the disk reads) and ends in DISKANN's exact rerank from the raw disk
    payload. num_entry_points caps the entry list at build; pq_cache_size
    funds the node cache at load; vectors_beamwidth bounds the walk's beam;
    inline_pq=false serves DISKANN's device PQ walk."""

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_AISAQ
        self._inline_nodes = None  # (n, rec_bytes) u8 memmap view
        self._inline_geom = None  # (deg, m)
        self._books_host = None
        self._entry_host = None

    def _inline_path(self, prefix: str) -> str:
        return prefix + "_aisaq_inline.bin"

    def Build(self, dataset: DataSet, cfg: Config) -> Status:
        st = super().Build(dataset, cfg)
        if st == Status.success and cfg.get("inline_pq", True):
            self._write_inline_nodes(cfg.index_prefix)
        return st

    def _write_inline_nodes(self, prefix: str) -> None:
        mem = np.memmap(self._mem_path(prefix), dtype=np.uint8, mode="r")
        arrays, _meta = read_sections(memoryview(mem))
        graph = np.asarray(arrays["graph"], dtype=np.int32)  # (n, deg)
        codes = np.asarray(arrays["pq_codes"])  # (n, m) u8
        n, deg = graph.shape
        m = codes.shape[1]
        rec = deg * 4 + m + deg * m
        w = write_sections_streaming(
            self._inline_path(prefix),
            {"inline_nodes": ((n, rec), "uint8")},
            meta={"deg": deg, "m": m, "count": n},
        )
        for s in range(0, n, INLINE_CHUNK):
            e = min(s + INLINE_CHUNK, n)
            g = np.ascontiguousarray(graph[s:e])
            c = e - s
            nb_codes = codes[np.clip(g, 0, n - 1)]  # (c, deg, m)
            nb_codes[g < 0] = 0
            block = np.empty((c, rec), np.uint8)
            block[:, : deg * 4] = g.view(np.uint8).reshape(c, deg * 4)
            block[:, deg * 4 : deg * 4 + m] = codes[s:e]
            block[:, deg * 4 + m :] = nb_codes.reshape(c, deg * m)
            w.write("inline_nodes", s, block)
        w.close()
        self._fm_add(self._inline_path(prefix))

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        # pq_cache_size (GB of PQ data the reference caches in RAM) funds the
        # raw-row node cache when that budget is unset: both buy "resident
        # instead of re-read"
        pq_cache = float(cfg.get("pq_cache_size", 0.0) or 0.0)
        if pq_cache > 0 and not cfg.get("search_cache_budget_gb"):
            object.__setattr__(cfg, "search_cache_budget_gb", pq_cache)
        st = super().Deserialize(binset, cfg)
        if st != Status.success:
            return st
        ipath = self._inline_path(cfg.get("index_prefix"))
        # only indexes built with inline_pq=true have the inline file; a
        # FileManager may raise on a missing one, and DISKANN's device PQ
        # walk is the fallback either way
        try:
            self._fm_load(ipath)
        except Exception:
            pass
        if cfg.get("inline_pq", True) and os.path.exists(ipath):
            mm = np.memmap(ipath, dtype=np.uint8, mode="r")
            i_arrays, i_meta = read_sections(memoryview(mm))
            self._inline_nodes = i_arrays["inline_nodes"]  # zero-copy view
            self._inline_geom = (int(i_meta["deg"]), int(i_meta["m"]))
            self._books_host = self._store["codebooks"].cpu().numpy()
            self._entry_host = self._entry.cpu().numpy().reshape(-1)
            # the all-in-storage point: no PQ codes on the device
            del self._store["codes"]
        return st

    def _score_codes(self, L_tab: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """sum_m L_tab[q, m, codes[.., m]]: (nq, *codes.shape[:-1])."""
        m = codes.shape[-1]
        flat = codes.reshape(-1, m)
        out = np.zeros((L_tab.shape[0], flat.shape[0]), np.float32)
        for j in range(m):
            out += L_tab[:, j, flat[:, j]]
        return out.reshape(L_tab.shape[0], *codes.shape[:-1])

    def _search_inline_ssd(self, xq: np.ndarray, L: int, W: int, keep_mask):
        """Host-driven AISAQ beam: a hop reads one record an expanded node,
        its adjacency and every neighbour's code, and scores them with the
        queries' ADC tables. Returns the (nq, L) candidate pool of the exact
        rerank."""
        deg, m = self._inline_geom
        books = self._books_host  # (m, ksub, sub)
        sub = books.shape[2]
        n = self._count
        nq = xq.shape[0]
        is_l2 = self._metric == M.L2
        adj_b = deg * 4

        q3 = xq.reshape(nq, m, sub)
        lutq = np.einsum("qms,mcs->qmc", q3.astype(np.float64), books.astype(np.float64)).astype(np.float32)
        L_tab = 2.0 * lutq - np.sum(books.astype(np.float64) ** 2, -1).astype(np.float32)[None] if is_l2 else lutq

        inline = self._inline_nodes
        NEG = np.float32(-np.inf)
        seeds = np.unique(self._entry_host[: max(W * 4, 16)])
        recs = np.ascontiguousarray(np.asarray(inline[seeds]))
        own = recs[:, adj_b : adj_b + m]
        s_seed = self._score_codes(L_tab, own)  # (nq, S)
        if keep_mask is not None:
            s_seed[:, ~keep_mask[seeds]] = NEG
        S = seeds.size
        cand_ids = np.full((nq, L), -1, np.int64)
        cand_s = np.full((nq, L), NEG, np.float32)
        cand_exp = np.zeros((nq, L), bool)
        w0 = min(S, L)
        cand_ids[:, :w0] = seeds[None, :w0]
        cand_s[:, :w0] = s_seed[:, :w0]

        hops = -(-L // max(W, 1)) + 4
        for _h in range(hops):
            sel_s = np.where(cand_exp | (cand_ids < 0), NEG, cand_s)
            Wc = min(W, L)
            pick = np.argpartition(-sel_s, Wc - 1, axis=1)[:, :Wc]
            pick_s = np.take_along_axis(sel_s, pick, 1)
            valid_pick = pick_s > NEG
            if not valid_pick.any():
                break
            pick_ids = np.take_along_axis(cand_ids, pick, 1)
            np.put_along_axis(cand_exp, pick, True, 1)
            safe_ids = np.where(valid_pick, pick_ids, 0)
            uniq = np.unique(safe_ids)
            recs = np.ascontiguousarray(np.asarray(inline[uniq]))  # the disk reads
            adj_u = recs[:, :adj_b].copy().view(np.int32).reshape(-1, deg)
            ncodes_u = recs[:, adj_b + m :].reshape(-1, deg, m)
            uix = np.searchsorted(uniq, safe_ids)
            nbr_ids = adj_u[uix].reshape(nq, Wc * deg).astype(np.int64)
            codes_q = ncodes_u[uix]  # (nq, Wc, deg, m)
            s_new = np.zeros((nq, Wc * deg), np.float32)
            flatc = codes_q.reshape(nq, Wc * deg, m)
            for j in range(m):
                s_new += np.take_along_axis(L_tab[:, j, :], flatc[:, :, j], axis=1)
            invalid = (nbr_ids < 0) | ~np.repeat(valid_pick, deg, axis=1)
            if keep_mask is not None:
                invalid |= ~keep_mask[np.clip(nbr_ids, 0, n - 1)]
            s_new[invalid] = NEG
            nbr_ids[invalid] = -1

            cat_i = np.concatenate([cand_ids, nbr_ids], 1)
            cat_s = np.concatenate([cand_s, s_new], 1)
            cat_e = np.concatenate([cand_exp, np.zeros_like(s_new, bool)], 1)
            order = np.argsort(cat_i, axis=1, kind="stable")
            si = np.take_along_axis(cat_i, order, 1)
            ss = np.take_along_axis(cat_s, order, 1)
            se = np.take_along_axis(cat_e, order, 1)
            dup = np.zeros_like(si, bool)
            dup[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
            ss[dup] = NEG
            top = np.argpartition(-ss, L - 1, axis=1)[:, :L]
            cand_ids = np.take_along_axis(si, top, 1)
            cand_s = np.take_along_axis(ss, top, 1)
            cand_exp = np.take_along_axis(se, top, 1)
            cand_ids = np.where(cand_s > NEG, cand_ids, -1)
        # a hop-0 break (every entry seed filtered out) leaves filtered seeds
        # with NEG scores in the pool, and the disk rerank ignores the
        # bitset: they must read as unfilled so the stranded fill runs
        return np.where(cand_s > NEG, cand_ids, -1)

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        vb = cfg.get("vectors_beamwidth")
        if vb:
            # both knobs bound a hop's reads: the tighter one holds
            object.__setattr__(cfg, "beamwidth", min(int(cfg.get("beamwidth", 8) or 8), int(vb)))
        if self._inline_nodes is None:
            return super().Search(dataset, cfg, bitset)
        with self._lock:
            if not self._loaded:
                return expected.Err(Status.empty_index, "diskann index not loaded")
            metric = normalize_metric(cfg.metric_type)
            if metric != self._metric:
                return expected.Err(Status.invalid_metric_type, "metric mismatch")
            k = cfg.k
            L = max(int(cfg.get("search_list_size") or max(k * 10, 100)), k)
            xq = self._prep_q(dataset)
            nq = xq.shape[0]
            is_l2 = self._metric == M.L2
            keep_mask = bitset.host_mask(self._count) if not bitset.empty_view() else None
            if self._dense_filter(cfg, bitset):
                dists, ids = self._brute_force_disk(xq, k, bitset)
                return expected.Ok(GenResultDataSet(nq, k, ids, dists))
            W = int(cfg.get("beamwidth") or max(1, min(8, L // 8)))
            cand = self._search_inline_ssd(xq, L, W, keep_mask)
            dists, ids = self._rerank_from_disk(xq, cand, k, is_l2)
            if keep_mask is not None:
                self._fill_stranded(xq, k, bitset, dists, ids)
            return expected.Ok(GenResultDataSet(nq, k, ids.astype(np.int64), dists))


class AisaqConfig(DiskANNConfig):
    rearrange = Entry(bool, default=False, stages=[Stage.TRAIN])
    num_entry_points = Entry(int, default=1, range=(1, 64), stages=[Stage.TRAIN])
    inline_pq = Entry(bool, default=True, stages=[Stage.TRAIN])
    pq_cache_size = Entry(float, default=0.0, range=(0.0, None), stages=[Stage.DESERIALIZE])
    pq_read_page_cache_size = Entry(float, default=0.0, range=(0.0, None), stages=[Stage.DESERIALIZE])
    vectors_beamwidth = Entry(int, default=4, range=(1, 64), stages=[Stage.SEARCH])


AisaqIndexNode.CreateConfig = staticmethod(lambda: AisaqConfig())

register_index(
    IndexEnum.INDEX_AISAQ,
    ("fp32", "fp16", "bf16", "int8"),
    feature.ALL_DENSE_FLOAT_TYPE | feature.INT8 | feature.KNN | feature.DISK | feature.LAZY_LOAD,
)(AisaqIndexNode)
