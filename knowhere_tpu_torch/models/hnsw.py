"""HNSW family: HNSW, HNSW_SQ, HNSW_PQ and HNSW_PRQ over fp32, fp16, bf16
and int8 rows, and HNSW over bin1 codes, plus the SVS LVQ and LeanVec stores
(counterpart of knowhere_tpu/models/hnsw.py, VARIANT "flat", "sq", "pq",
"prq", "lvq" and "leanvec"; models/svs.py and models/cagra.py register the
SVS, CAGRA and cuVS names on these nodes).

The level hierarchy and sequential inserts become a flat fixed-degree
diversified graph built from a batched kNN graph (ops/graph.py); search is a
batched best-first beam search with ef-wide beams. Corpora of 100,000 rows
or more (or any corpus >= 256 rows under KNOWHERE_GRAPH_INLINE=1) search
through the inline-neighborhood walk (ops/graph_inline.py: 4-bit walk codes
by default, an exact rerank of the final beam); the rest, and every index
under KNOWHERE_GRAPH_INLINE=0 ("lean mode"), through the general walk
(ops/graph.beam_search). Above KNN_EXACT_MAX_ROWS rows the build routes each
query to its nearest k-means centroids' resident nodes.

Typed corpora keep their width: a non-cosine fp16 / bf16 / int8 index
stores its raw rows (no f32 copy; fp16 goes to the device as bf16, as in
the reference), a cosine one its normalized rows in bf16; the walks widen
the rows a gather at a time. Searches score the device rows; GetVectorByIds
and CalcDistByIDs read the host rows. A bf16-held store takes the general
walk: the reference's inline build fails on it (its norms stay bf16) and
falls back there. Binary codes are unpacked to {0,1} f32 rows: HAMMING is
L2 on them, JACCARD its own score, and they never take the inline walk.
LVQ stores 1 byte a dim plus a per-row offset and scale; LeanVec walks a
PCA-reduced raw store (svs_leanvec_dim, the basis from numpy's eigh in
float64 on the host) and reranks the whole ef window at full width.

A bitset filtering out >= 90% of the rows (or >= 50% with a clustered
materialized-view hint) is answered by an exact scan, as the reference's
conditional wrapper does; filtered queries a walk leaves short are filled
the same way. Quantized variants keep a refine store (raw by default) and
re-score k * refine_k walk candidates from it. Serialize/Deserialize write
the reference's sections and meta (data_type included), so BinarySets
cross-load both ways; the inline table is rebuilt at load. GetIndexMeta and
GetFederVisit give feder's overview and a host replay of the walk.
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
from ..device import get_device, to_device
from ..factory import register_index
from ..feature import feature
from ..index_node import DEVICE_K_MAX, ExpandingIteratorGroup, IndexNode
from ..index_param import IndexEnum, metric as M, normalize_metric
from ..io.serialize import read_sections, write_sections
from ..ops import distances as D
from ..ops import graph as G
from ..ops import quant as Q
from ..ops import topk as T
from ..ops.distances import pad_rows_ladder
from ..ops.refine import RefineStore, refine_topk_device, sq8_encode
from ..status import KnowhereException, Status, expected
from ..utils import tracing
from ..utils.bf16 import as_f32, bf16_bits, rows_to_device

# Bitset density beyond which the walk strands and the reference falls back
# to an exact scan (IndexConditionalWrapper).
BRUTE_FORCE_FALLBACK_RATIO = 0.9
# the inline walk serves corpora of at least this many rows unless forced
INLINE_MIN_ROWS = 100_000
_BRUTE_QUERY_CHUNK = 4096  # queries per exact-scan step of the fallback
_TYPED = ("fp16", "bf16", "int8")  # data types whose raw rows keep their width


def _compact_ratio() -> float:
    """beam_search gather compaction (KNOWHERE_GRAPH_COMPACT, default off:
    measured negative on the reference's chip)."""
    return float(os.environ.get("KNOWHERE_GRAPH_COMPACT", "1.0"))


class BaseHnswConfig(BaseConfig):
    """reference src/index/hnsw/base_hnsw_config.h:28-58 + faiss additions."""

    M = Entry(int, default=30, range=(2, 2048), stages=[Stage.TRAIN])
    efConstruction = Entry(int, default=360, range=(1, None), stages=[Stage.TRAIN])
    ef = Entry(int, range=(1, None), stages=[Stage.SEARCH, Stage.ITERATOR, Stage.RANGE_SEARCH], allow_empty=True)
    seed_ef = Entry(int, range=(1, None), stages=[Stage.ITERATOR], allow_empty=True)
    overview_levels = Entry(int, default=3, range=(1, 5), stages=[Stage.FEDER])
    disable_fallback_brute_force = Entry(bool, default=False, stages=[Stage.SEARCH])
    refine = Entry(bool, default=False, stages=[Stage.TRAIN])
    refine_type = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    refine_k = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])


class HnswConfig(BaseHnswConfig):
    pass


class HnswSqConfig(BaseHnswConfig):
    sq_type = Entry(str, default="SQ8", stages=[Stage.TRAIN])


class HnswPqConfig(BaseHnswConfig):
    m = Entry(int, default=32, range=(1, 65536), stages=[Stage.TRAIN])
    nbits = Entry(int, default=8, range=(1, 16), stages=[Stage.TRAIN])


class HnswPrqConfig(BaseHnswConfig):
    m = Entry(int, default=2, range=(1, 65536), stages=[Stage.TRAIN])
    nrq = Entry(int, default=2, range=(1, 16), stages=[Stage.TRAIN])
    nbits = Entry(int, default=8, range=(1, 16), stages=[Stage.TRAIN])


_CONFIGS = {
    "flat": HnswConfig,
    "sq": HnswSqConfig,
    "pq": HnswPqConfig,
    "prq": HnswPrqConfig,
    "lvq": HnswSqConfig,  # SVS nodes (models/svs.py) override CreateConfig
    "leanvec": HnswConfig,
}


class HnswIndexNode(IndexNode):
    VARIANT = "flat"

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_HNSW
        self.data_type = "fp32"
        self._lock = threading.RLock()
        self._metric = M.L2
        self._dim = 0
        self._M = 30
        self._efc = 360
        self._train_cfg: Optional[Config] = None
        self._graph: Optional[np.ndarray] = None
        self._entry: Optional[np.ndarray] = None
        self._entry_cents: Optional[np.ndarray] = None  # k-means routing centroids
        self._graph_dev = None
        self._entry_dev = None
        self._entry_cents_dev = None
        self._data_dev_prebuilt = None  # the build's resident corpus (flat variant)
        self._raw_host: Optional[np.ndarray] = None  # original rows (GetVectorByIds)
        self._payload: Dict[str, np.ndarray] = {}
        self._pq: Optional[Q.PQCodec] = None
        self._prq_books: Optional[np.ndarray] = None
        self._sq: Optional[Q.SQCodec] = None
        self._refine_cfg: Optional[str] = None
        self._store: Optional[Dict[str, torch.Tensor]] = None
        self._refine_store: Optional[RefineStore] = None
        self._kind = "raw"
        self._pending: List[np.ndarray] = []
        self._inline = None  # graph_inline.InlineGraphStore
        # SVS LeanVec: the PCA basis of the reduced walk store (None otherwise)
        self._lv_proj: Optional[np.ndarray] = None  # (d, r)
        self._lv_mean: Optional[np.ndarray] = None  # (d,)

    # --- helpers ------------------------------------------------------------
    def _is_binary(self) -> bool:
        return self.data_type == "bin1"

    def _internal_metric(self) -> str:
        return M.IP if self._metric == M.COSINE else self._metric

    def _is_l2_like(self) -> bool:
        return self._internal_metric() in (M.L2, M.HAMMING)

    def _larger_is_closer(self) -> bool:
        # L2, HAMMING and JACCARD (1 - similarity) are smaller-closer
        return self._internal_metric() == M.IP

    def _native(self, x) -> np.ndarray:
        """Input rows as the index holds them: a bf16 corpus's as bit patterns."""
        x = np.asarray(x)
        return bf16_bits(x) if self.data_type == "bf16" else x

    def _prep_rows(self, x: np.ndarray) -> np.ndarray:
        """Input rows -> f32 compute rows: {0,1} planes for bin1, else the
        values (bf16 bit patterns widened), cosine-normalized."""
        if self._is_binary():
            return D.unpack_bits_host(np.asarray(x).view(np.uint8), self._dim).astype(np.float32)
        x = as_f32(x)
        if self._metric == M.COSINE:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            n[n == 0] = 1.0
            x = x / n
        return x

    # --- build --------------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        ok_metrics = (M.HAMMING, M.JACCARD) if self._is_binary() else (M.L2, M.IP, M.COSINE)
        if self._metric not in ok_metrics:
            raise KnowhereException(f"metric {self._metric} not supported by {self.Type()}", Status.invalid_metric_type)
        self._dim = dataset.dim
        self._M = int(cfg.M)
        self._efc = int(cfg.efConstruction)
        self._refine_cfg = self._refine_kind(cfg)
        self._train_cfg = cfg
        return Status.success

    @staticmethod
    def _refine_kind(cfg: Config) -> Optional[str]:
        if not cfg.get("refine", False):
            return None
        rt = (cfg.get("refine_type") or "DATA_VIEW").upper()
        if rt in ("UINT8_QUANT", "UINT8", "SQ8"):
            return "sq8"
        if rt in ("FLOAT16_QUANT", "FP16"):
            return "fp16"
        if rt in ("BFLOAT16_QUANT", "BF16"):
            return "bf16"
        return "raw"

    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        x_in = np.asarray(dataset.tensor)
        with self._lock:
            if self._graph is not None:
                # rows added after the build are staged; the next search
                # inserts them (or rebuilds on large growth)
                self._pending.append(x_in)
                return Status.success
            self._build_all(x_in)
        return Status.success

    def _build_all(self, x_in: np.ndarray) -> None:
        mark = G.phase_timer("hnsw build")
        x = self._prep_rows(x_in)
        nb = x.shape[0]
        deg = min(max(2 * self._M, 4), max(nb - 1, 1))  # level-0 degree 2*M (hnswlib maxM0_)
        inter = min(max(deg, min(self._efc // 4, 128)), max(nb - 1, 1))  # candidate pool
        # one k-means shared by the kNN-graph scan and the routed entries
        cents = assign = None
        if nb > G.KNN_EXACT_MAX_ROWS or (os.environ.get("KNOWHERE_GRAPH_INLINE") == "1" and nb >= 256):
            from ..ops.kmeans import kmeans

            nlist = 1 << int(round(np.log2(max(64, int(np.sqrt(nb))))))
            cents, assign = kmeans(x, nlist, n_iters=8)
            mark("kmeans")
        x_dev = to_device(x)  # one resident corpus for the prune, the entries and the flat store
        self._graph = G.build_graph(
            x, deg, self._internal_metric(), intermediate_deg=inter, centroids=cents, assign=assign, x_dev=x_dev,
        )
        if cents is not None:
            # per-centroid entries: each centroid's nearest resident node
            ids, _ = T.knn_search(cents, x_dev, 1, "L2", aux=D.base_aux("L2", x_dev))
            self._entry = ids.reshape(-1).astype(np.int32)
            self._entry_cents = cents.astype(np.float32)
        else:
            n_entry = int(min(max(64, nb // 500), 1024, nb))
            self._entry = G.pick_entry_points(x, n_entry=n_entry, base_dev=x_dev)
            self._entry_cents = None
        mark("entries")
        if not self._is_binary():
            self._raw_host = self._native(x_in)
        if self.VARIANT == "flat":
            # typed rows keep their width: the non-cosine payload is the raw
            # rows, the cosine one the normalized rows in bf16
            typed = self.data_type in _TYPED
            if typed and self._metric != M.COSINE:
                self._payload = {"data": self._raw_host}
            elif typed:
                self._payload = {"data": bf16_bits(x)}
            else:
                self._payload = {"data": x}
            if not typed and not self._is_binary():
                self._data_dev_prebuilt = x_dev
            if self._is_binary():
                self._payload["bits_raw"] = np.asarray(x_in)
        elif self.VARIANT == "lvq":
            # SVS LVQ: a per-row 8-bit grid over the mean-centred residual
            lvq = Q.lvq_train(x)
            codes, off, scale = Q.lvq_encode(lvq, x)
            self._payload = {"codes": codes, "lvq_mean": lvq.mean, "lvq_off": off, "lvq_scale": scale}
        elif self.VARIANT == "leanvec":
            # SVS LeanVec: the walk scores in a PCA-reduced store of
            # svs_leanvec_dim dims (default dim / 2); the graph is built at
            # full width and the refine store reranks at full width
            r = int((self._train_cfg.get("svs_leanvec_dim") if self._train_cfg else 0) or 0)
            if r <= 0 or r >= self._dim:
                r = max(1, self._dim // 2)
            mean = x.mean(0).astype(np.float32)
            xc = x - mean
            cov = (xc.T.astype(np.float64) @ xc.astype(np.float64)) / max(1, nb)
            _w, v = np.linalg.eigh(cov)
            self._lv_proj = v[:, ::-1][:, :r].astype(np.float32)  # (d, r)
            self._lv_mean = mean
            self._payload = {"data_lv": (xc @ self._lv_proj).astype(np.float32)}
        elif self.VARIANT == "sq":
            self._sq = Q.sq_train(x, (self._train_cfg.get("sq_type") if self._train_cfg else None) or "SQ8")
            if self._sq.sq_type in ("FP16", "BF16"):  # cast rows, a bf16 raw store
                self._payload = {"data": bf16_bits(x)}
            else:
                self._payload = {"codes": Q.sq_encode(self._sq, x)}
        elif self.VARIANT == "pq":
            m = self._fix_m(int(self._train_cfg.get("m") or 32))
            self._pq = Q.pq_train(x, m, self._nbits())
            self._payload = {"codes": Q.pq_encode(self._pq, x)}
        elif self.VARIANT == "prq":
            m = self._fix_m(int(self._train_cfg.get("m") or 2))
            nrq = int(self._train_cfg.get("nrq") or 2)
            self._prq_books, codes = self._train_prq(x, m, nrq, self._nbits())
            self._payload = {"codes": codes}
        if self.VARIANT != "flat" or self._refine_cfg:
            # quantized variants always keep a refine store (raw by default)
            self._add_refine_payload(x, self._refine_cfg or "raw")
        mark("codecs")
        self._upload()
        mark("upload + inline table")

    def _nbits(self) -> int:
        nbits = int(self._train_cfg.get("nbits") or 8)
        if nbits > 8:
            raise KnowhereException("PQ codes are one byte: nbits must be <= 8", Status.invalid_args)
        return nbits

    def _fix_m(self, m: int) -> int:
        while m > 1 and self._dim % m != 0:
            m -= 1
        return max(m, 1)

    def _train_prq(self, x: np.ndarray, m: int, nrq: int, nbits: int):
        """Product residual quantizer: nrq PQ stages, each on the previous
        stage's residual."""
        books = []
        codes = np.empty((x.shape[0], nrq * m), dtype=np.uint8)
        resid = x.copy()
        for s in range(nrq):
            pq = Q.pq_train(resid, m, nbits, seed=1000 + s)
            c = Q.pq_encode(pq, resid)
            codes[:, s * m : (s + 1) * m] = c
            resid = resid - Q.pq_decode(pq, c)
            books.append(pq.codebooks)
        return np.stack(books), codes

    def _add_refine_payload(self, x: np.ndarray, kind: str) -> None:
        self._refine_cfg = kind
        if kind == "raw":
            self._payload["refine"] = x.astype(np.float32)
        elif kind == "sq8":
            codes, vmin, vdiff = sq8_encode(x)
            self._payload.update(refine=codes, refine_vmin=vmin, refine_vdiff=vdiff)
        elif kind == "fp16":
            self._payload["refine"] = x.astype(np.float16)
        elif kind == "bf16":
            self._payload["refine"] = bf16_bits(x)

    def _upload(self) -> None:
        self._graph_dev = to_device(np.asarray(self._graph, np.int32))
        self._entry_dev = to_device(np.asarray(self._entry, np.int32))
        self._entry_cents_dev = None if self._entry_cents is None else to_device(self._entry_cents)
        p = self._payload
        if self.VARIANT == "flat":
            pre = self._data_dev_prebuilt
            if pre is not None and tuple(pre.shape) == p["data"].shape:
                self._store = {"data": pre}  # corpus already resident (build)
            else:
                # fp16 rows go up as bf16, as in the reference; bf16 and int8
                # rows as they are (the walks widen them a gather at a time)
                data = np.asarray(p["data"])
                self._store = {"data": rows_to_device(bf16_bits(data) if data.dtype == np.float16 else data)}
            self._data_dev_prebuilt = None
            self._kind = "raw"
        elif self.VARIANT == "lvq":
            self._store = {
                "codes": to_device(p["codes"]),
                "off": to_device(np.asarray(p["lvq_off"], np.float32)),
                "scale": to_device(np.asarray(p["lvq_scale"], np.float32)),
                "mean": to_device(np.asarray(p["lvq_mean"], np.float32)),
            }
            self._kind = "lvq"
        elif self.VARIANT == "leanvec":
            # the reduced raw walk store; queries and routing centroids are
            # projected into its frame
            self._store = {"data": to_device(np.asarray(p["data_lv"], np.float32))}
            self._kind = "raw"
            if self._entry_cents is not None:
                self._entry_cents_dev = to_device((self._entry_cents - self._lv_mean[None, :]) @ self._lv_proj)
        elif self.VARIANT == "sq":
            if "data" in p:  # FP16/BF16: bf16 raw store
                self._store = {"data": rows_to_device(np.asarray(p["data"]))}
                self._kind = "raw"
            else:
                self._store = {
                    "codes": to_device(p["codes"]),
                    "vmin": to_device(self._sq.vmin),
                    "vdiff": to_device(self._sq.vdiff),
                }
                self._kind = {"SQ8": "sq", "SQ6": "sq6", "SQ4": "sq4"}[self._sq.sq_type]
        else:  # pq / prq
            books = self._pq.codebooks if self.VARIANT == "pq" else self._prq_books
            self._store = {"codes": to_device(p["codes"]), "codebooks": to_device(np.asarray(books, np.float32))}
            self._kind = self.VARIANT
        self._refine_store = None
        if "refine" in p:
            rows = rows_to_device(np.asarray(p["refine"]))
            if self._refine_cfg == "sq8":
                self._refine_store = RefineStore("sq8", rows, to_device(p["refine_vmin"]), to_device(p["refine_vdiff"]))
            else:
                self._refine_store = RefineStore("raw", rows)
        # demote the host copies to disk-backed memmaps: the device store is
        # the search structure; the host arrays feed Serialize,
        # GetVectorByIds and incremental re-merges
        from ..utils.spill import spill_array, spill_dict

        raw = self._raw_host
        if raw is not None:
            raw_sp = spill_array(raw)
            if p.get("data") is raw:
                p["data"] = raw_sp  # keep the alias identity
            self._raw_host = raw_sp
        spill_dict(p)
        self._refresh_inline()

    def _refresh_inline(self) -> None:
        """(Re)build the inline walk's table when eligible: a raw (f32 or
        int8), SQ8, LVQ, PQ or PRQ store, routed entries, L2/IP, d % 4 == 0,
        a table within KNOWHERE_INLINE_BUDGET_GB (default 6) and >=
        INLINE_MIN_ROWS rows. KNOWHERE_GRAPH_INLINE=0 disables it, =1 forces
        it (no size floor). Binary indexes, LeanVec (a reduced walk and a
        full-width rerank) and bf16-held raw stores take the general walk, as
        in the reference (whose inline build fails on bf16 rows and falls
        back). Anything else that fails while building raises."""
        from ..ops.graph_inline import inline_row_words, make_inline_store

        self._inline = None
        mode = os.environ.get("KNOWHERE_GRAPH_INLINE", "auto")
        if mode == "0" or self._graph is None or self._is_binary() or self.VARIANT == "leanvec":
            return
        if self._kind not in ("raw", "sq", "lvq", "pq", "prq") or self._entry_cents is None:
            return
        if self._kind == "raw" and self._store["data"].dtype == torch.bfloat16:
            return
        if self._internal_metric() not in (M.L2, M.IP):
            return
        nb, deg = self._graph.shape
        if self._dim % 4 != 0 or nb >= (1 << 30):
            return
        bits = int(os.environ.get("KNOWHERE_INLINE_BITS", "4"))
        bits = bits if bits in (4, 8) else 8
        if self._dim % (32 // bits) != 0:
            bits = 8  # make_inline_store falls back too; the budget must match
        table_bytes = nb * inline_row_words(deg, self._dim, bits) * 4
        budget = float(os.environ.get("KNOWHERE_INLINE_BUDGET_GB", "6")) * (1 << 30)
        if mode != "1" and (table_bytes > budget or nb < INLINE_MIN_ROWS):
            return
        self._inline = make_inline_store(
            self._graph, self._kind, self._store,
            x_host=self._payload.get("data") if self._kind == "raw" else None, bits=bits,
        )

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        new_rows = np.concatenate(self._pending, axis=0)
        self._pending = []
        nb_old = 0 if self._graph is None else self._graph.shape[0]
        if self._graph is not None and not self._is_binary() and nb_old >= 1024 and new_rows.shape[0] <= nb_old // 5:
            # small additions insert incrementally; > 20% growth rebuilds
            self._insert_batch(new_rows)
            return
        old = self._payload["bits_raw"] if self._is_binary() else self._raw_host
        merged = np.concatenate([old, self._native(new_rows)], axis=0)
        self._graph = None
        self._build_all(merged)

    def _insert_batch(self, x_new_in: np.ndarray) -> None:
        """Incremental insert without a rebuild (the batched analog of
        hnswlib's addPoint): one batched walk over the existing graph gives
        each new node its candidates, an intra-batch kNN adds new<->new pairs,
        prune_candidates_ids picks each new node's neighbors, and the old
        nodes they point to are re-pruned over {old neighbors} + {incoming}."""
        x_new = self._prep_rows(x_new_in)
        n_new, d = x_new.shape
        nb_old, deg = self._graph.shape
        is_l2 = self._is_l2_like()
        internal = self._internal_metric()

        # 1. candidate pools from the existing graph
        efc = int(min(max(deg + 16, 64), 128, nb_old))
        n_seed = 0 if self._entry_cents_dev is None else int(min(max(8, efc // 8), 64))
        # LeanVec walks its reduced store: the new rows are projected for
        # the walk (the reference walks it with full-width rows and fails)
        x_walk = x_new if self._lv_proj is None else ((x_new - self._lv_mean[None, :]) @ self._lv_proj).astype(np.float32)
        cand_l = []
        for s0 in range(0, n_new, 4096):
            xc = x_walk[s0 : s0 + 4096]
            _, ic = G.beam_search(
                to_device(pad_rows_ladder(xc)), self._store, self._graph_dev, self._entry_dev, None,
                kind=self._kind, ef=efc, k=efc, deg=deg, max_iters=2 * efc + 32, is_l2=is_l2,
                is_jaccard=internal == M.JACCARD, beam_width=max(1, min(8, efc // 16)),
                route_cents=self._entry_cents_dev, n_seed=n_seed,
            )
            cand_l.append(ic.cpu().numpy()[: xc.shape[0]])
        cand = np.concatenate(cand_l).astype(np.int32)

        # 2. intra-batch candidates (ids offset into the combined row space)
        if n_new > 1:
            intra = G._approx_knn_graph(x_new, min(16, n_new - 1), internal)
            cand = np.concatenate([cand, np.where(intra >= 0, intra + nb_old, -1).astype(np.int32)], axis=1)

        x_all_dev = to_device(np.concatenate([self._prep_rows(self._raw_host), x_new]))

        def prune_rows(node_ids: np.ndarray, cand_ids: np.ndarray) -> np.ndarray:
            out = np.empty((node_ids.shape[0], deg), np.int32)
            for s0 in range(0, node_ids.shape[0], 2048):
                res = G.prune_candidates_ids(
                    x_all_dev, to_device(cand_ids[s0 : s0 + 2048]), to_device(node_ids[s0 : s0 + 2048]),
                    deg=deg, is_l2=internal != M.IP,
                )
                out[s0 : s0 + 2048] = res.cpu().numpy()
            return out

        # 3. the new nodes' adjacency
        new_ids = np.arange(n_new, dtype=np.int32) + nb_old
        new_adj = prune_rows(new_ids, cand)
        graph = np.concatenate([self._graph, new_adj], axis=0)

        # 4. reverse-edge repair of the touched old nodes
        src = np.repeat(new_ids, deg)
        dst = new_adj.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        if dst.size:
            R = 8  # incoming edges kept per node; the overflow drops (rare)
            order = np.argsort(dst, kind="stable")
            src, dst = src[order], dst[order]
            change = np.empty(dst.size, bool)
            change[0] = True
            change[1:] = dst[1:] != dst[:-1]
            grp_start = np.nonzero(change)[0]
            rank = np.arange(dst.size) - grp_start[np.cumsum(change) - 1]
            keep = rank < R
            src, dst, rank = src[keep], dst[keep], rank[keep]
            affected = np.unique(dst)
            inc = np.full((affected.size, R), -1, np.int32)
            inc[np.searchsorted(affected, dst), rank] = src
            graph[affected] = prune_rows(affected.astype(np.int32), np.concatenate([graph[affected], inc], axis=1))
        self._graph = graph

        # 5. storage appends, encoded with the trained codecs (reference: Add
        # encodes with the codebooks from Train)
        p = self._payload
        self._raw_host = np.concatenate([self._raw_host, self._native(x_new_in)])
        if "data" in p:  # flat rows (typed ones at their width), or SQ's FP16/BF16 rows
            app = bf16_bits(x_new) if p["data"].dtype == np.uint16 else x_new.astype(p["data"].dtype)
            p["data"] = np.concatenate([p["data"], app])
        elif self.VARIANT == "lvq":  # encoded with the trained mean
            codes_new, off_new, scale_new = Q.lvq_encode(Q.LVQCodec(mean=np.asarray(p["lvq_mean"])), x_new)
            p["codes"] = np.concatenate([p["codes"], codes_new])
            p["lvq_off"] = np.concatenate([p["lvq_off"], off_new])
            p["lvq_scale"] = np.concatenate([p["lvq_scale"], scale_new])
        elif self.VARIANT == "leanvec":  # projected on the trained basis
            p["data_lv"] = np.concatenate(
                [p["data_lv"], ((x_new - self._lv_mean[None, :]) @ self._lv_proj).astype(np.float32)]
            )
        elif self.VARIANT == "sq":
            p["codes"] = np.concatenate([p["codes"], Q.sq_encode(self._sq, x_new)])
        elif self.VARIANT == "pq":
            p["codes"] = np.concatenate([p["codes"], Q.pq_encode(self._pq, x_new)])
        elif self.VARIANT == "prq":
            books = self._prq_books  # (nrq, m, ksub, sub)
            nrq, m, ksub, _ = books.shape
            nbits = int(round(np.log2(ksub)))
            resid = x_new.copy()
            codes_new = np.empty((n_new, nrq * m), np.uint8)
            for s in range(nrq):
                pq = Q.PQCodec(codebooks=books[s], m=m, nbits=nbits)
                c = Q.pq_encode(pq, resid)
                codes_new[:, s * m : (s + 1) * m] = c
                resid = resid - Q.pq_decode(pq, c)
            p["codes"] = np.concatenate([p["codes"], codes_new])
        if "refine" in p:
            kind = self._refine_cfg or "raw"
            if kind == "sq8":
                sq = Q.SQCodec("SQ8", p["refine_vmin"], p["refine_vdiff"], dim=d)
                app = Q.sq_encode(sq, x_new)
            elif kind == "bf16":
                app = bf16_bits(x_new)
            else:
                app = x_new.astype(np.asarray(p["refine"]).dtype)
            p["refine"] = np.concatenate([p["refine"], app])
        self._upload()

    # --- search --------------------------------------------------------------
    def _effective_ef(self, cfg: Config, k: int) -> int:
        ef = cfg.get("ef")
        if ef is None:
            ef = max(k, 16)  # the reference defaults ef from k
        return int(max(ef, k))

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        with self._lock:
            self._flush_pending()
            if self._graph is None:
                return expected.Err(Status.empty_index, "index not built")
            metric = normalize_metric(cfg.metric_type)
            if metric != self._metric:
                return expected.Err(
                    Status.invalid_metric_type, f"index built with {self._metric}, searched with {metric}"
                )
            k = cfg.k
            ef = self._effective_ef(cfg, k)
            with tracing.span("hnsw.prep"):
                xq = self._prep_rows(np.asarray(dataset.tensor))
                nq = xq.shape[0]
                # dense filter: exact scan (reference conditional wrapper); a
                # pure-AND materialized-view hint over few categories means a
                # clustered filter, where walks strand earlier
                ratio = bitset.filter_ratio() if not bitset.empty_view() else 0.0
                threshold = BRUTE_FORCE_FALLBACK_RATIO
                mv = cfg.get("materialized_view_search_info")
                if isinstance(mv, dict):
                    touched = mv.get("field_id_to_touched_categories_cnt", {})
                    few_categories = touched and max(touched.values()) <= 2
                    if mv.get("is_pure_and", False) and not mv.get("has_not", False) and few_categories:
                        threshold = min(threshold, 0.5)
                fallback = ratio >= threshold and not cfg.get("disable_fallback_brute_force", False)
                if not fallback:
                    q_pad_dev = dataset.cached_device(
                        f"hnsw_qpad:{self._metric}:{self.data_type}:{get_device()}",
                        lambda: to_device(pad_rows_ladder(xq)),
                    )
            if fallback:
                dists, ids = self._brute_force(xq, k, bitset)
            else:
                dists, ids = self._graph_search(
                    xq, k, ef, bitset, refine_k=int(cfg.get("refine_k", 1) or 1), q_pad_dev=q_pad_dev
                )
                # under a filter the walk may strand some queries: fill them exactly
                if not bitset.empty_view():
                    want = min(k, self.Count() - bitset.count())
                    unfilled = (ids >= 0).sum(1) < want
                    if unfilled.any():
                        dists[unfilled], ids[unfilled] = self._brute_force(xq[unfilled], k, bitset)
            with tracing.span("hnsw.result"):
                return expected.Ok(GenResultDataSet(nq, k, ids, dists))

    def _query_chunks(self, xq: np.ndarray, chunk: int, q_pad_dev):
        """Device query blocks of one walk: the cached padded upload when all
        queries fit one block, else blocks of `chunk` rows (the last one
        zero-padded), as the reference blocks them."""
        nq, d = xq.shape
        for s0 in range(0, nq, chunk):
            xc = xq[s0 : s0 + chunk]
            if s0 == 0 and nq <= chunk and q_pad_dev is not None:
                yield xc.shape[0], q_pad_dev
            elif nq <= chunk:
                yield xc.shape[0], to_device(pad_rows_ladder(xc))
            else:
                yield xc.shape[0], to_device(np.pad(xc, ((0, chunk - xc.shape[0]), (0, 0))))

    def _finish(self, xq, scores, ids, k: int, refine_k: int, is_l2: bool):
        """Walk scores / candidates -> (dists native convention, ids int64):
        the refine store re-scores the k * refine_k candidates (at full width
        for LeanVec: ``xq`` is always the full-width query), else the scores
        convert (|q|^2 - score for L2 and HAMMING, 1 - score for JACCARD)."""
        if self._refine_store is not None:
            with tracing.span("hnsw.refine"):
                dd, ii = refine_topk_device(
                    to_device(xq), self._refine_store, to_device(np.ascontiguousarray(ids, dtype=np.int32)), k, is_l2
                )
                with tracing.span("hnsw.readback", wait=True):
                    dists, ids = dd.cpu().numpy(), ii.cpu().numpy()
        with tracing.span("hnsw.result"):
            if self._refine_store is None:
                scores, ids = scores[:, :k], ids[:, :k]
                if self._internal_metric() == M.JACCARD:
                    dists = 1.0 - scores
                elif is_l2:
                    qsq = np.sum(xq.astype(np.float64) ** 2, axis=1).astype(np.float32)
                    dists = qsq[:, None] - scores
                else:
                    dists = scores
            dists = np.where(ids < 0, np.float32(np.inf if is_l2 else -np.inf), dists)
            return dists, ids.astype(np.int64)

    def _graph_search(self, xq, k, ef, bitset: BitsetView, refine_k: int = 1, q_pad_dev=None):
        if self._inline is not None:
            return self._graph_search_inline(xq, k, ef, bitset, refine_k, q_pad_dev=q_pad_dev)
        from ..comp import check_current_cancellation

        xq_full = xq
        if self._lv_proj is not None:
            # LeanVec: the walk scores in the reduced frame; the refine
            # reranks the whole window with the full-width queries
            xq = ((xq - self._lv_mean[None, :]) @ self._lv_proj).astype(np.float32)
            q_pad_dev = None  # the cached upload is full width
        nq, d = xq.shape
        is_l2 = self._is_l2_like()
        keep = bitset.device_mask(self.Count()) if not bitset.empty_view() else None
        k_out = k if self._refine_store is None else max(k, k * max(refine_k, 1))
        k_out = ef if self._lv_proj is not None else min(k_out, ef)
        deg = self._graph.shape[1]
        # beam width W = ef // 8 (<= 8): fewer sequential steps, W times the
        # work per step
        W = max(1, min(8, ef // 8))
        max_iters = (2 * ef) // W + 32
        chunk = 16384  # each step's neighbor gather stays under ~512 MB
        while chunk > 256 and chunk * W * deg * d * 4 > (1 << 29):
            chunk //= 2
        n_seed = 0 if self._entry_cents_dev is None else int(min(max(8, ef // 8), 64))
        scores_l, ids_l = [], []
        for n_real, qc_dev in self._query_chunks(xq, chunk, q_pad_dev):
            check_current_cancellation()
            sc, ic = G.beam_search(
                qc_dev, self._store, self._graph_dev, self._entry_dev, keep,
                kind=self._kind, ef=ef, k=k_out, deg=deg, max_iters=max_iters, is_l2=is_l2,
                is_jaccard=self._internal_metric() == M.JACCARD, has_mask=keep is not None, beam_width=W,
                route_cents=self._entry_cents_dev, n_seed=n_seed,
                compact_ratio=_compact_ratio() if W > 1 else 1.0,
            )
            scores_l.append(sc[:n_real])
            ids_l.append(ic[:n_real])
        with tracing.span("hnsw.readback", wait=True):
            scores = torch.cat(scores_l).cpu().numpy()
            ids = torch.cat(ids_l).cpu().numpy()
        return self._finish(xq_full, scores, ids, k, refine_k, is_l2)

    def _graph_search_inline(self, xq, k, ef, bitset: BitsetView, refine_k: int = 1, q_pad_dev=None):
        """The inline walk; its scores are exact under the stored values (the
        built-in rerank), so the distances convert as on the general path."""
        from ..ops.graph_inline import beam_search_inline

        inline = self._inline
        nq, d = xq.shape
        is_l2 = self._internal_metric() == M.L2
        keep = bitset.device_mask(self.Count()) if not bitset.empty_view() else None
        k_out = k if self._refine_store is None else max(k, k * max(refine_k, 1))
        k_out = min(k_out, ef)
        deg = inline.deg
        # KNOWHERE_INLINE_W sets the beam width (the reference's knob for A/Bs)
        W = int(os.environ.get("KNOWHERE_INLINE_W", "0")) or max(1, min(8, ef // 8))
        n_steps = ef // W + 6
        n_seed = int(min(max(8, ef // 8), 64, ef))
        ring_slots = max(1, 256 // (W * deg))
        # bound the per-step (nq, W*deg, d) candidates and the final rerank's
        # (nq, ef, d) rows
        chunk = 16384
        while chunk > 256 and (chunk * W * deg * d * 2 > (3 << 28) or chunk * ef * d * 4 > (1 << 29)):
            chunk //= 2
        scores_l, ids_l = [], []
        for n_real, qc_dev in self._query_chunks(xq, chunk, q_pad_dev):
            rs, ri = beam_search_inline(
                inline.table, qc_dev, inline.rerank0, inline.rerank1, inline.rerank2,
                self._entry_dev, self._entry_cents_dev, inline.vmin, inline.vdiff, keep,
                W=W, ef=ef, deg=deg, n_steps=n_steps, ring_slots=ring_slots, n_seed=n_seed, k=k_out,
                is_l2=is_l2, has_mask=keep is not None, rerank_kind=inline.rerank_kind, bits=inline.bits,
            )
            scores_l.append(rs[:n_real])
            ids_l.append(ri[:n_real])
        with tracing.span("hnsw.readback", wait=True):
            scores = torch.cat(scores_l).cpu().numpy()
            ids = torch.cat(ids_l).cpu().numpy()
        return self._finish(xq, scores, ids, k, refine_k, is_l2)

    def _brute_force(self, xq, k, bitset: BitsetView):
        """Exact scan of the stored rows (raw store, else the raw refine
        store, else the decoded codes; LeanVec's raw store is reduced, so its
        refine store), honouring the bitset. HAMMING scans as L2 over the
        {0,1} rows, as in the reference."""
        metric = self._internal_metric()
        if metric == M.HAMMING:
            metric = M.L2
        if self._kind == "raw" and self._lv_proj is None:
            data = self._store["data"]
        elif self._refine_store is not None and self._refine_store.kind == "raw":
            data = self._refine_store.data
        else:
            data = to_device(self._decode_all())
        mask = bitset.device_mask(self.Count()) if not bitset.empty_view() else None
        aux = D.base_aux(metric, data)
        d_parts, i_parts = [], []
        with tracing.span("hnsw.brute_force"):
            for s0 in range(0, xq.shape[0], _BRUTE_QUERY_CHUNK):
                dd, ii = T.knn_device(to_device(xq[s0 : s0 + _BRUTE_QUERY_CHUNK]), data, k, metric, aux=aux, mask=mask)
                with tracing.span("hnsw.readback", wait=True):
                    d_parts.append(dd.cpu().numpy())
                    i_parts.append(ii.cpu().numpy().astype(np.int64))
        return np.concatenate(d_parts), np.concatenate(i_parts)

    def _decode_all(self) -> np.ndarray:
        """Every stored row as f32 on the host (full width)."""
        p = self._payload
        if self.VARIANT == "flat":
            return as_f32(p["data"])
        if "refine" in p:  # every refine kind is full width and decodable
            ref = np.asarray(p["refine"])
            if self._refine_cfg == "sq8":
                return Q.sq_decode(torch.from_numpy(ref), torch.from_numpy(np.asarray(p["refine_vmin"])),
                                   torch.from_numpy(np.asarray(p["refine_vdiff"])), 256).numpy()
            return as_f32(ref)
        if self.VARIANT == "sq":
            if "data" in p:
                return as_f32(p["data"])
            sq = self._sq
            return Q.sq_decode(torch.from_numpy(np.asarray(p["codes"])), torch.from_numpy(sq.vmin),
                               torch.from_numpy(sq.vdiff), sq.levels, sq.sq_type == "SQ4", self._dim).numpy()
        if self.VARIANT == "pq":
            return Q.pq_decode(self._pq, np.asarray(p["codes"]))
        if self.VARIANT == "lvq":
            return Q.lvq_decode(np.asarray(p["codes"]), np.asarray(p["lvq_off"]), np.asarray(p["lvq_scale"]),
                                np.asarray(p["lvq_mean"]))
        raise KnowhereException("cannot decode", Status.internal_error)

    # --- full-coverage scan (iterator / range-search completion) --------------
    def _full_sorted(self, xq: np.ndarray, bitset: BitsetView):
        """Exact scan over the stored rows on the host in f64: (dists, ids),
        each (nq, n_valid), best first in the native convention. A walk
        cannot promise full coverage; the iterator contract needs it."""
        data = self._decode_all().astype(np.float64)
        nq, nb = xq.shape[0], data.shape[0]
        larger = self._larger_is_closer()
        keep = bitset.host_mask(self.Count()) if not bitset.empty_view() else None
        dists = np.empty((nq, nb), np.float32)
        q64 = xq.astype(np.float64)
        for s in range(0, nb, 65536):
            blk = data[s : s + 65536]
            dots = q64 @ blk.T
            if self._internal_metric() == M.JACCARD:
                union = q64.sum(1)[:, None] + blk.sum(1)[None, :] - dots
                dd = 1.0 - dots / np.maximum(union, 1e-12)
            elif self._is_l2_like():
                dd = (q64**2).sum(1)[:, None] - 2 * dots + (blk**2).sum(1)[None, :]
            else:
                dd = dots
            dists[:, s : s + 65536] = dd.astype(np.float32)
        if keep is not None:
            dists[:, ~keep[:nb]] = np.float32(-np.inf if larger else np.inf)
            n_valid = int(keep[:nb].sum())
        else:
            n_valid = nb
        order = np.argsort(-dists if larger else dists, axis=1, kind="stable")[:, :n_valid]
        return np.take_along_axis(dists, order, 1), order.astype(np.int64)

    # --- range search / iterator ------------------------------------------------
    def RangeSearch(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        """Walks with k widening x4 until the frontier leaves the radius, then
        the radius filter; queries whose results may still grow are completed
        by the covering full scan."""
        with self._lock:
            self._flush_pending()
            if self._graph is None:
                return expected.Err(Status.empty_index, "index not built")
            xq = self._prep_rows(np.asarray(dataset.tensor))
            nq = xq.shape[0]
            radius = cfg.get("radius", 0.0)
            range_filter = cfg.get("range_filter", float("inf"))
            two_sided = np.isfinite(range_filter)
            larger = self._larger_is_closer()
            ef = self._effective_ef(cfg, 64)
            n_valid = self.Count() - (bitset.count() if not bitset.empty_view() else 0)
            cap = min(n_valid, DEVICE_K_MAX)
            k_cur = min(max(ef, 64), max(cap, 1))
            while True:
                dists, ids = self._graph_search(xq, k_cur, max(k_cur, ef), bitset)
                if k_cur >= cap:
                    break
                frontier = dists[:, -1]
                still = (frontier > radius) if larger else (frontier < radius)
                if not (still & (ids[:, -1] >= 0)).any():
                    break
                k_cur = min(cap, k_cur * 4)
            returned = (ids >= 0).sum(axis=1)
            frontier = dists[:, -1]
            frontier_in = (frontier > radius) if larger else (frontier < radius)
            needy = (returned < n_valid) & (frontier_in | (ids[:, -1] < 0))
            if needy.any():
                act = np.nonzero(needy)[0]
                pad = n_valid - dists.shape[1]
                if pad > 0:
                    worst = np.float32(-np.inf if larger else np.inf)
                    dists = np.pad(dists, ((0, 0), (0, pad)), constant_values=worst)
                    ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
                for s in range(0, len(act), 64):  # bounds host memory
                    sub = act[s : s + 64]
                    dists[sub], ids[sub] = self._full_sorted(xq[sub], bitset)
            lims = np.zeros(nq + 1, dtype=np.int64)
            out_i, out_d = [], []
            rsk = cfg.get("range_search_k", -1)
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
                if rsk is not None and rsk >= 0:
                    sel = sel[:rsk]
                out_i.append(ids[i, sel])
                out_d.append(dists[i, sel])
                lims[i + 1] = lims[i] + len(sel)
            ids_cat = np.concatenate(out_i) if out_i else np.empty(0, np.int64)
            d_cat = np.concatenate(out_d) if out_d else np.empty(0, np.float32)
            return expected.Ok(GenRangeResultDataSet(nq, ids_cat, d_cat, lims))

    def AnnIterator(
        self, dataset: DataSet, cfg: Config, bitset: BitsetView, use_knowhere_search_pool=True
    ) -> "expected[List]":
        """Resumable rounds (the reference's FaissHnswIterator resumes the
        walk): ef and k widen x4 a round; the covering last round is the
        exact scan of the stored rows."""
        with self._lock:
            self._flush_pending()
            if self._graph is None:
                return expected.Err(Status.empty_index, "index not built")
            xq = self._prep_rows(np.asarray(dataset.tensor))
            nq = xq.shape[0]
            seed_ef = int(cfg.get("seed_ef") or cfg.get("ef") or 64)
            count = self.Count()
            k0 = min(count, max(seed_ef * 4, 1024))
            covered = {"done": False}

            def round_fn(r: int):
                if covered["done"]:
                    return None
                k_r = min(count, k0 << (2 * r))
                with self._lock:
                    if k_r >= count or k_r > DEVICE_K_MAX:
                        covered["done"] = True
                        d_f, i_f = self._full_sorted(xq, bitset)
                        return i_f, d_f
                    dists, ids = self._graph_search(xq, k_r, max(k_r, seed_ef), bitset)
                return ids, dists

            group = ExpandingIteratorGroup(nq, count, round_fn)
            larger = self._larger_is_closer()
            return expected.Ok([group.make_iterator(i, larger_is_closer=larger) for i in range(nq)])

    # --- vectors ---------------------------------------------------------------
    def GetVectorByIds(self, dataset: DataSet) -> "expected[DataSet]":
        if not self.HasRawData(self._metric):
            return expected.Err(Status.not_implemented, "no raw data stored")
        with self._lock:
            self._flush_pending()
            ids = np.asarray(dataset.ids, dtype=np.int64)
            if ids.min(initial=0) < 0 or ids.max(initial=-1) >= self.Count():
                return expected.Err(Status.invalid_args, "id out of range")
            rows = self._payload["bits_raw"] if self._is_binary() else self._raw_host
            return expected.Ok(GenTensorDataSet(np.asarray(rows[ids]), len(ids), self._dim))

    def IsAdditionalScalarSupported(self, is_mv_only: bool = False) -> bool:
        return True  # consumes materialized_view_search_info (earlier fallback)

    def CalcDistByIDs(self, query_ds, bitset, ids, rows) -> "expected[np.ndarray]":
        xq = self._prep_rows(np.asarray(query_ds.tensor))
        ids = np.asarray(ids)
        sub = self._prep_rows(self._raw_host[ids]) if self._raw_host is not None else self._decode_all()[ids]
        metric = self._internal_metric()
        s_dev = to_device(np.asarray(sub, np.float32))
        return expected.Ok(D.pairwise_distance(metric, to_device(xq), s_dev, D.base_aux(metric, s_dev)).cpu().numpy())

    def HasRawData(self, metric_type: str = "L2") -> bool:
        # flat HNSW keeps raw rows; quantized variants only through a raw refine
        return self.VARIANT == "flat" or self._refine_cfg == "raw"

    # --- feder -----------------------------------------------------------------
    def GetIndexMeta(self, cfg: Config) -> "expected[DataSet]":
        """feder's overview of the graph (reference feder/HNSW.h HNSWMeta)."""
        from ..feder import hnsw_overview

        if self._graph is None:
            return expected.Err(Status.empty_index, "index not built")
        overview = hnsw_overview(self._graph, self._entry, int(cfg.get("overview_levels", 3) or 3))
        overview.update({"metric_type": self._metric, "M": self._M, "dim": self._dim, "count": self.Count()})
        ds = DataSet()
        ds.set("json_info", json.dumps(overview))
        return expected.Ok(ds)

    def GetFederVisit(self, dataset: DataSet, cfg: Config) -> "expected[DataSet]":
        """trace_visit: each query's walk replayed on the host over the
        stored rows, its visits in order (reference feder FederResult)."""
        from ..feder import instrumented_walk

        if self._graph is None:
            return expected.Err(Status.empty_index, "index not built")
        xq = self._prep_rows(np.asarray(dataset.tensor))
        ef = self._effective_ef(cfg, cfg.get("k", 10) or 10)
        x_host = self._decode_all()
        traces = [instrumented_walk(x_host, self._graph, self._entry, q, ef, is_l2=self._is_l2_like()) for q in xq]
        ds = DataSet()
        ds.set("json_id_set", json.dumps(traces))
        return expected.Ok(ds)

    # --- serialization -----------------------------------------------------------
    def Serialize(self, binset: BinarySet) -> Status:
        with self._lock:
            self._flush_pending()
            if self._graph is None:
                return Status.empty_index
            arrays = {"graph": self._graph, "entry": self._entry}
            if self._entry_cents is not None:
                arrays["entry_cents"] = self._entry_cents
            payload_is_raw = self._payload.get("data") is self._raw_host
            for k_, v in self._payload.items():
                if payload_is_raw and k_ == "data":
                    continue  # the payload is the raw rows: written once
                arrays["payload_" + k_] = np.asarray(v)
            if self._raw_host is not None:
                arrays["raw"] = np.asarray(self._raw_host)
            meta = {
                "variant": self.VARIANT,
                "metric": self._metric,
                "dim": self._dim,
                "M": self._M,
                "data_type": self.data_type,
                "refine_cfg": self._refine_cfg,
                "payload_is_raw": payload_is_raw,
            }
            if self._sq is not None:
                meta["sq_type"] = self._sq.sq_type
                if self._sq.vmin is not None:  # FP16/BF16 codecs carry no grid
                    arrays["sq_vmin"] = self._sq.vmin
                    arrays["sq_vdiff"] = self._sq.vdiff
            if self._pq is not None:
                arrays["pq_codebooks"] = self._pq.codebooks
                meta["pq_nbits"] = self._pq.nbits
            if self._prq_books is not None:
                arrays["prq_codebooks"] = self._prq_books
            if self._lv_proj is not None:
                arrays["lv_proj"] = self._lv_proj
                arrays["lv_mean"] = self._lv_mean
            bf16 = tuple(k_ for k_, v in arrays.items() if v.dtype == np.uint16)
            binset.Append(self.Type(), write_sections(arrays, meta=meta, bf16=bf16))
            return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        if meta.get("variant") != self.VARIANT:
            return Status.invalid_serialized_index_type
        with self._lock:
            self.data_type = meta.get("data_type", "fp32")
            self._metric = meta["metric"]
            self._dim = int(meta["dim"])
            self._M = int(meta["M"])
            self._refine_cfg = meta.get("refine_cfg")
            self._graph = np.asarray(arrays["graph"], dtype=np.int32)
            self._entry = np.asarray(arrays["entry"], dtype=np.int32)
            self._entry_cents = np.asarray(arrays["entry_cents"], np.float32) if "entry_cents" in arrays else None
            self._raw_host = np.asarray(arrays["raw"]) if "raw" in arrays else None
            self._payload = {k_[len("payload_"):]: np.asarray(v) for k_, v in arrays.items() if k_.startswith("payload_")}
            if meta.get("payload_is_raw") and self._raw_host is not None:
                self._payload["data"] = self._raw_host
            if "sq_type" in meta:
                self._sq = Q.SQCodec(
                    meta["sq_type"],
                    np.asarray(arrays["sq_vmin"]) if "sq_vmin" in arrays else None,
                    np.asarray(arrays["sq_vdiff"]) if "sq_vdiff" in arrays else None,
                    dim=self._dim,
                )
            if "pq_codebooks" in arrays:
                books = np.asarray(arrays["pq_codebooks"], np.float32)
                self._pq = Q.PQCodec(books, books.shape[0], int(meta.get("pq_nbits", 8)))
            if "prq_codebooks" in arrays:
                self._prq_books = np.asarray(arrays["prq_codebooks"], np.float32)
            if "lv_proj" in arrays:
                self._lv_proj = np.asarray(arrays["lv_proj"], np.float32)
                self._lv_mean = np.asarray(arrays["lv_mean"], np.float32)
            self._upload()
        return Status.success

    # --- introspection ---------------------------------------------------------------
    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        total = 0 if self._graph is None else self._graph.nbytes
        return total + sum(np.asarray(v).nbytes for v in self._payload.values())

    def Count(self) -> int:
        base = 0 if self._graph is None else self._graph.shape[0]
        return base + sum(p.shape[0] for p in self._pending)

    def Type(self) -> str:
        return self.index_type

    @classmethod
    def CreateConfig(cls) -> Config:
        return _CONFIGS[cls.VARIANT]()


class HnswFlatNode(HnswIndexNode):
    VARIANT = "flat"


class HnswSqNode(HnswIndexNode):
    VARIANT = "sq"


class HnswPqNode(HnswIndexNode):
    VARIANT = "pq"


class HnswPrqNode(HnswIndexNode):
    VARIANT = "prq"


_F = feature
_DENSE = ("fp32",) + _TYPED
# the reference's feature bits, EMB_LIST aside (the emb_list facade is not
# ported)
register_index(
    IndexEnum.INDEX_HNSW,
    _DENSE + ("bin1",),
    _F.ALL_DENSE_TYPE | _F.BINARY | _F.KNN | _F.MMAP | _F.MV | _F.EMB_LIST,
)(HnswFlatNode)
register_index(IndexEnum.INDEX_HNSW_SQ, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.MMAP)(HnswSqNode)
register_index(IndexEnum.INDEX_HNSW_PQ, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.MMAP)(HnswPqNode)
register_index(IndexEnum.INDEX_HNSW_PRQ, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.MMAP)(HnswPrqNode)
