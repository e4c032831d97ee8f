"""IVF_FLAT (counterpart of knowhere_tpu/models/ivf.py, VARIANT="flat").

Train runs k-means for the coarse quantizer (nlist auto-shrinks as in the
reference, MatchNlist); Add sorts the rows by list into one contiguous store,
each list padded to LIST_ALIGN rows when the corpus is large enough, so every
scan block is one aligned slice. Search probes the nearest lists, builds the
(list block x query group) tasks, scans them and merges per query:

- EXACT precision (the default): the full-f32 plain task scan.
- FAST/BF16 with the int8 sidecar (aligned store, d % 128 == 0): the int8
  scan kernel ranks a widened pool (max(4k, 48)), then an exact f32 rerank
  over the raw rows returns the final distances.
- FAST/BF16 without the sidecar (KNOWHERE_DISABLE_INT8_SCAN=1): the f32 scan
  kernel (3-pass-class f32 for FAST; bf16 plus exact rerank for BF16).

The other IVF families, CC appends, RangeSearch, iterators, GetVectorByIds
and the ensure_topk_full widening come with later slices of the port and
report Status.not_implemented.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import BaseConfig, Config, Entry, Stage
from ..dataset import DataSet, GenResultDataSet
from ..device import get_device, to_device
from ..factory import register_index
from ..feature import feature
from ..index_param import IndexEnum, metric as M, normalize_metric
from ..index_node import IndexNode
from ..io.serialize import read_sections, write_sections
from ..ops.distances import DistancePrecision, get_distance_precision, pad_rows_ladder
from ..ops.ivf_cuda import LIST_ALIGN
from ..ops.ivf_scan import coarse_probe, coarse_probe_host, ivf_scan_search
from ..ops.kmeans import assign_rows, kmeans
from ..ops.refine import refine_topk_device
from ..status import KnowhereException, Status, expected
from ..utils.logging import log_warning

MIN_POINTS_PER_CENTROID = 39  # reference ivf.cc:478
B_SLACK = 2048  # zero rows after the store: a block slice never runs off its end


def match_nlist(rows: int, nlist: int) -> int:
    """nlist auto-shrink (reference MatchNlist, ivf.cc:476-487)."""
    if nlist * MIN_POINTS_PER_CENTROID > rows:
        new = max(1, rows // MIN_POINTS_PER_CENTROID)
        log_warning(f"nlist({nlist}) is too large, adjust to {new}")
        return new
    return nlist


class IvfConfig(BaseConfig):
    nlist = Entry(int, default=128, range=(1, 65536), stages=[Stage.TRAIN])
    nprobe = Entry(int, default=8, range=(1, 65536), stages=[Stage.SEARCH, Stage.ITERATOR, Stage.RANGE_SEARCH])
    use_elkan = Entry(bool, default=True, stages=[Stage.TRAIN])
    ensure_topk_full = Entry(bool, default=True, stages=[Stage.SEARCH])
    max_empty_result_buckets = Entry(int, default=2, range=(0, 65536), stages=[Stage.RANGE_SEARCH])


class IvfFlatConfig(IvfConfig):
    pass


class IvfIndexNode(IndexNode):
    VARIANT = "flat"

    def __init__(self, version: int, object=None):  # noqa: A002
        super().__init__(version, object)
        self.index_type = IndexEnum.INDEX_FAISS_IVFFLAT
        self.data_type = "fp32"
        self._trained = False
        self._metric = M.L2
        self._dim = 0
        self._d_dev = 0  # device feature width (zero-padded to a 128 multiple)
        self._nlist = 0
        self._centroids: Optional[np.ndarray] = None
        self._norms_raw: Optional[np.ndarray] = None  # cosine restore norms
        self._row_ids: Optional[np.ndarray] = None  # padded sorted pos -> row id (-1 pad)
        self._offsets: Optional[np.ndarray] = None  # (nlist+1,) padded storage starts
        self._lengths: Optional[np.ndarray] = None  # (nlist,) TRUE list lengths
        self._count = 0
        self._sorted_payload = {}
        self._store = None  # device tensors
        self._assign_cache = None

    # --- helpers ---------------------------------------------------------
    def _internal_metric(self) -> str:
        return M.IP if self._metric == M.COSINE else self._metric  # cosine = normalize + IP

    def _is_l2_like(self) -> bool:
        return self._internal_metric() == M.L2

    def _prep_rows(self, x: np.ndarray) -> np.ndarray:
        """Raw input rows -> f32 compute rows (cosine-normalized)."""
        x = np.asarray(x).astype(np.float32)
        if self._metric == M.COSINE:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            n[n == 0] = 1.0
            x = x / n
        return x

    # --- Train ---------------------------------------------------------------
    def Train(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        if self._metric not in (M.L2, M.IP, M.COSINE):
            raise KnowhereException(
                f"metric {self._metric} not supported by {self.Type()}",
                Status.invalid_metric_type,
            )
        rows = dataset.rows
        self._dim = dataset.dim
        x = self._prep_rows(np.asarray(dataset.tensor))
        self._nlist = match_nlist(rows, int(cfg.nlist))
        centroids, assign_full = kmeans(x, self._nlist, n_iters=12, seed=1234)
        self._centroids = centroids
        # Build = Train + Add on the same rows reuses the assignment
        self._assign_cache = (rows, float(x[:: max(rows // 7, 1), 0].sum()), assign_full)
        self._trained = True
        return Status.success

    # --- Add -------------------------------------------------------------------
    def Add(self, dataset: DataSet, cfg: Config) -> Status:
        if not self._trained:
            return Status.index_not_trained
        if self._row_ids is not None:
            raise NotImplementedError("Add after build (CC appends) is not ported yet")
        self._build_storage(np.asarray(dataset.tensor))
        return Status.success

    def _build_storage(self, x_in: np.ndarray) -> None:
        x = self._prep_rows(x_in)
        nb = x.shape[0]
        cache = self._assign_cache
        if cache is not None and cache[0] == nb and cache[1] == float(x[:: max(nb // 7, 1), 0].sum()):
            assign = cache[2]
        else:
            assign = assign_rows(x, self._centroids)
        self._assign_cache = None
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=self._nlist).astype(np.int64)
        self._count = nb
        self._lengths = counts
        # large corpora: each list padded to a LIST_ALIGN multiple, so every
        # scan block is one aligned slice (the scan kernels need it)
        align_min = int(os.environ.get("KNOWHERE_IVF_ALIGN_MIN", 32768))
        pad_counts = (counts + LIST_ALIGN - 1) // LIST_ALIGN * LIST_ALIGN if nb >= align_min else counts
        self._offsets = np.zeros(self._nlist + 1, dtype=np.int64)
        np.cumsum(pad_counts, out=self._offsets[1:])
        nb_pad = int(self._offsets[-1])
        true_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        dst = np.arange(nb, dtype=np.int64) + np.repeat(self._offsets[:-1] - true_starts, counts)
        self._row_ids = np.full(nb_pad, -1, dtype=np.int64)
        self._row_ids[dst] = order

        if self._metric != M.COSINE:
            raw_sorted = np.asarray(x_in).astype(np.float32)[order]
        else:
            raw_sorted = x[order]
            self._norms_raw = np.linalg.norm(np.asarray(x_in, dtype=np.float32), axis=1).astype(np.float32)
        if nb_pad != nb:
            data = np.zeros((nb_pad, raw_sorted.shape[1]), np.float32)
            data[dst] = raw_sorted
        else:
            data = raw_sorted
        self._sorted_payload = {"data": data}
        self._upload()

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Install the state an IVF_FLAT node serializes (the arrays and meta
        of knowhere_tpu's IvfIndexNode.Serialize) and upload it."""
        if meta.get("variant") != self.VARIANT:
            raise KnowhereException(
                f"blob holds IVF variant {meta.get('variant')!r}", Status.invalid_serialized_index_type
            )
        if meta.get("refine_cfg"):
            raise NotImplementedError("IVF refine stores are not ported yet")
        self._metric = meta["metric"]
        self._dim = int(meta["dim"])
        self._nlist = int(meta["nlist"])
        self.data_type = meta.get("data_type", "fp32")
        self._centroids = np.asarray(arrays["centroids"], dtype=np.float32)
        self._row_ids = np.asarray(arrays["row_ids"], dtype=np.int64)
        self._offsets = np.asarray(arrays["offsets"], dtype=np.int64)
        valid = self._row_ids >= 0
        self._count = int(valid.sum())
        if "lengths" in arrays:
            self._lengths = np.asarray(arrays["lengths"], dtype=np.int64)
        else:  # pre-alignment blob: storage was compact
            csum = np.concatenate([[0], np.cumsum(valid)])
            self._lengths = (csum[self._offsets[1:]] - csum[self._offsets[:-1]]).astype(np.int64)
        self._norms_raw = np.asarray(arrays["norms_raw"]) if "norms_raw" in arrays else None
        self._sorted_payload = {
            k_[len("payload_"):]: np.asarray(v) for k_, v in arrays.items() if k_.startswith("payload_")
        }
        if self._sorted_payload["data"].dtype != np.float32:
            raise NotImplementedError("typed (fp16/bf16/int8) IVF stores are not ported yet")
        self._trained = True
        self._upload()

    def _upload(self) -> None:
        """Host payloads -> device store, with B_SLACK zero rows at the end and
        features zero-padded to a 128 multiple when d > 64 (leaves L2/IP
        unchanged and lets the scan kernels take the store)."""
        d = self._dim
        self._d_dev = -(-d // 128) * 128 if d > 64 and d % 128 != 0 else d
        dcol = self._d_dev - d
        data = self._sorted_payload["data"]
        nb_rows = data.shape[0]
        buf = np.zeros((nb_rows + B_SLACK, self._d_dev), np.float32)
        buf[:nb_rows, :d] = data
        norms = np.zeros(nb_rows + B_SLACK, np.float32)
        norms[:nb_rows] = np.einsum("ij,ij->i", data, data, dtype=np.float64)
        self._store = {
            "data": to_device(buf),
            "norms": to_device(norms),
            "centroids": to_device(np.pad(self._centroids, ((0, 0), (0, dcol)))),
            "offsets_dev": to_device(np.asarray(self._offsets, dtype=np.int32)),
            "lens_dev": to_device(np.asarray(self._lengths, dtype=np.int32)),
        }
        self._build_int8_sidecar(data, dcol)

    def _build_int8_sidecar(self, data: np.ndarray, dcol: int) -> None:
        """int8 scan sidecar for the raw f32 store: per-dim symmetric codes
        (centred for L2) and exact centred norms. Derived, never serialized,
        and rebuilt bit-identically to the reference (multiply by the f32
        reciprocal, np.rint)."""
        if os.environ.get("KNOWHERE_DISABLE_INT8_SCAN") == "1":
            return
        offs = self._offsets
        if offs is None or int(offs[-1]) == 0 or not (offs % LIST_ALIGN == 0).all() or self._d_dev % 128 != 0:
            return
        nb_pad = int(offs[-1])
        x = data[:nb_pad]
        d = x.shape[1]
        n_true = int(np.asarray(self._lengths).sum())
        ch = max(1, (256 << 20) // max(d * 4, 1))
        if self._is_l2_like() and n_true > 0:
            acc = np.zeros(d, np.float64)
            for i0 in range(0, nb_pad, ch):  # pad rows are zeros
                acc += np.asarray(x[i0 : i0 + ch], np.float32).sum(0, dtype=np.float64)
            mu = (acc / n_true).astype(np.float32)
        else:
            mu = np.zeros(d, np.float32)
        amax = np.zeros(d, np.float32)
        for i0 in range(0, nb_pad, ch):
            c = np.asarray(x[i0 : i0 + ch], np.float32) - mu
            np.abs(c, out=c)
            np.maximum(amax, c.max(0), out=amax)
        s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
        inv = (1.0 / s).astype(np.float32)
        codes = np.zeros((nb_pad + B_SLACK, self._d_dev), np.int8)
        nrm = np.empty(nb_pad, np.float32)
        for i0 in range(0, nb_pad, ch):
            i1 = min(i0 + ch, nb_pad)
            c = np.asarray(x[i0:i1], np.float32) - mu
            nrm[i0:i1] = np.einsum("ij,ij->i", c, c, dtype=np.float64)
            c *= inv
            np.rint(c, out=c)
            np.clip(c, -127, 127, out=c)
            codes[i0:i1, :d] = c.astype(np.int8)
        self._store["data_i8"] = to_device(codes)
        self._store["i8_nrm"] = to_device(nrm)
        self._store["i8_scale"] = to_device(np.pad(s, (0, dcol)))
        self._store["i8_mu"] = to_device(np.pad(mu, (0, dcol)))

    # --- Search ---------------------------------------------------------------
    def _pad_q_host(self, xq: np.ndarray) -> np.ndarray:
        """Row ladder + feature zero-padding to the device width."""
        q = pad_rows_ladder(xq)
        if q.shape[1] != self._d_dev:
            q = np.pad(q, ((0, 0), (0, self._d_dev - q.shape[1])))
        return q

    def _keep_sorted_mask(self, bitset: BitsetView) -> Optional[torch.Tensor]:
        if bitset.empty_view():
            return None
        keep = bitset.host_mask(self.Count())
        rid = self._row_ids
        keep_sorted = np.zeros(len(rid) + B_SLACK, dtype=bool)
        valid = rid >= 0
        keep_sorted[: len(rid)][valid] = keep[rid[valid]]
        return to_device(keep_sorted)

    def _scan_plan(self, k: int):
        """(scan precision, two_stage, k_scan) from the precision mode."""
        gp = get_distance_precision()
        nb = len(self._row_ids)
        if gp == DistancePrecision.EXACT:
            return "exact", False, k
        scan_prec = "bf16" if gp == DistancePrecision.BF16 else "fast"
        two_stage = gp == DistancePrecision.BF16
        k_scan = min(max(4 * k, 32), max(nb, 1)) if two_stage else k
        if "data_i8" in self._store:
            # int8 candidates, re-ranked exactly from the raw store
            return "int8", True, min(max(4 * k, 48), max(nb, 1))
        return scan_prec, two_stage, k_scan

    def _kernel_eligible(self, k_scan: int, scan_prec: str) -> bool:
        """Whether the scan takes a kernel path (the reference's fused path):
        the probe then stays on the device."""
        from ..ops.ivf_scan import int8_available, scan_available

        if scan_prec == "int8":
            return int8_available(self._store, self._d_dev, k_scan, self._offsets)
        return scan_available(self._d_dev, k_scan, self._offsets, scan_prec)

    def _search_batch(
        self, xq: np.ndarray, k: int, nprobe: int, keep_sorted, n_valid: int,
        ensure_topk_full: bool, q_pad_dev: torch.Tensor,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (nq,k) native convention, ids (nq,k) original rows)."""
        from ..comp import check_current_cancellation

        check_current_cancellation()
        nq = xq.shape[0]
        is_l2 = self._is_l2_like()
        nb = len(self._row_ids)
        scan_prec, two_stage, k_scan = self._scan_plan(k)
        nprobe_cur = min(max(1, nprobe), self._nlist)
        nq_pad = q_pad_dev.shape[0]
        if nprobe_cur >= self._nlist:
            probes = None  # full probe: the deterministic full-scan layout
        elif self._kernel_eligible(k_scan, scan_prec) or nq * self._nlist * max(self._dim, 1) > 1 << 24:
            probes = coarse_probe(q_pad_dev, self._store["centroids"], nprobe=nprobe_cur, is_l2=is_l2)
            # padded query rows would probe real lists: mask them out
            row = torch.arange(nq_pad, device=probes.device)[:, None]
            probes = torch.where(row < nq, probes, torch.full_like(probes, -1))
        else:
            probes = coarse_probe_host(xq, self._centroids, nprobe_cur, is_l2)
            probes = np.concatenate([probes, np.full((nq_pad - nq, probes.shape[1]), -1, np.int32)])
        s, p = ivf_scan_search(
            q_pad_dev, self._store, probes, self._offsets, k_scan, is_l2,
            keep_sorted=keep_sorted, prec=scan_prec, list_lengths=self._lengths,
        )
        mode = "score"
        if two_stage:
            s, p = refine_topk_device(q_pad_dev, self._store["data"], p, k, is_l2)
            mode = "dist"
        best_s = s[:nq].cpu().numpy()
        best_p = p[:nq].cpu().numpy().astype(np.int64)

        if ensure_topk_full and nprobe_cur < self._nlist:
            want = min(best_p.shape[1], n_valid)
            if ((best_p >= 0).sum(axis=1) < want).any():
                raise NotImplementedError("ensure_topk_full widening is not ported yet")

        if mode == "dist":
            dists = best_s
        elif is_l2:
            qsq = np.sum(xq.astype(np.float64) ** 2, axis=1).astype(np.float32)
            dists = qsq[:, None] - best_s
        else:
            dists = best_s
        dists = np.where(best_p >= 0, dists, np.float32(np.inf if is_l2 else -np.inf))
        k_cut = min(k, dists.shape[1])
        dists, best_p = dists[:, :k_cut], best_p[:, :k_cut]
        if k_cut < k:  # tiny index: fewer candidates than k
            fillv = np.float32(np.inf if is_l2 else -np.inf)
            dists = np.pad(dists, ((0, 0), (0, k - k_cut)), constant_values=fillv)
            best_p = np.pad(best_p, ((0, 0), (0, k - k_cut)), constant_values=-1)
        ids = np.where(best_p >= 0, self._row_ids[np.clip(best_p, 0, nb - 1)], -1)
        return dists, ids

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        if self._row_ids is None:
            return expected.Err(Status.empty_index, "index not built")
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(
                Status.invalid_metric_type, f"index built with {self._metric}, searched with {metric}"
            )
        xq = self._prep_rows(np.asarray(dataset.tensor))
        n_valid = self.Count() - (bitset.count() if not bitset.empty_view() else 0)
        q_pad_dev = dataset.cached_device(
            f"ivf_qpad:{self._metric}:{self._d_dev}:{get_device()}",
            lambda: to_device(self._pad_q_host(xq)),
        )
        dists, ids = self._search_batch(
            xq, cfg.k, int(cfg.get("nprobe", 8)), self._keep_sorted_mask(bitset), n_valid,
            bool(cfg.get("ensure_topk_full", True)), q_pad_dev,
        )
        return expected.Ok(GenResultDataSet(dataset.rows, cfg.k, ids, dists))

    @staticmethod
    def HasRawData(metric_type: str = "L2") -> bool:
        return True

    # --- serialization ------------------------------------------------------------------
    def Serialize(self, binset: BinarySet) -> Status:
        if self._row_ids is None:
            return Status.empty_index
        arrays = {
            "centroids": self._centroids,
            "row_ids": self._row_ids,
            "offsets": self._offsets,
            "lengths": self._lengths,
        }
        for k_, v in self._sorted_payload.items():
            arrays["payload_" + k_] = np.asarray(v)
        if self._norms_raw is not None:
            arrays["norms_raw"] = self._norms_raw
        meta = {
            "variant": self.VARIANT,
            "metric": self._metric,
            "dim": self._dim,
            "nlist": self._nlist,
            "data_type": self.data_type,
            "refine_cfg": None,
        }
        binset.Append(self.Type(), write_sections(arrays, meta=meta))
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        binary = binset.GetByName(self.Type())
        if binary is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(binary.data)
        if meta.get("variant") != self.VARIANT:
            return Status.invalid_serialized_index_type
        self.load_state(arrays, meta)
        return Status.success

    # --- introspection ---------------------------------------------------------------------
    def Dim(self) -> int:
        return self._dim

    def Size(self) -> int:
        return sum(np.asarray(v).nbytes for v in self._sorted_payload.values()) + (
            self._centroids.nbytes if self._centroids is not None else 0
        )

    def Count(self) -> int:
        return 0 if self._row_ids is None else self._count

    def Type(self) -> str:
        return self.index_type

    @classmethod
    def CreateConfig(cls) -> Config:
        return IvfFlatConfig()


class IvfFlatNode(IvfIndexNode):
    VARIANT = "flat"


register_index(
    IndexEnum.INDEX_FAISS_IVFFLAT, ("fp32",), feature.FLOAT32 | feature.KNN | feature.MMAP,
)(IvfFlatNode)
