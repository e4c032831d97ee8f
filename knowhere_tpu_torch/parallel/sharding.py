"""The sharding layer: one logical index whose rows are spread over a list of
devices (counterpart of knowhere_tpu/parallel/sharding.py).

The reference runs one process over a list of devices (a ``jax.sharding``
mesh) and keeps its collectives in-process. The port does the same over a
list of ``torch.device``; repeats are allowed, so ``[cuda:0] * 4`` puts four
shards on one card:

- search: each shard's exact (nq, kk) top-k, moved to the first device,
  concatenated in shard order, then ``topk_leftmost``: shard order and the
  leftmost tie rule give the lower global id on ties, as ``lax.top_k`` over
  the reference's all_gather'ed columns does;
- k-means: each shard's partial sums and counts, added on the first device
  in shard order (the reference's psum);
- IVF and graph indexes: each shard's top-k merged on the host with the
  reference's ``np.argsort(..., kind="stable")``.

Each shard's work runs inside ``device.scoped_device``, so the modules that
place tensors on the port's device (k-means, the scans, the graph build and
walks, refine) put that shard's on its own device. The shards run one after
another.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import get_device, scoped_device, to_device
from ..ops import distances as D
from ..ops import graph_inline as GI
from ..ops import topk as T
from ..ops.kmeans import assign_device, cluster_sums
from ..ops.topk import topk_leftmost

NEG_INF = -float("inf")
# queries a search block takes on one shard: its (nq, rows) scores stay
# under this many bytes
SCORE_BLOCK_BYTES = 1 << 31
# the per-shard inline walk serves shards of at least this many rows unless
# forced (the single-device HNSW node's floor)
INLINE_MIN_ROWS = 100_000
LIST_PAD = 2048  # zero rows after each shard's IVF storage, as the reference


def default_devices() -> List[torch.device]:
    """Every visible CUDA device while the port's device is CUDA, else the
    port's device. With CUDA selected and none visible this raises: nothing
    falls back to the CPU."""
    dev = get_device()
    if dev.type != "cuda":
        return [dev]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("the port's device is CUDA and no CUDA device is visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_devices(devices=None) -> List[torch.device]:
    """The device list a sharded index spreads over (the counterpart of
    make_mesh): ``devices`` as torch devices, or default_devices()."""
    devs = default_devices() if devices is None else [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded index needs at least one device")
    return devs


def _put(a, dev: torch.device) -> torch.Tensor:
    with scoped_device(dev):
        return to_device(a)


def shard_rows(devices: List[torch.device], x: np.ndarray) -> List[torch.Tensor]:
    """A (rows, ...) host array as one contiguous block of rows a device.
    Rows are padded to a multiple of the device count with zero rows;
    callers track true counts."""
    n = len(devices)
    pad = (-x.shape[0]) % n
    if pad:
        x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)
    per = x.shape[0] // n
    return [_put(x[i * per : (i + 1) * per], dev) for i, dev in enumerate(devices)]


def replicate(devices: List[torch.device], x) -> List[torch.Tensor]:
    """One copy of ``x`` a device."""
    return [_put(x, dev) for dev in devices]


# ---------------------------------------------------------------------------
# Sharded search: per-shard top-k, merged on the first device
# ---------------------------------------------------------------------------


def sharded_search(
    devices: List[torch.device],
    queries,
    base: List[torch.Tensor],
    k: int,
    metric_name: str,
    aux: Optional[List[torch.Tensor]] = None,
    mask: Optional[List[torch.Tensor]] = None,
    valid_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact search of (nq, d) queries over row-sharded ``base`` (one block a
    device, shard_rows) -> (dists (nq, k), ids (nq, k)) on the first device.

    ids are GLOBAL row indices; ``valid_rows`` masks out the padding rows of
    shard_rows and ``mask`` (one bool block a shard) the filtered rows;
    -1 where the score is -inf."""
    metric_name = metric_name.upper()
    nb_per = base[0].shape[0]
    sign = 1.0 if D.larger_is_better(metric_name) else -1.0
    kk = min(k, nb_per)
    nq = queries.shape[0]
    step = max(1, SCORE_BLOCK_BYTES // max(nb_per * 4, 1))
    parts_s, parts_i = [], []
    for si, dev in enumerate(devices):
        row0 = si * nb_per
        with scoped_device(dev):
            q = to_device(queries)
            s_blocks, i_blocks = [], []
            for q0 in range(0, nq, step):
                score = D.pairwise_distance(metric_name, q[q0 : q0 + step], base[si], aux[si] if aux else None) * sign
                if valid_rows is not None and row0 + nb_per > valid_rows:
                    score[:, max(valid_rows - row0, 0) :] = NEG_INF
                if mask is not None:
                    score = score.masked_fill(~mask[si][None, :], NEG_INF)
                s, idx = topk_leftmost(score, kk)
                s_blocks.append(s)
                i_blocks.append(idx + row0)
        parts_s.append(torch.cat(s_blocks).to(devices[0]))
        parts_i.append(torch.cat(i_blocks).to(devices[0]))
    all_s, all_i = torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1)
    best_s, sel = topk_leftmost(all_s, k)
    best_i = torch.gather(all_i, 1, sel)
    best_i = torch.where(best_s == NEG_INF, torch.full_like(best_i, -1), best_i)
    if best_s.shape[1] < k:  # fewer rows than k
        best_s = torch.nn.functional.pad(best_s, (0, k - best_s.shape[1]), value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, (0, k - best_i.shape[1]), value=-1)
    return best_s * sign, best_i


# ---------------------------------------------------------------------------
# Data-parallel k-means step (Lloyd): partial sums added on the first device
# ---------------------------------------------------------------------------


def sharded_kmeans_step(devices: List[torch.device], base: List[torch.Tensor], centroids) -> torch.Tensor:
    """One Lloyd iteration over row-sharded ``base`` from ``centroids`` (one
    array, or replicate's copies): the new (k, d) f32 centroids on the
    first device. Each shard assigns its rows (the first of equal minima)
    and sums them by cluster in row order (kmeans.cluster_sums); the
    shards' sums and counts add in shard order. A cluster without rows
    keeps its centroid."""
    replicated = isinstance(centroids, (list, tuple))  # one copy a device (replicate)
    first = centroids[0] if replicated else centroids
    k = first.shape[0]
    sums = counts = None
    for si, dev in enumerate(devices):
        with scoped_device(dev):
            c = to_device(centroids[si] if replicated else centroids).float()
            x = base[si].float()
            assign = assign_device(x, c).long()
            part_s = cluster_sums(x, assign, k).to(devices[0])
            part_n = torch.bincount(assign, minlength=k).float().to(devices[0])
        sums = part_s if sums is None else sums + part_s
        counts = part_n if counts is None else counts + part_n
    c32 = _put(first, devices[0]).float()
    new_c = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts == 0)[:, None], c32, new_c)


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on a host subsample of k * 64 rows (the reference's
    draws, in its order)."""
    sample = x[rng.choice(x.shape[0], size=min(x.shape[0], k * 64), replace=False)]
    centers = [sample[rng.integers(sample.shape[0])]]
    d2 = ((sample - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        nxt = sample[rng.choice(sample.shape[0], p=probs)]
        centers.append(nxt)
        d2 = np.minimum(d2, ((sample - nxt) ** 2).sum(1))
    return np.stack(centers).astype(np.float32)


def sharded_kmeans(
    devices: List[torch.device], x: np.ndarray, k: int, n_iters: int = 12, seed: int = 1234
) -> np.ndarray:
    """Data-parallel k-means over the devices from a k-means++ init: (k, d)
    f32 centroids. As in the reference, the zero rows that pad x to a
    multiple of the device count take part in the steps."""
    rng = np.random.default_rng(seed)
    init = _kmeanspp_init(np.asarray(x, dtype=np.float32), k, rng)
    base = shard_rows(devices, np.asarray(x))
    cents = _put(init, devices[0])
    for _ in range(n_iters):
        cents = sharded_kmeans_step(devices, base, cents)
    return cents.cpu().numpy()


class ShardedFlatIndex:
    """A logical FLAT index over row-sharded devices: exact search, one
    top-k a shard, merged on the first device."""

    def __init__(self, devices: List[torch.device], metric: str = "L2"):
        self.devices = make_devices(devices)
        self.metric = metric.upper()
        self._base: Optional[List[torch.Tensor]] = None
        self._aux = None
        self._rows = 0

    def build(self, xb: np.ndarray) -> None:
        self._rows = xb.shape[0]
        self._base = shard_rows(self.devices, np.asarray(xb))
        self._aux = None
        if self.metric != "IP":
            self._aux = []
            for b, dev in zip(self._base, self.devices):
                with scoped_device(dev):
                    self._aux.append(D.base_aux(self.metric, b))

    def search(self, xq: np.ndarray, k: int, bitset_keep: Optional[np.ndarray] = None):
        """(dists (nq, k) f32, ids (nq, k) int64), numpy."""
        mask = None
        if bitset_keep is not None:
            total = self._base[0].shape[0] * len(self.devices)
            keep = np.zeros(total, bool)
            keep[: len(bitset_keep)] = bitset_keep
            mask = shard_rows(self.devices, keep)
        dists, ids = sharded_search(
            self.devices, np.asarray(xq), self._base, k, self.metric,
            aux=self._aux, mask=mask, valid_rows=self._rows,
        )
        return dists.cpu().numpy(), ids.cpu().numpy().astype(np.int64)


class ShardedGraphIndex:
    """A logical graph (HNSW-family) index: contiguous row shards, each with
    its own flat diversified graph (ops/graph.build_graph) on one device of
    the list; a search walks every shard (the inline walk where a shard is
    eligible) and merges the per-shard top-k on the host."""

    def __init__(self, devices=None, metric: str = "L2"):
        self.devices = make_devices(devices)
        self.metric = metric.upper()
        self._shards = []  # a shard: dict(device, store, graph, entry, row0, rows, deg[, inline...])
        self._rows = 0
        self._xb = None  # host rows (serialization, GetVectorByIds)
        self._host_graphs = []  # a shard: dict(graph, entry, row0, rows, deg)

    def build(self, xb: np.ndarray, M: int = 16, ef_construction: int = 200) -> None:
        from ..ops.graph import build_graph, pick_entry_points

        xb = np.asarray(xb, dtype=np.float32)
        self._rows = xb.shape[0]
        self._xb = xb
        n = len(self.devices)
        bounds = np.linspace(0, self._rows, n + 1).astype(np.int64)
        deg = max(2 * M, 4)
        self._host_graphs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            lo, hi = int(lo), int(hi)
            x_local = xb[lo:hi]
            if x_local.shape[0] == 0:
                continue
            deg_l = min(deg, max(x_local.shape[0] - 1, 1))
            inter = min(max(deg_l, min(ef_construction // 4, 128)), max(x_local.shape[0] - 1, 1))
            with scoped_device(self.devices[len(self._host_graphs) % n]):
                graph = build_graph(x_local, deg_l, self.metric, intermediate_deg=inter)
                entry = pick_entry_points(x_local, n_entry=min(64, x_local.shape[0]))
            self._host_graphs.append(
                {"graph": graph, "entry": entry.astype(np.int32), "row0": lo, "rows": x_local.shape[0], "deg": deg_l}
            )
        self._distribute()

    def _distribute(self) -> None:
        """Place the shards' graphs on the device list, round robin (a load
        onto fewer devices stacks shards a device, onto more leaves some
        idle); runs at build and after deserialize. A shard of at least
        INLINE_MIN_ROWS rows with d % 4 == 0 gets the inline walk
        (KNOWHERE_GRAPH_INLINE=1 forces it, =0 disables it) at
        KNOWHERE_INLINE_BITS (default 8) within KNOWHERE_INLINE_BUDGET_GB
        (default 6) a shard; a failing inline build raises."""
        from ..ops import kmeans as K

        xb = self._xb
        d = xb.shape[1]
        self._shards = []
        inline_mode = os.environ.get("KNOWHERE_GRAPH_INLINE", "auto")
        for si, hg in enumerate(self._host_graphs):
            dev = self.devices[si % len(self.devices)]
            lo, rows, deg_l = hg["row0"], hg["rows"], hg["deg"]
            x_local = xb[lo : lo + rows]
            with scoped_device(dev):
                sh = {
                    "device": dev, "store": {"data": to_device(x_local)}, "graph": to_device(hg["graph"]),
                    "entry": to_device(hg["entry"]), "row0": lo, "rows": rows, "deg": deg_l,
                }
                use_inline = inline_mode != "0" and d % 4 == 0 and (inline_mode == "1" or rows >= INLINE_MIN_ROWS)
                if use_inline:
                    budget = float(os.environ.get("KNOWHERE_INLINE_BUDGET_GB", "6")) * (1 << 30)
                    bits = int(os.environ.get("KNOWHERE_INLINE_BITS", "8"))
                    bits = bits if bits in (4, 8) else 8
                    if d % (32 // bits) != 0:
                        bits = 8  # make_inline_store falls back too; the budget must match
                    tbytes = rows * GI.inline_row_words(deg_l, d, bits) * 4
                    if inline_mode == "1" or tbytes <= budget:
                        inline = GI.make_inline_store(hg["graph"], "raw", sh["store"], x_host=x_local, bits=bits)
                        if inline is not None:
                            cents, _ = K.kmeans(x_local, min(64, max(8, rows // 32)), n_iters=6)
                            data = sh["store"]["data"]
                            eids, _ = T.knn_search(cents, data, 1, "L2", aux=D.base_aux("L2", data))
                            sh["inline"] = inline
                            sh["inline_entry"] = to_device(eids.reshape(-1).astype(np.int32))
                            sh["inline_cents"] = to_device(cents.astype(np.float32))
            self._shards.append(sh)

    def search(self, xq: np.ndarray, k: int, ef: Optional[int] = None, bitset_keep: Optional[np.ndarray] = None):
        """(dists (nq, k) f32, ids (nq, k) int64), numpy."""
        from ..ops.graph import beam_search

        xq = np.asarray(xq, dtype=np.float32)
        nq = xq.shape[0]
        ef = max(ef or max(k, 32), k)
        is_l2 = self.metric == "L2"
        partials = []
        for sh in self._shards:
            ef_l = min(ef, sh["rows"])
            with scoped_device(sh["device"]):
                q_dev = to_device(xq)
                keep_l = None
                if bitset_keep is not None:
                    keep_l = to_device(np.asarray(bitset_keep[sh["row0"] : sh["row0"] + sh["rows"]]))
                if "inline" in sh:
                    inline = sh["inline"]
                    W = max(1, min(8, ef_l // 8))
                    n_seed = int(min(max(8, ef_l // 8), 64, ef_l, sh["inline_entry"].shape[0]))
                    s, ids = GI.beam_search_inline(
                        inline.table, q_dev, inline.rerank0, inline.rerank1, inline.rerank2,
                        sh["inline_entry"], sh["inline_cents"], inline.vmin, inline.vdiff, keep_l,
                        W=W, ef=ef_l, deg=sh["deg"], n_steps=ef_l // W + 6,
                        ring_slots=max(1, 256 // (W * sh["deg"])), n_seed=n_seed, k=min(k, sh["rows"]),
                        is_l2=is_l2, has_mask=keep_l is not None, rerank_kind="raw", bits=inline.bits,
                    )
                else:
                    s, ids = beam_search(
                        q_dev, sh["store"], sh["graph"], sh["entry"], keep_l,
                        kind="raw", ef=ef_l, k=min(k, sh["rows"]), deg=sh["deg"],
                        max_iters=2 * ef_l + 32, is_l2=is_l2, has_mask=keep_l is not None,
                    )
            partials.append((s.cpu().numpy(), ids.cpu().numpy(), sh["row0"]))
        # host merge of the per-shard top-k (ids -> global rows)
        cat_s = np.concatenate([s for s, _, _ in partials], axis=1)
        cat_i = np.concatenate([np.where(i >= 0, i.astype(np.int64) + r0, -1) for _, i, r0 in partials], axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, order, 1)
        best_i = np.take_along_axis(cat_i, order, 1)
        if is_l2:
            qsq = np.sum(xq.astype(np.float64) ** 2, 1).astype(np.float32)
            dists = np.where(best_i >= 0, qsq[:, None] - best_s, np.inf)
        else:
            dists = np.where(best_i >= 0, best_s, -np.inf)
        if best_i.shape[1] < k:
            padw = k - best_i.shape[1]
            dists = np.pad(dists, ((0, 0), (0, padw)), constant_values=np.inf if is_l2 else -np.inf)
            best_i = np.pad(best_i, ((0, 0), (0, padw)), constant_values=-1)
        return dists[:nq], best_i[:nq]


class ShardedIVFIndex:
    """A logical IVF index whose inverted lists are spread over the devices:
    global centroids and codecs, lists packed biggest first onto the
    lightest device, a search's probes computed once on the host against
    the global centroids, each device's lists scanned by ops/ivf_scan
    (the plain scan: the per-shard offsets are not LIST_ALIGN multiples and
    the stores carry no kernel sidecars, as in the reference), and the
    per-device top-k merged on the host."""

    def __init__(self, devices=None, metric: str = "L2"):
        self.devices = make_devices(devices)
        self.metric = metric.upper()
        self._centroids = None
        self._shards = []  # a device: dict(device, store, offsets, row_ids, global_to_local)
        self._nlist = 0
        self._rows = 0
        self._kind = "raw"
        self._sq_levels = 0
        self._variant = "flat"
        self._assign = None  # (rows,) int32 global list of each row (host)
        self._payload = None  # (rows, .) raw f32 / SQ u8 / PQ codes (host, global row order)
        self._refine_payload = None

    def build(
        self,
        xb: np.ndarray,
        nlist: int = 1024,
        n_iters: int = 12,
        variant: str = "flat",  # flat | sq8 | pq
        m: int = 16,
        nbits: int = 8,
        refine: bool = False,
    ) -> None:
        from ..ops import quant as Q
        from ..ops.kmeans import kmeans

        xb = np.asarray(xb, dtype=np.float32)
        self._rows = xb.shape[0]
        self._nlist = min(nlist, max(1, self._rows // 39))
        with scoped_device(self.devices[0]):
            centroids, assign = kmeans(xb, self._nlist, n_iters=n_iters)
            self._centroids = centroids
            # fp16 refine rows in global row order, sliced a shard at
            # distribute time; refine_type is not read (always FP16)
            self._refine_payload = xb.astype(np.float16) if (refine and variant == "pq") else None
            # one codec for the logical index, so a query's scores mean the
            # same on every shard; the payload is encoded once in global
            # row order so that a load re-distributes it
            self._variant = variant
            if variant == "pq":
                resid = xb - centroids[assign]
                self._pq = Q.pq_train(resid, m, nbits)
                self._kind = "pq"
                payload = Q.pq_encode(self._pq, resid)
                del resid
            elif variant == "sq8":
                self._sq = Q.sq_train(xb, "SQ8")
                self._kind = "sq"
                self._sq_levels = self._sq.levels
                payload = Q.sq_encode(self._sq, xb)
            else:
                self._kind = "raw"
                payload = xb
        self._assign = assign.astype(np.int32)
        self._payload = payload
        self._distribute()

    def _distribute(self) -> None:
        """Place the logical index (global payload and list assignment) on the
        device list: the biggest list first onto the lightest device. Runs at
        build and after deserialize, so a BinarySet re-shards onto the
        loader's devices (onto the reference's owners for the same count)."""
        assign = self._assign
        payload = self._payload
        counts = np.bincount(assign, minlength=self._nlist)
        order = np.argsort(-counts)
        loads = np.zeros(len(self.devices), dtype=np.int64)
        owner = np.zeros(self._nlist, dtype=np.int32)
        for li in order:
            dev = int(np.argmin(loads))
            owner[li] = dev
            loads[dev] += counts[li]
        row_owner = owner[assign]

        self._shards = []
        for di, dev in enumerate(self.devices):
            local_lists = np.nonzero(owner == di)[0]
            rows_idx = np.nonzero(row_owner == di)[0]
            global_to_local = np.full(self._nlist, -1, np.int32)
            global_to_local[local_lists] = np.arange(len(local_lists), dtype=np.int32)
            a_remap = global_to_local[assign[rows_idx]].astype(np.int64)
            rows_sorted = rows_idx[np.argsort(a_remap, kind="stable")]
            offsets = np.zeros(len(local_lists) + 1, np.int64)
            np.cumsum(np.bincount(a_remap, minlength=len(local_lists)), out=offsets[1:])
            codes = payload[rows_sorted]
            with scoped_device(dev):
                store = {"centroids": to_device(self._centroids[local_lists])}  # local list id -> centroid
                if self._kind == "pq":
                    store["codes"] = to_device(_pad_rows(codes))
                    store["codebooks"] = to_device(self._pq.codebooks)
                    if self._refine_payload is not None:
                        store["refine"] = to_device(_pad_rows(self._refine_payload[rows_sorted]))
                elif self._kind == "sq":
                    store["codes"] = to_device(_pad_rows(codes))
                    store["vmin"] = to_device(self._sq.vmin)
                    store["vdiff"] = to_device(self._sq.vdiff)
                else:
                    norms = np.sum(codes.astype(np.float64) ** 2, 1).astype(np.float32)
                    store["data"] = to_device(_pad_rows(codes))
                    store["norms"] = to_device(_pad_rows(norms))
            self._shards.append({
                "device": dev, "store": store, "offsets": offsets,
                "row_ids": rows_sorted.astype(np.int64), "global_to_local": global_to_local,
            })

    def search(
        self,
        xq: np.ndarray,
        k: int,
        nprobe: int = 8,
        bitset_keep: Optional[np.ndarray] = None,
        refine_k: int = 1,
    ):
        """(dists (nq, k) f32, ids (nq, k) int64), numpy."""
        from ..ops.ivf_scan import coarse_probe_host, ivf_scan_search
        from ..ops.refine import RefineStore, refine_topk_device

        xq = np.asarray(xq, dtype=np.float32)
        is_l2 = self.metric == "L2"
        qsq = np.sum(xq.astype(np.float64) ** 2, 1).astype(np.float32)
        # the probe runs against the GLOBAL centroids (a shard's store holds
        # its lists' centroids for the decode)
        probes = coarse_probe_host(xq, self._centroids, min(nprobe, self._nlist), is_l2)
        partials = []
        for sh in self._shards:
            local = sh["global_to_local"][probes]  # -1 where the list is not here
            if (local < 0).all():
                continue
            row_ids = sh["row_ids"]
            n_rows = max(len(row_ids), 1)
            has_refine = "refine" in sh["store"]
            k_local = min(k, n_rows)
            k_scan = min(max(k_local, k_local * max(refine_k, 1), 32), n_rows) if has_refine else k_local
            with scoped_device(sh["device"]):
                q_dev = to_device(xq)
                keep_sorted = None
                if bitset_keep is not None:
                    # the bitset is in global row order, the scan reads this
                    # shard's list-sorted rows (and LIST_PAD masked pad rows)
                    keep_sorted = to_device(np.concatenate([bitset_keep[row_ids], np.zeros(LIST_PAD, bool)]))
                s, p = ivf_scan_search(
                    q_dev, sh["store"], local, sh["offsets"], k_scan, is_l2,
                    keep_sorted=keep_sorted, sq_levels=self._sq_levels,
                )
                if has_refine:
                    # exact re-rank of the pool on this shard's fp16 rows
                    d_r, p = refine_topk_device(q_dev, RefineStore("raw", sh["store"]["refine"]), p, k_local, is_l2)
                    s = -d_r if is_l2 else d_r  # back to larger-is-better
            s, p = s.cpu().numpy(), p.cpu().numpy()
            if has_refine and is_l2:
                # a refined L2 score is the true distance negated; the merge
                # below subtracts scores from |q|^2, so add it here
                s = s + qsq[:, None]
            ids = np.where(p >= 0, row_ids[np.clip(p, 0, n_rows - 1)], -1)
            partials.append((s, ids))
        # host merge of the per-shard top-k
        cat_s = np.concatenate([s for s, _ in partials], axis=1)
        cat_i = np.concatenate([i for _, i in partials], axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, order, 1)
        best_i = np.take_along_axis(cat_i, order, 1)
        if is_l2:
            dists = np.where(best_i >= 0, qsq[:, None] - best_s, np.inf)
        else:
            dists = np.where(best_i >= 0, best_s, -np.inf)
        return dists, best_i


def _pad_rows(a: np.ndarray) -> np.ndarray:
    """``a`` followed by LIST_PAD zero rows."""
    return np.concatenate([a, np.zeros((LIST_PAD, *a.shape[1:]), a.dtype)])
