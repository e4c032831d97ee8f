"""IVF list-scan engine in PyTorch (counterpart of knowhere_tpu/ops/ivf_scan.py:
the raw, pq, sq and rabitq kinds).

The (query, probed-list) pairs of a batch are inverted into dense tasks:

    task = (one block of <=B consecutive rows of one list,
            one group of <=Qg queries probing that list)

so each task is a dense (Qg x B x d) product and each list block is read
once per query group. Results are merged per query by inverting (task row ->
query slot) and running one final top-k over the (nq, S*kk) pool.

Dispatch is the reference's on-TPU dispatch on every device, in its order:
the int8 scan kernel for int8 precision over raw stores with the int8
sidecar and SQ8 stores with theirs (the u8 codes scanned in place); the ADC
kernel for PQ stores below EXACT; the f32 scan kernel for FAST/BF16 raw
stores; the RaBitQ kernel for RaBitQ stores below EXACT; the SQ kernel for
SQ8/SQ6 stores at FAST/BF16. Every kernel needs an aligned store and
d % 128 == 0. EXACT and everything else take the plain task scan
(``_scan_chunk``, which decodes PQ, SQ and RaBitQ codes): among them typed
raw stores (fp16/bf16/int8 rows, each sliced block widened to f32) and
JACCARD over binary planes (the kernels score L2 and IP only; HAMMING is L2
over {0,1} rows and keeps the kernels). The store's kind
is read from its keys (``store_kind``). Only the kernel wrappers
(ops/ivf_cuda.py, ops/adc_cuda.py) look at the tensors' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..utils import tracing
from .adc_cuda import SMEM_LIMIT, adc_scan_tasks, adc_smem_bytes, unpack_codes
from .ivf_cuda import (
    LIST_ALIGN, f32_scan_tasks, int8_scan_tasks, rbq_scan_tasks, sq_scan_tasks, task_kk, unpack_signs,
)
from .quant import sq_decode
from .topk import topk_leftmost

NEG_INF = -float("inf")
_PLAIN_TASK_CHUNK = 4096  # tasks per plain-scan step: bounds the gathered rows
_DECODE_BYTES = 256 << 20  # decoded f32 rows per plain PQ scan step


# ---------------------------------------------------------------------------
# Host-side task scheduler (numpy, as in the reference)
# ---------------------------------------------------------------------------


@dataclass
class TaskBatch:
    row_start: np.ndarray  # (T,) int32 — first row of the block (sorted storage)
    nrows: np.ndarray  # (T,) int32 — valid rows in the block (<= B)
    list_id: np.ndarray  # (T,) int32
    qids: np.ndarray  # (T, Qg) int32, -1 padded
    slots: np.ndarray  # (T, Qg) int32 — per-query merge slot
    n_slots: int  # S = max slots over queries
    B: int
    Qg: int


def build_scan_tasks(
    probes: np.ndarray,
    list_offsets: np.ndarray,
    B: int,
    Qg: int,
    list_lengths: Optional[np.ndarray] = None,
) -> Optional[TaskBatch]:
    """Invert (query -> probed lists) into (list-block x query-group) tasks.

    `probes` is (nq, nprobe) int32 (entries may be -1 = padding). Fully
    vectorized — O(nq*nprobe) numpy with no Python per-list loops, so the
    host scheduler stays off the critical path even at nq=10k x nprobe=256.

    `list_lengths` carries TRUE list lengths when the storage is block-
    aligned (lists padded to LIST_ALIGN multiples); offsets then give padded
    starts while nrows masking comes from the true lengths.
    """
    nq, _ = probes.shape
    list_offsets = np.asarray(list_offsets, dtype=np.int64)
    flat_l = probes.reshape(-1).astype(np.int64)
    flat_q = np.repeat(np.arange(nq, dtype=np.int32), probes.shape[1])
    lens_all = (
        np.asarray(list_lengths, dtype=np.int64)
        if list_lengths is not None
        else np.diff(list_offsets)
    )
    valid = flat_l >= 0
    valid &= np.where(valid, lens_all[np.clip(flat_l, 0, None)] > 0, False)
    flat_l, flat_q = flat_l[valid], flat_q[valid]
    if flat_l.size == 0:
        return None

    order = np.argsort(flat_l, kind="stable")
    sl, sq = flat_l[order], flat_q[order]
    P = sl.size

    # per-pair list geometry
    pair_len = lens_all[sl]
    pair_blocks = ((pair_len + B - 1) // B).astype(np.int32)

    # rank of each pair within its list group -> (group g, column)
    lchange = np.empty(P, bool)
    lchange[0] = True
    lchange[1:] = sl[1:] != sl[:-1]
    lstart = np.nonzero(lchange)[0]
    lgrp = np.cumsum(lchange) - 1
    rank = np.arange(P) - lstart[lgrp]
    g = rank // Qg
    col = (rank % Qg).astype(np.int64)

    # pair-group id: contiguous runs of (list, g)
    gchange = lchange | np.concatenate([[True], g[1:] != g[:-1]])
    pg = np.cumsum(gchange) - 1  # (P,) pair-group index
    G = int(pg[-1]) + 1
    pg_start = np.nonzero(gchange)[0]
    group_list = sl[pg_start]
    group_blocks = pair_blocks[pg_start].astype(np.int64)

    # per-query slot base: exclusive cumsum of pair_blocks in query order
    qorder = np.argsort(sq, kind="stable")
    blocks_q = pair_blocks[qorder].astype(np.int64)
    csum = np.cumsum(blocks_q)
    excl = csum - blocks_q
    sq_sorted = sq[qorder]
    qchange = np.empty(P, bool)
    qchange[0] = True
    qchange[1:] = sq_sorted[1:] != sq_sorted[:-1]
    qgrp_start = np.nonzero(qchange)[0]
    qgrp = np.cumsum(qchange) - 1
    excl -= excl[qgrp_start][qgrp]
    slot_base = np.empty(P, np.int64)
    slot_base[qorder] = excl
    totals = np.bincount(sq, weights=pair_blocks.astype(np.float64), minlength=nq)
    n_slots = int(totals.max())

    # scatter pairs into (G, Qg) member matrices
    qids_g = np.full((G, Qg), -1, np.int32)
    slots_g = np.zeros((G, Qg), np.int32)
    qids_g[pg, col] = sq
    slots_g[pg, col] = slot_base.astype(np.int32)

    # expand pair-groups into per-block tasks
    T = int(group_blocks.sum())
    task_group = np.repeat(np.arange(G, dtype=np.int64), group_blocks)
    gb_excl = np.cumsum(group_blocks) - group_blocks
    task_b = (np.arange(T, dtype=np.int64) - gb_excl[task_group]).astype(np.int64)
    task_list = group_list[task_group]
    lo = list_offsets[task_list]
    row_start = (lo + task_b * B).astype(np.int32)
    nrows = np.minimum(B, lens_all[task_list] - task_b * B).astype(np.int32)

    task_qids = qids_g[task_group]
    task_slots = slots_g[task_group] + task_b[:, None].astype(np.int32)

    return TaskBatch(
        row_start=row_start,
        nrows=nrows,
        list_id=task_list.astype(np.int32),
        qids=task_qids,
        slots=task_slots,
        n_slots=n_slots,
        B=B,
        Qg=Qg,
    )


def build_full_scan_tasks(
    nq: int,
    list_offsets: np.ndarray,
    B: int,
    Qg: int,
    list_lengths: Optional[np.ndarray] = None,
) -> Optional[TaskBatch]:
    """TaskBatch for nprobe == nlist (every query scans every list).

    The generic inverter (build_scan_tasks) costs an O(nq*nlist) argsort the
    full-probe case doesn't need: the layout is deterministic — every block
    is scanned by every ceil(nq/Qg) query group, and a query's merge slot for
    a block is just the global block index. High-dim corpora live in this
    regime (GIST-960 needs nprobe ~ 0.75*nlist for recall 0.95), where this
    path also lets the caller skip the coarse probe entirely."""
    list_offsets = np.asarray(list_offsets, dtype=np.int64)
    lens = (
        np.asarray(list_lengths, dtype=np.int64)
        if list_lengths is not None
        else np.diff(list_offsets)
    )
    sel = np.nonzero(lens > 0)[0]
    if sel.size == 0 or nq == 0:
        return None
    bl = ((lens[sel] + B - 1) // B).astype(np.int64)
    nb_blocks = int(bl.sum())
    bexcl = np.cumsum(bl) - bl
    blk_list = np.repeat(sel, bl)
    tb = np.arange(nb_blocks, dtype=np.int64) - np.repeat(bexcl, bl)
    row_start_b = (list_offsets[blk_list] + tb * B).astype(np.int32)
    nrows_b = np.minimum(B, lens[blk_list] - tb * B).astype(np.int32)

    NG = (nq + Qg - 1) // Qg
    qids_g = np.full((NG, Qg), -1, np.int32)
    flat = np.arange(NG * Qg, dtype=np.int32)
    qids_g.reshape(-1)[...] = np.where(flat < nq, flat, -1)

    T = nb_blocks * NG
    row_start = np.tile(row_start_b, NG)
    nrows = np.tile(nrows_b, NG)
    list_id = np.tile(blk_list.astype(np.int32), NG)
    qids = np.repeat(qids_g, nb_blocks, axis=0)
    slot_b = np.arange(nb_blocks, dtype=np.int32)
    slots = np.tile(slot_b, NG)[:, None] + np.zeros((1, Qg), np.int32)
    return TaskBatch(
        row_start=row_start,
        nrows=nrows,
        list_id=list_id,
        qids=qids,
        slots=slots,
        n_slots=nb_blocks,
        B=B,
        Qg=Qg,
    )


def _build_tasks(probes, nq, list_offsets, B, Qg, list_lengths):
    """probes=None selects the full-probe fast layout."""
    if probes is None:
        return build_full_scan_tasks(nq, list_offsets, B, Qg, list_lengths=list_lengths)
    return build_scan_tasks(probes, list_offsets, B, Qg, list_lengths=list_lengths)


def device_task_bounds(
    nq: int, nprobe: int, lens_arr: np.ndarray, B: int, Qg: int
) -> Tuple[int, int, int]:
    """Static upper bounds for the on-device task builder.

    With c_l = queries probing list l (c_l <= nq, sum c_l = P = nq*nprobe)
    and topsum = sum of the nprobe LARGEST per-list block counts:

    T = sum_l ceil(c_l/Qg)*blocks_l <= nq*topsum/Qg + total_blocks
        (sum_l c_l*blocks_l is maximized by concentrating all pairs on the
        blockiest lists at c_l = nq each — i.e. nq * topsum)
    G = sum_l ceil(c_l/Qg)          <= P/Qg + nlist (+1 sentinel)
    S = max_q sum_{probed l} blocks_l <= min(topsum, total_blocks)

    topsum keeps the bound tight under skewed list lengths (one 100-block
    list among 2-block lists), where nprobe*max_blocks over-allocates the
    task and merge buffers. All derive from build-time list geometry only, so
    the on-device builder needs no host sync."""
    lens = np.asarray(lens_arr, np.int64)
    blocks = (lens + B - 1) // B
    total_blocks = int(blocks.sum())
    if blocks.size > nprobe:
        topsum = int(np.sort(blocks)[-nprobe:].sum())
    else:
        topsum = int(blocks.sum())
    P = nq * nprobe
    T_max = (nq * topsum + Qg - 1) // Qg + total_blocks + 1
    G_max = P // Qg + int(lens.size) + 2
    S_max = max(1, int(min(topsum, total_blocks)))
    return T_max, G_max, S_max


def build_scan_tasks_torch(
    probes: torch.Tensor,  # (nq, nprobe) int32, -1 padded
    offsets: torch.Tensor,  # (nlist+1,) int32 block-aligned starts (CSR)
    lens: torch.Tensor,  # (nlist,) int32 TRUE list lengths
    *,
    B: int,
    Qg: int,
    T_max: int,
    G_max: int,
    nlist: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-side mirror of build_scan_tasks (reference
    ``build_scan_tasks_jax``): a stable sort and cumsums, no host sync.
    Trailing tasks beyond the true count have nrows=0 / qids=-1. Returns
    (row_start, nrows, list_id, qids (T_max,Qg), slots (T_max,Qg)), int32."""
    dev = probes.device
    nq, nprobe = probes.shape
    P = nq * nprobe
    flat_l = probes.reshape(-1).long()
    flat_q = torch.arange(nq, device=dev).repeat_interleave(nprobe)
    lens_ext = torch.cat([lens.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    safe_l = flat_l.clamp(0, nlist - 1)
    valid = (flat_l >= 0) & (lens_ext[safe_l] > 0)
    key_l = torch.where(valid, flat_l, torch.full_like(flat_l, nlist))  # invalid last

    order = torch.sort(key_l, stable=True).indices
    sl = key_l[order]
    sq = torch.where(valid[order], flat_q[order], torch.full_like(flat_q, -1))
    pair_blocks = (lens_ext[sl] + (B - 1)) // B  # 0 for the sentinel

    idx = torch.arange(P, device=dev)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    lchange = torch.cat([true1, sl[1:] != sl[:-1]])
    last_start = torch.cummax(torch.where(lchange, idx, torch.full_like(idx, -1)), 0).values
    rank = idx - last_start  # rank of the pair within its list run
    g = rank // Qg
    col = rank % Qg
    gchange = lchange | torch.cat([true1, g[1:] != g[:-1]])
    pg = (torch.cumsum(gchange.long(), 0) - 1).clamp(max=G_max - 1)

    # per-query merge-slot bases: exclusive cumsum of pair blocks in the
    # query-major order (each query's pairs are contiguous there)
    pb_orig = torch.where(valid, (lens_ext[safe_l] + (B - 1)) // B, torch.zeros_like(safe_l))
    pb_orig = pb_orig.reshape(nq, nprobe)
    cs = torch.cumsum(pb_orig, 1)
    slot_sorted = (cs - pb_orig).reshape(-1)[order]

    # every pair of a pair-group carries the same list and block count, so
    # duplicate scatter indices write equal values
    group_list = torch.full((G_max,), nlist, dtype=torch.long, device=dev)
    group_list[pg] = sl
    group_blocks = torch.zeros(G_max, dtype=torch.long, device=dev)
    group_blocks[pg] = pair_blocks
    qids_g = torch.full((G_max, Qg), -1, dtype=torch.long, device=dev)
    qids_g[pg, col] = sq
    slots_g = torch.zeros((G_max, Qg), dtype=torch.long, device=dev)
    slots_g[pg, col] = slot_sorted

    gb_csum = torch.cumsum(group_blocks, 0)
    gb_excl = gb_csum - group_blocks
    T_total = gb_csum[-1]
    t_idx = torch.arange(T_max, device=dev)
    tg = torch.searchsorted(gb_csum, t_idx, right=True).clamp(max=G_max - 1)
    valid_t = t_idx < T_total
    task_b = t_idx - gb_excl[tg]
    task_list = group_list[tg].clamp(max=nlist)
    zero = torch.zeros_like(t_idx)
    row_start = torch.where(valid_t, offsets.long()[task_list] + task_b * B, zero)
    nrows = torch.where(valid_t, (lens_ext[task_list] - task_b * B).clamp(0, B), zero)
    qids_t = torch.where(valid_t[:, None], qids_g[tg], torch.full_like(qids_g[tg], -1))
    slots_t = torch.where(valid_t[:, None], slots_g[tg] + task_b[:, None], torch.zeros_like(slots_g[tg]))
    list_t = torch.where(valid_t, task_list.clamp(max=nlist - 1), zero)
    return (
        row_start.int(), nrows.int(), list_t.int(), qids_t.int(), slots_t.int()
    )


def _pad16(n: int) -> int:
    """Merge-pool slot count rounded up to a multiple of 16, as in the
    reference."""
    return -(-max(n, 1) // 16) * 16


# ---------------------------------------------------------------------------
# Plain task scan (EXACT precision, unaligned stores)
# ---------------------------------------------------------------------------


def _nib(store: Dict[str, torch.Tensor]) -> bool:
    """Whether a PQ store's codes are nibble-packed (two 4-bit codes a byte,
    models/ivf.py): their rows are then m/2 bytes wide. m comes from the
    kernel's ``books`` where the store has them, else from ``codebooks``
    (the sharded stores, parallel/sharding.py, carry only those)."""
    books = store["books"] if "books" in store else store["codebooks"]
    return store["codes"].shape[1] != books.shape[0]


def store_kind(store: Dict[str, torch.Tensor]) -> str:
    """'pq', 'rabitq', 'sq' or 'raw', from the keys models/ivf.py uploads."""
    if "codebooks" in store:
        return "pq"
    if "signs" in store:
        return "rabitq"
    return "sq" if "codes" in store else "raw"


def _scan_chunk(
    q: torch.Tensor,  # (nq, d) f32 (OPQ-rotated for pq, rotated for rabitq)
    store: Dict[str, torch.Tensor],
    row_start: torch.Tensor,  # (Tc,)
    nrows: torch.Tensor,  # (Tc,)
    list_id: torch.Tensor,  # (Tc,)
    qids: torch.Tensor,  # (Tc, Qg)
    keep_sorted: Optional[torch.Tensor],  # (nb_pad + slack,) bool or None
    *,
    B: int,
    kk: int,
    is_l2: bool,
    sq_levels: int = 0,
    sq_packed4: bool = False,
    is_jaccard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-f32 task scan: (scores (Tc,Qg,kk) larger-is-better, positions
    (Tc,Qg,kk)); -inf / -1 for empty slots. PQ stores decode each row as its
    codewords plus the list's scan-frame centroid (cent_scan under OPQ); SQ
    stores decode their codes (SQ4 unpacked, FP16/BF16 widened); RaBitQ
    stores score the estimator with the f32 query residual, sqrt(d) at the
    scanned width d. Raw rows of any width widen to f32; JACCARD scores the
    similarity inter / max(union, 1e-9) of {0,1} rows (distance 1 - score)."""
    d = q.shape[1]
    rows_idx = row_start.long()[:, None] + torch.arange(B, device=q.device)[None, :]
    qs = q[qids.long().clamp(min=0)]  # (Tc, Qg, d)
    kind = store_kind(store)
    if kind == "rabitq":
        c_rot = store["centroids_rot"][list_id.long()][:, None, :]
        qr = qs - c_rot
        dots = torch.bmm(qr, unpack_signs(store["signs"][rows_idx], d).transpose(1, 2))
        rn = store["r_norm"][rows_idx][:, None, :]
        ip_est = rn * dots / (torch.clamp(store["t"][rows_idx], min=1e-6)[:, None, :] * float(np.sqrt(d)))
        if is_l2:
            score = -((qr * qr).sum(-1, keepdim=True) + rn * rn - 2.0 * ip_est)
        else:
            score = (qs * c_rot).sum(-1, keepdim=True) + ip_est
    else:
        if kind == "pq":
            books = store["codebooks"]  # (m, ksub, sub) f32
            m, ksub, sub = books.shape
            code = unpack_codes(store["codes"][rows_idx], m, _nib(store)) + torch.arange(m, device=q.device) * ksub
            rows = books.reshape(m * ksub, sub)[code].reshape(*rows_idx.shape, m * sub)
            cents = store.get("cent_scan", store["centroids"])
            rows = torch.nn.functional.pad(rows, (0, cents.shape[1] - m * sub))
            rows = rows + cents[list_id.long()][:, None, :]
            norms = (rows * rows).sum(-1) if is_l2 else None
        elif kind == "sq":
            rows = sq_decode(store["codes"][rows_idx], store.get("vmin"), store.get("vdiff"), sq_levels, sq_packed4, d)
            norms = (rows * rows).sum(-1) if is_l2 else None
        else:
            rows = store["data"][rows_idx].float()  # (Tc, B, d)
            norms = store["norms"][rows_idx] if is_l2 else None
        dots = torch.bmm(qs, rows.transpose(1, 2))
        if is_jaccard:
            union = qs.sum(-1, keepdim=True) + rows.sum(-1)[:, None, :] - dots
            score = dots / torch.clamp(union, min=1e-9)
        else:
            score = 2.0 * dots - norms[:, None, :] if is_l2 else dots
    ok = (torch.arange(B, device=q.device)[None, :] < nrows.long()[:, None])[:, None, :]
    if keep_sorted is not None:
        ok = ok & keep_sorted[rows_idx][:, None, :]
    score = torch.where(ok, score, torch.full_like(score, NEG_INF))
    Tc, Qg, _ = score.shape
    s, i = topk_leftmost(score.reshape(Tc * Qg, B), kk)
    s, i = s.reshape(Tc, Qg, kk), i.reshape(Tc, Qg, kk)
    pos = torch.where(s == NEG_INF, torch.full_like(i, -1), row_start.long()[:, None, None] + i)
    return s, pos.int()


def _merge_tasks(
    scores: torch.Tensor,  # (T, Qg, kk)
    pos: torch.Tensor,  # (T, Qg, kk)
    qids: torch.Tensor,  # (T, Qg)
    slots: torch.Tensor,  # (T, Qg)
    *,
    nq: int,
    S: int,
    kk: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert (task row -> query slot) with one element scatter, gather the
    (nq, S, kk) pool and run one final top-k. (q, slot) keys are unique by
    construction; padded task rows have no query and go to one extra dump
    slot (the reference relies on jax dropping out-of-bounds scatters, which
    torch does not do)."""
    Tq = scores.shape[0] * scores.shape[1]
    dev = scores.device
    flat_q = qids.reshape(-1).long()
    rown = torch.arange(Tq, device=dev)
    dump = nq * S
    key = torch.where(
        flat_q >= 0,
        flat_q * S + slots.reshape(-1).long().clamp(max=S - 1),
        torch.full_like(flat_q, dump),
    )
    inv = torch.full((dump + 1,), -1, dtype=torch.long, device=dev)
    inv[key] = rown
    inv = inv[:dump]
    safe = inv.clamp(min=0)
    valid = (inv >= 0)[:, None]
    ms = torch.where(valid, scores.reshape(-1, kk)[safe], torch.full((1, 1), NEG_INF, device=dev))
    mp = torch.where(valid, pos.reshape(-1, kk)[safe].long(), torch.full((1, 1), -1, device=dev))
    ms = ms.reshape(nq, S * kk)
    mp = mp.reshape(nq, S * kk)
    k_eff = min(k, S * kk)  # fewer candidates than k: pad below
    best_s, sel = topk_leftmost(ms, k_eff)
    best_p = torch.gather(mp, 1, sel)
    best_p = torch.where(best_s == NEG_INF, torch.full_like(best_p, -1), best_p)
    if k_eff < k:
        best_s = torch.nn.functional.pad(best_s, (0, k - k_eff), value=NEG_INF)
        best_p = torch.nn.functional.pad(best_p, (0, k - k_eff), value=-1)
    return best_s, best_p.int()


# ---------------------------------------------------------------------------
# Coarse probe
# ---------------------------------------------------------------------------


def coarse_probe_host(
    xq: np.ndarray, centroids: np.ndarray, nprobe: int, is_l2: bool
) -> np.ndarray:
    """Host (numpy) coarse probe for tiny batches, as the reference takes it."""
    dots = xq.astype(np.float32) @ centroids.T.astype(np.float32)
    if is_l2:
        score = 2.0 * dots - np.sum(centroids.astype(np.float64) ** 2, axis=1).astype(np.float32)[None]
    else:
        score = dots
    nprobe = min(nprobe, centroids.shape[0])
    if nprobe >= centroids.shape[0]:
        idx = np.argsort(-score, axis=1, kind="stable")
    else:
        part = np.argpartition(-score, nprobe - 1, axis=1)[:, :nprobe]
        sub = np.take_along_axis(score, part, axis=1)
        idx = np.take_along_axis(part, np.argsort(-sub, axis=1, kind="stable"), axis=1)
    return idx.astype(np.int32)




def coarse_probe(q: torch.Tensor, centroids: torch.Tensor, *, nprobe: int, is_l2: bool) -> torch.Tensor:
    """Top-nprobe nearest lists per query, full-f32 product: (nq, nprobe) int32."""
    dots = q @ centroids.T
    score = 2.0 * dots - (centroids * centroids).sum(1)[None, :] if is_l2 else dots
    _, idx = topk_leftmost(score, min(nprobe, centroids.shape[0]))
    return idx.int()


def quantize_queries_int8(
    q: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization in the data's per-dim scale
    frame: z = (q - mu) * scale, zi = round(z / sz) with sz = max|z|/127
    (half-to-even, and a true division by sz, as in the reference).
    Returns (zi (nq,d) int8, sz (nq,) f32)."""
    z = (q.float() - mu[None, :]) * scale[None, :]
    m = z.abs().amax(dim=1, keepdim=True)
    # XLA folds the division by the constant 127 into a multiply by its f32
    # reciprocal; the same form keeps sz bit-equal to the reference
    sz = torch.clamp(m, min=1e-30) * np.float32(1.0 / 127.0).item()
    zi = torch.clamp(torch.round(z / sz), -127, 127).to(torch.int8)
    return zi, sz[:, 0]


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


def _aligned(offsets: np.ndarray) -> bool:
    offsets = np.asarray(offsets)
    return offsets.size >= 2 and offsets[-1] != 0 and bool((offsets % LIST_ALIGN == 0).all())


def int8_available(store: dict, d: int, k: int, offsets: np.ndarray) -> bool:
    """The int8 scan serves raw and SQ8 stores that carry the int8 sidecar
    (its norms, "i8_nrm")."""
    return "i8_nrm" in store and d % 128 == 0 and k >= 1 and _aligned(offsets)


def scan_available(d: int, k: int, offsets: np.ndarray, prec: str) -> bool:
    """The f32 scan serves FAST/BF16 over aligned f32 stores; EXACT keeps the
    plain full-f32 task scan."""
    return prec in ("fast", "bf16") and d % 128 == 0 and k >= 1 and _aligned(offsets)


def adc_available(store: dict, d: int, k: int, offsets: np.ndarray) -> bool:
    """The ADC scan serves PQ stores over aligned lists (the counterpart of
    the reference's pallas_adc_available, without its 8192-entry LUT cap:
    the kernel walks subspaces in chunks). It needs d % 128 == 0 and a block
    whose shared memory fits."""
    if "books" not in store or d % 128 != 0 or k < 1 or not _aligned(offsets):
        return False
    m, ksub, sub = store["books"].shape
    return adc_smem_bytes(m, ksub, sub, _nib(store)) <= SMEM_LIMIT


def sq_available(d: int, code_dim: int, k: int, offsets: np.ndarray, sq_levels: int, sq_packed4: bool,
                 prec: str) -> bool:
    """The SQ scan serves one-code-a-byte SQ8/SQ6 stores at FAST/BF16 (the
    reference's pallas_sq_available): not SQ4's packed nibbles, not FP16/BF16
    rows, not EXACT."""
    if sq_levels <= 0 or sq_packed4 or code_dim != d or prec not in ("fast", "bf16"):
        return False
    return d % 128 == 0 and k >= 1 and _aligned(offsets)


def rbq_available(store: dict, d: int, k: int, offsets: np.ndarray) -> bool:
    """The RaBitQ scan serves RaBitQ stores over aligned lists (the
    reference's pallas_rbq_available)."""
    return "signs" in store and d % 128 == 0 and k >= 1 and _aligned(offsets)


def _empty(nq: int, k: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev),
        torch.full((nq, k), -1, dtype=torch.int32, device=dev),
    )


def _device_tasks_chunked(probes_dev, store, lens_arr, B: int, Qg: int, chunk: int):
    """On-device task build with static bounds from the list geometry.
    Returns (row_start, nrows, list_id, qids (total,Qg), slots (total,Qg),
    Tc, S)."""
    nq_p, nprobe = probes_dev.shape
    T_max, G_max, S_max = device_task_bounds(nq_p, nprobe, lens_arr, B, Qg)
    Tc = min(chunk, T_max)
    tasks = build_scan_tasks_torch(
        probes_dev, store["offsets_dev"], store["lens_dev"],
        B=B, Qg=Qg, T_max=T_max, G_max=G_max, nlist=len(lens_arr),
    )
    return (*tasks, Tc, _pad16(S_max))


def _tasks(q_dev, store, probes, list_offsets, lens_arr, B, Qg, chunk):
    """(row_start, nrows, list_id, qids, slots, Tc, S) on the device, or None
    when no query probes a non-empty list. Device probes build on the device;
    host probes (tiny batches, full probe, widening retries) build with
    numpy."""
    if isinstance(probes, torch.Tensor):
        return _device_tasks_chunked(probes, store, lens_arr, B, Qg, chunk)
    batch = _build_tasks(probes, q_dev.shape[0], list_offsets, B, Qg, lens_arr)
    if batch is None:
        return None
    arrays = (batch.row_start, batch.nrows, batch.list_id, batch.qids, batch.slots)
    return (*[to_device(a.astype(np.int32)) for a in arrays], chunk, _pad16(batch.n_slots))


def scan_route(
    store: Dict[str, torch.Tensor], d: int, k: int, list_offsets: np.ndarray, prec: str,
    sq_levels: int = 0, sq_packed4: bool = False, is_jaccard: bool = False,
) -> Tuple[str, str]:
    """The path ivf_scan_search takes, in the reference's dispatch order:
    ("int8" | "adc" | "f32" | "rbq" | "sq" | "plain", the precision it scans
    at; int8 without a sidecar falls back to "fast"). Typed (non-f32) raw
    stores and JACCARD take the plain scan, as there."""
    kind = store_kind(store)
    if prec == "int8":
        if kind in ("raw", "sq") and not is_jaccard and int8_available(store, d, k, list_offsets):
            return "int8", prec
        prec = "fast"  # no int8 sidecar: the f32 ranking path
    if kind == "pq" and prec != "exact" and adc_available(store, d, k, list_offsets):
        return "adc", prec
    raw_is_f32 = kind == "raw" and store["data"].dtype == torch.float32
    if raw_is_f32 and not is_jaccard and scan_available(d, k, list_offsets, prec):
        return "f32", prec
    if kind == "rabitq" and prec != "exact" and rbq_available(store, d, k, list_offsets):
        return "rbq", prec
    if kind == "sq" and sq_available(d, store["codes"].shape[1], k, list_offsets, sq_levels, sq_packed4, prec):
        return "sq", prec
    return "plain", prec


def route_geometry(route: str, k: int, lens_arr: np.ndarray) -> Tuple[int, int]:
    """(rows a task covers B, per-task top-k kk) on ``route``: the kernels'
    LIST_ALIGN blocks at task_kk, the int8 scan's at kk=16 up to k=32 (the
    rerank only recovers what the scan kept; above k=32 the task_kk cap of
    32 decides the pool, kept for parity), the plain scan's 256-row blocks
    for small-list layouts, else 512, at min(k, B). The task build and
    pool_bound both read it."""
    if route == "plain":
        B = 256 if float(lens_arr.mean() or 1.0) <= 256 else 512
        return B, min(k, B)
    kk = task_kk(k, LIST_ALIGN)
    return LIST_ALIGN, min(kk, 16 if k <= 32 else 32) if route == "int8" else kk


def pool_bound(route: str, list_lengths: np.ndarray, nprobe: int, k: int) -> int:
    """Upper bound of the candidates one query's merge pool holds (slots S
    times the per-task top-k kk) on ``route``, probing ``nprobe`` lists:
    a query's slots are the blocks of its lists, at most those of the
    nprobe longest. The merged (nq, k) result holds its candidates in its
    first min(k, bound) columns, then (-inf, -1)."""
    lens = np.asarray(list_lengths, np.int64)
    B, kk = route_geometry(route, k, lens)
    blocks = (lens + B - 1) // B
    S = int(np.sort(blocks)[-nprobe:].sum()) if nprobe < blocks.size else int(blocks.sum())
    return max(1, S) * kk


def ivf_scan_search(
    q_dev: torch.Tensor,  # (nq, d) f32
    store: Dict[str, torch.Tensor],
    probes,  # (nq, nprobe) int32: numpy (host) or tensor (device); None = full probe
    list_offsets: np.ndarray,  # host (nlist+1,)
    k: int,
    is_l2: bool,
    keep_sorted: Optional[torch.Tensor] = None,
    prec: Optional[str] = None,
    list_lengths: Optional[np.ndarray] = None,
    sq_levels: int = 0,
    sq_packed4: bool = False,
    route: Optional[str] = None,
    is_jaccard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan one store (q_dev in the OPQ frame for PQ, rotated for RaBitQ).
    Returns (scores (nq,k) larger-is-better, positions (nq,k) int32 into the
    sorted storage; -1 padded), both on the device. A caller that has
    worked out the route (scan_route) passes it with the precision
    scan_route returned."""
    from .distances import matmul_precision_name

    if prec is None:
        prec = matmul_precision_name()
    nq, d = q_dev.shape
    lens_arr = (
        np.asarray(list_lengths, dtype=np.int64)
        if list_lengths is not None
        else np.diff(np.asarray(list_offsets, dtype=np.int64))
    )
    # adaptive query-group width (result-neutral), as in the reference
    if probes is None:
        avg, cap = nq, 256
    elif isinstance(probes, torch.Tensor):
        avg, cap = 2 * nq * probes.shape[1] / max(len(lens_arr), 1), 128
    else:
        touched = np.unique(probes[probes >= 0])
        avg, cap = int((probes >= 0).sum()) / max(len(touched), 1), 128
    while cap > 32 and cap * d * 4 > (512 << 10):
        cap //= 2
    Qg = 32
    while Qg < min(avg, cap):
        Qg *= 2

    if route is None:
        route, prec = scan_route(store, d, k, list_offsets, prec, sq_levels, sq_packed4, is_jaccard)
    B, kk = route_geometry(route, k, lens_arr)
    args = (q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted)
    if route == "int8":
        return _int8_search(*args)
    if route == "adc":
        return _adc_search(*args)
    if route == "f32":
        return _f32_search(*args, three_pass=prec == "fast")
    if route == "rbq":
        return _rbq_search(*args, three_pass=prec == "fast")
    if route == "sq":
        return _sq_search(*args, levels=sq_levels, three_pass=prec == "fast")

    # plain full-f32 task scan; blocks shrink for small-list layouts
    chunk = _PLAIN_TASK_CHUNK if store_kind(store) == "raw" else max(32, _DECODE_BYTES // (B * d * 4))
    with tracing.span("ivf_scan.tasks"):
        tasks = _tasks(q_dev, store, probes, list_offsets, lens_arr, B, Qg, chunk)
    if tasks is None:
        return _empty(nq, k, q_dev.device)
    rs, nr, lid, qids, slots, Tc, S = tasks
    with tracing.span("ivf_scan.kernel"):
        parts = []
        for c in range(0, rs.shape[0], Tc):
            _count_tasks(nr[c : c + Tc])
            parts.append(_scan_chunk(
                q_dev, store, rs[c : c + Tc], nr[c : c + Tc], lid[c : c + Tc], qids[c : c + Tc],
                keep_sorted, B=B, kk=kk, is_l2=is_l2, sq_levels=sq_levels, sq_packed4=sq_packed4,
                is_jaccard=is_jaccard,
            ))
    with tracing.span("ivf_scan.merge"):
        all_s = torch.cat([p[0] for p in parts])
        all_p = torch.cat([p[1] for p in parts])
        return _merge_tasks(all_s, all_p, qids, slots, nq=nq, S=S, kk=kk, k=k)


def _count_tasks(nrows: torch.Tensor) -> None:
    """Counters of one scan call's tasks: launched, and those with rows
    (the static task bound pads the device-built tasks with empty ones)."""
    if tracing.enabled():
        tracing.count("ivf_scan.tasks_launched", nrows.shape[0])
        tracing.count("ivf_scan.tasks_filled", (nrows > 0).sum())


def _kernel_chunk(Qg: int, d: int) -> int:
    """Tasks per kernel call: bounds the gathered (chunk, Qg, d) query groups
    near 512 MiB as the reference does."""
    return max(8, min(16384, (512 << 20) // max(Qg * d * 4, 1)) // 8 * 8)


def _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan):
    """The kernel paths' shared frame: aligned B=LIST_ALIGN tasks, one
    ``scan(blk, nrows, lids, qids)`` call per chunk of tasks (qids clamped to
    valid rows), then the merge."""
    nq, d = q_dev.shape
    B = LIST_ALIGN
    with tracing.span("ivf_scan.tasks"):
        tasks = _tasks(q_dev, store, probes, list_offsets, lens_arr, B, Qg, _kernel_chunk(Qg, d))
    if tasks is None:
        return _empty(nq, k, q_dev.device)
    rs, nr, lid, qids, slots, Tc, S = tasks
    with tracing.span("ivf_scan.kernel"):
        blk = rs // B
        s_parts, p_parts = [], []
        for c in range(0, rs.shape[0], Tc):
            sl = slice(c, c + Tc)
            _count_tasks(nr[sl])
            s, p = scan(blk[sl], nr[sl], lid[sl], qids[sl].long().clamp(min=0))
            s_parts.append(s)
            p_parts.append(p)
    with tracing.span("ivf_scan.merge"):
        return _merge_tasks(torch.cat(s_parts), torch.cat(p_parts), qids, slots, nq=nq, S=S, kk=kk, k=k)


def _int8_search(q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted=None):
    """int8 candidate scan (kernel: ivf_cuda.int8_scan_tasks) over the raw
    store's int8 sidecar or SQ8's own u8 codes. Queries are quantized per
    batch on the device; the caller re-ranks the merged pool, so this path
    never returns final distances."""
    zi, szv = quantize_queries_int8(q_dev, store["i8_mu"], store["i8_scale"])
    codes = store.get("data_i8", store.get("codes"))

    def scan(blk, nr, _lid, safe):
        return int8_scan_tasks(
            blk, nr, zi[safe], szv[safe][..., None], codes, store["i8_nrm"], keep_sorted,
            B=LIST_ALIGN, kk=kk, is_l2=is_l2,
        )

    return _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan)


def _f32_search(q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted=None, *, three_pass):
    """Raw f32 scan (kernel: ivf_cuda.f32_scan_tasks); FAST runs the
    reference's three-pass hi/lo bf16 product, BF16 the single bf16 pass."""

    def scan(blk, nr, _lid, safe):
        return f32_scan_tasks(
            blk, nr, q_dev[safe], store["data"], keep_sorted,
            B=LIST_ALIGN, kk=kk, is_l2=is_l2, three_pass=three_pass,
        )

    return _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan)


def _adc_search(q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted=None):
    """PQ ADC scan (kernel: adc_cuda.adc_scan_tasks) over the whole batch;
    q_dev is in the OPQ-rotated frame, the centroid terms use cent_scan."""
    cents = store.get("cent_scan", store["centroids"])

    def scan(blk, nr, lid, safe):
        return adc_scan_tasks(
            blk, nr, lid, q_dev[safe], store["books"], store["clut"], cents, store["codes"], keep_sorted,
            B=LIST_ALIGN, kk=kk, is_l2=is_l2, nib=_nib(store),
        )

    return _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan)


def _sq_search(q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted=None, *, levels, three_pass):
    """SQ8/SQ6 scan (kernel: ivf_cuda.sq_scan_tasks), the codes decoded in
    the scan (the reference's _pallas_scan_search, kind 'sq')."""

    def scan(blk, nr, _lid, safe):
        return sq_scan_tasks(
            blk, nr, q_dev[safe], store["codes"], store["vmin"], store["vdiff"], keep_sorted,
            B=LIST_ALIGN, kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass,
        )

    return _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan)


def _rbq_search(q_dev, store, probes, list_offsets, lens_arr, k, kk, is_l2, Qg, keep_sorted=None, *, three_pass):
    """RaBitQ sign-plane scan (kernel: ivf_cuda.rbq_scan_tasks); q_dev is in
    the rotated frame, each task reads its list's rotated centroid (the
    reference's _pallas_rbq_search)."""

    def scan(blk, nr, lid, safe):
        return rbq_scan_tasks(
            blk, nr, lid, q_dev[safe], store["centroids_rot"], store["signs"], store["r_norm"], store["t"],
            keep_sorted, B=LIST_ALIGN, kk=kk, is_l2=is_l2, three_pass=three_pass,
        )

    return _kernel_search(q_dev, store, probes, list_offsets, lens_arr, k, Qg, kk, scan)
