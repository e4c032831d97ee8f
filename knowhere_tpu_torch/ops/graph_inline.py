"""Inline-neighborhood beam search, the fast walk of the graph indexes
(counterpart of knowhere_tpu/ops/graph_inline.py).

Each row of the inline table packs one node's whole neighborhood as int32
words: [deg neighbor ids | deg neighbor norms (f32 bits) | deg x d walk codes]
with the codes 4 to a word (8-bit) or 8 to a word in nibble planes (4-bit).
A beam step then gathers nq * W table rows instead of nq * W * deg rows, and
scores the candidates in "code space": q . v = q . vmin + (q * scale) . codes
+ 0.5 * sum(q * scale), with scale = vdiff / 2^bits, q * scale rounded to
bf16 (round to nearest even) as the reference rounds it, the exact products
summed in f32, and the stored norms exact. One exact rerank of the final beam
(raw f32, bf16 or int8 rows, SQ8 decode, LVQ decode, PQ or PRQ decode)
gives the returned scores.

The table is derived state: rebuilt from the graph and the stored values at
build and load, never serialized, bit for bit the reference's (codes are
floor((x - vmin) / vdiff * levels), a true division; norms sum(x * x) in f32).

The walk runs its ``n_steps`` with the done test of ops/graph.py every 8
steps (same results as the reference's early exit). Each step's membership
test (which candidates are fresh: neither visited, nor in the beam, nor
repeated from another parent) is ops/graph.py's ``fresh_step``, which the
general walk calls too: the CUDA kernel csrc/graph_walk.cu for CUDA tensors,
``fresh_step_plain`` (torch ops) for CPU tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..utils import tracing
from .graph import DONE_CHECK_STEPS, decode_rows, fresh_step, sort_desc
from .quant import lvq_decode
from .topk import topk_leftmost

NEG = -float("inf")
_TABLE_CHUNK = 131072  # nodes per table-build / encode step


def inline_row_words(deg: int, d: int, bits: int = 8) -> int:
    """int32 words per table row: ids + norms + packed codes (8 or 4 bit)."""
    return deg + deg + deg * (d // (32 // bits))


def build_inline_table(graph_np: np.ndarray, codes_i32: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """(nb, inline_row_words) int32 table on the codes' device. A -1 neighbor
    slot keeps id -1 (masked in the walk) and carries row 0's norm and codes
    (a clipped gather), which are never scored."""
    nb, deg = graph_np.shape
    dw = codes_i32.shape[1]
    table = torch.empty((nb, 2 * deg + deg * dw), dtype=torch.int32, device=codes_i32.device)
    for s in range(0, nb, _TABLE_CHUNK):
        g = to_device(np.ascontiguousarray(graph_np[s : s + _TABLE_CHUNK], dtype=np.int32))
        gc = g.clamp(min=0).long()
        e = s + g.shape[0]
        table[s:e, :deg] = g
        table[s:e, deg : 2 * deg] = norms[gc].contiguous().view(torch.int32)
        table[s:e, 2 * deg :] = codes_i32[gc].reshape(-1, deg * dw)
    return table


def sq8_pack_words(codes_u8: torch.Tensor) -> torch.Tensor:
    """(nb, d) uint8 -> (nb, d//4) int32, little-endian byte packing."""
    return codes_u8.to(torch.uint8).contiguous().view(torch.int32)


def sq4_pack_words(codes: torch.Tensor) -> torch.Tensor:
    """(nb, d) 4-bit codes -> (nb, d//8) int32 in plane-strided packing: word
    j holds in nibble p the code of dim p * (d//8) + j."""
    nb, d = codes.shape
    dwq = d // 8
    v = codes.reshape(nb, 8, dwq).int()
    w = torch.zeros((nb, dwq), dtype=torch.int32, device=codes.device)
    for p in range(8):
        w |= v[:, p, :] << (4 * p)
    return w


def sq4_unpack_planes(words: torch.Tensor) -> torch.Tensor:
    """Inverse of sq4_pack_words along the last axis: (..., dwq) words ->
    (..., 8 * dwq) int32 codes in the original dim order."""
    return torch.cat([(words >> (4 * p)) & 15 for p in range(8)], dim=-1)


def _decoded_scores(kind, q, r0, r1, r2, ids2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nq, C) ids -> (dots with q, squared norms) of the exactly decoded
    stored values: raw rows (f32, bf16 or int8, widened), the SQ8 decode in
    the reference's rounding order (vmin + (c + 0.5) * (vdiff / 256)), the
    LVQ decode (r1 the mean, r2 the rows' [offset, scale]), PQ or PRQ
    codewords."""
    nq, C = ids2d.shape
    if kind == "sq":
        vv = r1[None, None, :] + (r0[ids2d.clamp(min=0).long()].float() + 0.5) * (r2[None, None, :] / 256.0)
    elif kind == "lvq":
        safe = ids2d.reshape(-1).clamp(min=0).long()
        os_ = r2[safe]
        vv = lvq_decode(r0[safe], os_[:, 0], os_[:, 1], r1).reshape(nq, C, -1)
    else:
        store = {"data": r0} if kind == "raw" else {"codes": r0, "codebooks": r1}
        vv = decode_rows(kind, store, ids2d.reshape(-1)).reshape(nq, C, -1)
    return torch.bmm(vv, q[:, :, None])[:, :, 0], (vv * vv).sum(2)


def beam_search_inline(
    table: torch.Tensor,  # (nb, row_words) int32
    q: torch.Tensor,  # (nq, d) f32 (cosine pre-normalized)
    rerank0: torch.Tensor,  # raw (nb, d) f32 / bf16 / int8 | sq / lvq / pq / prq codes (nb, .) uint8
    rerank1: Optional[torch.Tensor],  # sq vmin (d,) | lvq mean (d,) | pq / prq codebooks | None
    rerank2: Optional[torch.Tensor],  # sq vdiff (d,) | lvq [off, scale] (nb, 2) | None
    entry: torch.Tensor,  # (E,) int32 per-centroid resident nodes
    cents: torch.Tensor,  # (E, d) f32 routing centroids
    vmin: torch.Tensor,  # (d,) f32 walk codec
    vdiff: torch.Tensor,  # (d,) f32
    keep_mask: Optional[torch.Tensor],  # (nb,) bool or None
    *,
    W: int,
    ef: int,
    deg: int,
    n_steps: int,
    ring_slots: int,
    n_seed: int,
    k: int,
    is_l2: bool,
    has_mask: bool,
    rerank_kind: str,  # "raw" | "sq" | "lvq" | "pq" | "prq"
    bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores (nq,k) larger-is-better, exact under the stored values,
    ids (nq,k) int32, -1 padded)."""
    nq, d = q.shape
    dev = q.device
    dw = d // (32 // bits)
    G = W * deg
    qscaled = q * (vdiff / float(1 << bits))[None, :]
    qs = qscaled.to(torch.bfloat16).float()  # exact bf16 values; products exact in f32
    qconst = q @ vmin + 0.5 * qscaled.sum(1)

    def exact_scores(ids2d: torch.Tensor) -> torch.Tensor:
        dots, nrm = _decoded_scores(rerank_kind, q, rerank0, rerank1, rerank2, ids2d)
        return 2.0 * dots - nrm if is_l2 else dots

    with tracing.span("graph_inline.seed"):
        # seed: each query's n_seed nearest centroids' resident nodes, a repeated
        # node kept once (an earlier column holds it)
        cs = q @ cents.T
        if is_l2:
            cs = 2.0 * cs - (cents * cents).sum(1)[None, :]
        _, top_c = topk_leftmost(cs, n_seed)
        ids0 = entry[top_c].int()
        tri0 = torch.tril(torch.ones((n_seed, n_seed), dtype=torch.bool, device=dev), -1)
        dup0 = ((ids0[:, :, None] == ids0[:, None, :]) & tri0[None]).any(dim=2)
        ids0 = torch.where(dup0, torch.full_like(ids0, -1), ids0)
        s0 = exact_scores(ids0)
        s0 = torch.where(ids0 >= 0, s0, torch.full_like(s0, NEG))
        pad = ef - n_seed
        beam_s, beam_p = sort_desc(
            torch.cat([s0, torch.full((nq, pad), NEG, device=dev)], dim=1),
            torch.cat([torch.where(ids0 >= 0, ids0 << 1, torch.full_like(ids0, -1)),
                       torch.full((nq, pad), -1, dtype=torch.int32, device=dev)], dim=1),
        )
        visited = torch.cat([ids0, torch.full((nq, ring_slots * G), -1, dtype=torch.int32, device=dev)], dim=1)

        # masked walk: the best valid ids seen go to a pool ef wide (not k), which
        # the exact rerank below ranks (a k-wide pool of approximate scores loses
        # recall the rerank cannot repair)
        P = ef
        if has_mask:
            valid0 = keep_mask[ids0.clamp(min=0).long()] & (ids0 >= 0)
            kpad = max(0, P - n_seed)
            res_s, res_p = sort_desc(
                torch.cat([torch.where(valid0, s0, torch.full_like(s0, NEG)),
                           torch.full((nq, kpad), NEG, device=dev)], dim=1),
                torch.cat([torch.where(valid0, ids0, torch.full_like(ids0, -1)),
                           torch.full((nq, kpad), -1, dtype=torch.int32, device=dev)], dim=1),
            )
            res_s, res_p = res_s[:, :P], res_p[:, :P]

    with tracing.span("graph_inline.walk"):
        # counters (tracing on): candidates scored, those fresh
        counting = tracing.enabled()
        done = torch.zeros(nq, dtype=torch.bool, device=dev)
        cols = torch.arange(ef, device=dev)
        for i in range(n_steps):
            if i and i % DONE_CHECK_STEPS == 0:
                with tracing.span("graph_inline.done_check", wait=True):
                    finished = bool(done.all())
                if finished:
                    break
            expanded = (beam_p & 1) == 1
            bids = beam_p >> 1
            cand_s = torch.where(expanded, torch.full_like(beam_s, NEG), beam_s)
            sel_score, sel_pos = topk_leftmost(cand_s, W)
            done = done | (sel_score[:, 0] == NEG)
            sel_valid = (sel_score != NEG) & ~done[:, None]
            sel_id = torch.gather(bids, 1, sel_pos)
            hit = (cols[None, :, None] == sel_pos[:, None, :]).any(dim=2)
            beam_p = torch.where(hit, beam_p | 1, beam_p)

            rows = table[sel_id.clamp(min=0).long()]  # (nq, W, row_words)
            nbrs = rows[:, :, :deg].reshape(nq, G)
            live = torch.repeat_interleave(sel_valid & (sel_id >= 0), deg, dim=1)
            nbrs = torch.where(live, nbrs, torch.full_like(nbrs, -1))
            nrm = rows[:, :, deg : 2 * deg].contiguous().view(torch.float32).reshape(nq, G)
            if bits == 8:
                cb = rows[:, :, 2 * deg :].contiguous().view(torch.uint8).reshape(nq, G, d).float()
            else:  # 4-bit nibble planes
                cb = sq4_unpack_planes(rows[:, :, 2 * deg :].reshape(nq, G, dw)).float()
            dots_c = torch.bmm(cb, qs[:, :, None])[:, :, 0]
            scores = 2.0 * (qconst[:, None] + dots_c) - nrm if is_l2 else qconst[:, None] + dots_c

            fresh, scores, new_p = fresh_step(nbrs, visited, bids, scores, n_seed + (i % ring_slots) * G, W > 1)
            if counting:
                tracing.count("graph_inline.scored", nq * G)
                tracing.count("graph_inline.fresh", fresh.sum())

            if has_mask:
                rvalid = fresh & keep_mask[nbrs.clamp(min=0).long()]
                rs, rp = sort_desc(
                    torch.cat([res_s, torch.where(rvalid, scores, torch.full_like(scores, NEG))], dim=1),
                    torch.cat([res_p, torch.where(rvalid, nbrs, torch.full_like(nbrs, -1))], dim=1),
                )
                res_s, res_p = rs[:, :P], rp[:, :P]
            ns, npk = sort_desc(torch.cat([beam_s, scores], dim=1), torch.cat([beam_p, new_p], dim=1))
            beam_s, beam_p = ns[:, :ef], npk[:, :ef]

    with tracing.span("graph_inline.rerank"):
        # the walk's scores are approximate: rerank the candidates exactly (the
        # masked pool, or the beam, whose k-prefix is the unmasked result)
        out_ids = res_p if has_mask else beam_p >> 1
        s = exact_scores(out_ids)
        s = torch.where(out_ids >= 0, s, torch.full_like(s, NEG))
        # an id may sit twice in the pool (repeated seeds, or a masked re-append
        # once the ring wrapped): sort by id, drop consecutive repeats
        oi, order = torch.sort(out_ids, dim=1, stable=True)
        os_ = torch.gather(s, 1, order)
        dupf = torch.cat([torch.zeros_like(oi[:, :1], dtype=torch.bool), (oi[:, 1:] == oi[:, :-1]) & (oi[:, 1:] >= 0)], dim=1)
        rs, rp = sort_desc(torch.where(dupf, torch.full_like(os_, NEG), os_), torch.where(dupf, torch.full_like(oi, -1), oi))
        kk = min(k, out_ids.shape[1])
        rs, rp = rs[:, :kk], rp[:, :kk]
        if kk < k:
            rs = torch.nn.functional.pad(rs, (0, k - kk), value=NEG)
            rp = torch.nn.functional.pad(rp, (0, k - kk), value=-1)
        return rs, torch.where(rs == NEG, torch.full_like(rp, -1), rp)


class InlineGraphStore:
    """Device-resident inline table, walk codec and rerank operands; rebuilt
    (never serialized) after build, load and insert."""

    def __init__(self, table, vmin, vdiff, rerank_kind, rerank0, rerank1, rerank2, deg: int, bits: int = 8):
        self.table = table
        self.vmin = vmin
        self.vdiff = vdiff
        self.rerank_kind = rerank_kind
        self.rerank0 = rerank0
        self.rerank1 = rerank1
        self.rerank2 = rerank2
        self.deg = deg
        self.bits = bits


def _encode_chunks(nb: int, rows_fn, vmin, vdiff, bits: int):
    """Walk codes and norms of nb rows decoded chunk by chunk by rows_fn(s, e):
    (packed words (nb, dw) int32, norms (nb,) f32)."""
    levels = float(1 << bits)
    packs, nrms = [], []
    for s in range(0, nb, _TABLE_CHUNK):
        x = rows_fn(s, min(s + _TABLE_CHUNK, nb))
        c = torch.clamp(torch.floor((x - vmin[None, :]) / vdiff[None, :] * levels), 0, levels - 1)
        packs.append(sq8_pack_words(c.to(torch.uint8)) if bits == 8 else sq4_pack_words(c.int()))
        nrms.append((x * x).sum(1))
    return torch.cat(packs), torch.cat(nrms)


def _decoded_range(nb: int, rows_fn):
    """Per-dim (vmin, vdiff) of nb rows decoded chunk by chunk by
    rows_fn(s, e): vdiff = max(vmax - vmin, 1e-20)."""
    vmin = vmax = None
    for s in range(0, nb, _TABLE_CHUNK):
        x = rows_fn(s, min(s + _TABLE_CHUNK, nb))
        lo, hi = x.min(0).values, x.max(0).values
        vmin = lo if vmin is None else torch.minimum(vmin, lo)
        vmax = hi if vmax is None else torch.maximum(vmax, hi)
    return vmin, torch.clamp(vmax - vmin, min=1e-20)


def make_inline_store(
    graph_np: np.ndarray,
    kind: str,  # "raw" | "sq" | "lvq" | "pq" | "prq"
    store: Dict[str, torch.Tensor],
    x_host: Optional[np.ndarray] = None,
    bits: Optional[int] = None,
) -> Optional[InlineGraphStore]:
    """The inline table of a graph index, or None where the kind or the width
    does not fit. bits=4 (the default, KNOWHERE_INLINE_BITS) packs nibble-plane
    walk codes: half the table and half the walk's gather bytes; widths not
    divisible by 8 fall back to 8-bit codes. A raw store may hold f32, bf16 or
    int8 rows: codes and norms come from their f32 values."""
    from ..utils.bf16 import as_f32
    from .quant import sq_train

    if bits is None:
        bits = int(os.environ.get("KNOWHERE_INLINE_BITS", "4"))
    if bits not in (4, 8):
        bits = 8
    nb, deg = graph_np.shape

    def fit_bits(d: int) -> Optional[int]:
        if d % (32 // bits) == 0:
            return bits
        return 8 if bits == 4 and d % 4 == 0 else None

    if kind == "raw":
        data = store["data"]
        bits = fit_bits(int(data.shape[1]))
        if bits is None:
            return None
        if x_host is not None:
            codec = sq_train(as_f32(x_host) if np.asarray(x_host).dtype == np.uint16 else np.asarray(x_host), "SQ8")
            vmin, vdiff = to_device(codec.vmin), to_device(codec.vdiff)
        else:
            vmin = data.min(0).values.float()
            vdiff = torch.clamp(data.max(0).values.float() - vmin, min=1e-20)
        codes_w, norms = _encode_chunks(nb, lambda s, e: data[s:e].float(), vmin, vdiff, bits)
        table = build_inline_table(graph_np, codes_w, norms)
        return InlineGraphStore(table, vmin, vdiff, "raw", data, None, None, deg, bits)
    if kind == "sq":
        codes = store["codes"]  # (nb, d) uint8
        bits = fit_bits(int(codes.shape[1]))
        if bits is None:
            return None
        vmin, vdiff = store["vmin"], store["vdiff"]

        def sq_rows(s, e):
            return vmin[None, :] + (codes[s:e].float() + 0.5) * (vdiff[None, :] / 256.0)

        codes_w, norms = _encode_chunks(nb, sq_rows, vmin, vdiff, bits)
        table = build_inline_table(graph_np, codes_w, norms)
        return InlineGraphStore(table, vmin, vdiff, "sq", codes, vmin, vdiff, deg, bits)
    if kind == "lvq":
        # walk codes re-quantize the LVQ-decoded rows on one shared grid (the
        # table needs one grid so the query can be pre-scaled); the rerank
        # decodes each row's own grid exactly
        codes = store["codes"]  # (nb, d) uint8
        bits = fit_bits(int(codes.shape[1]))
        if bits is None:
            return None

        def dec_lvq(s, e):
            return decode_rows("lvq", store, torch.arange(s, e, device=codes.device))

        vmin, vdiff = _decoded_range(nb, dec_lvq)
        codes_w, norms = _encode_chunks(nb, dec_lvq, vmin, vdiff, bits)
        table = build_inline_table(graph_np, codes_w, norms)
        offscale = torch.stack([store["off"], store["scale"]], dim=1)  # (nb, 2) rerank operand
        return InlineGraphStore(table, vmin, vdiff, "lvq", codes, store["mean"], offscale, deg, bits)
    if kind in ("pq", "prq"):
        # walk codes re-quantize the decoded rows on one shared grid; the
        # rerank decodes PQ / PRQ exactly
        codes, books = store["codes"], store["codebooks"]
        d = int(books.shape[-3] * books.shape[-1])
        if d % 4 != 0:
            return None

        def dec(s, e):
            return decode_rows(kind, store, torch.arange(s, e, device=codes.device))

        vmin, vdiff = _decoded_range(nb, dec)
        bits = fit_bits(d)
        if bits is None:
            return None
        codes_w, norms = _encode_chunks(nb, dec, vmin, vdiff, bits)
        table = build_inline_table(graph_np, codes_w, norms)
        return InlineGraphStore(table, vmin, vdiff, kind, codes, books, None, deg, bits)
    return None
