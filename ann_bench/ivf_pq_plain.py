"""The plain IVF_PQ reference: the search an IVF_PQ index with OPQ and an
FP16 refine store answers, in plain PyTorch float32 with TF32 off.

It imports nothing of the program and no kernel. It reads the built index's
arrays from its `Serialize` blob (`roofline.read_sections`): the coarse
centroids, the OPQ rotation R, the PQ codebooks, the codes in the index's
list-sorted storage with each list's offset and true length, the row ids and
the refine rows. For each query:

1. the nprobe nearest centroids by squared L2 taken by differences,
   leftmost on ties;
2. each probed row's ADC distance ||R (q - c) - decode(code)||^2, c its
   list's centroid, from the decoded codewords by differences: no lookup
   table, no bf16;
3. the k x refine_k best rows by ADC distance (leftmost on ties, in the
   order of the probes, then of the rows of a list);
4. their exact squared L2 to the refine rows, read as f32, by differences;
5. the k best of those.

Queries go in blocks (`q_block`), and the ADC differences in chunks of at
most `CHUNK_BYTES`, so the search fits on one card at 1M x 960.

Departures from Knowhere (faiss IndexIVFPQ under an IndexRefine):
- OPQ is the port's own knob (its IVF_PQ rotates by default); faiss's
  IVFPQ has none unless an OPQ matrix is put in front of it;
- faiss scores the coarse probe and the ADC by inner products and a
  precomputed table (||c||^2 - 2 <q, c>, then table sums); this takes the
  same distances by differences;
- the port's ensure_topk_full re-probes a query whose probed lists hold
  fewer than k rows; this returns -1 / +inf for the missing entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ann_bench.roofline import read_sections

CHUNK_BYTES = 256 << 20  # f32 differences one step of the ADC or the probe may hold


@dataclass
class PlainIvfPq:
    centroids: torch.Tensor  # (nlist, d) f32
    rotation: torch.Tensor  # (d, d) f32: the scan frame is x @ R.T
    codebooks: torch.Tensor  # (m, ksub, sub) f32
    codes: torch.Tensor  # (nb_pad, m) uint8, list-sorted storage
    offsets: np.ndarray  # (nlist + 1,) storage start of each list
    lengths: np.ndarray  # (nlist,) true rows of each list
    row_ids: torch.Tensor  # (nb_pad,) int64, -1 at padding
    refine: torch.Tensor  # (nb_pad, d) refine rows, as stored


def load(blob: bytes, device) -> PlainIvfPq:
    """The reference's copy of a serialized IVF_PQ index ("IVF_PQ" section of
    its BinarySet) on `device`."""
    arrays, meta = read_sections(blob)
    if meta.get("variant") != "pq" or "payload_refine" not in arrays:
        raise ValueError("not an IVF_PQ index with a refine store the reference reads (FP16 or f32 rows)")
    dim = int(meta["dim"])
    rot = arrays.get("opq_rotation")

    def dev(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy: the blob's views are read-only

    return PlainIvfPq(
        centroids=dev(arrays["centroids"], np.float32),
        rotation=dev(np.eye(dim, dtype=np.float32) if rot is None else rot, np.float32),
        codebooks=dev(arrays["pq_codebooks"], np.float32),
        codes=dev(arrays["payload_codes"]),
        offsets=np.array(arrays["offsets"], np.int64),
        lengths=np.array(arrays["lengths"], np.int64),
        row_ids=dev(arrays["row_ids"], np.int64),
        refine=dev(arrays["payload_refine"]),
    )


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 between every row of a (n, d) and of b (r, d), by
    differences in f32: (n, r), in steps of at most CHUNK_BYTES."""
    step = max(1, CHUNK_BYTES // max(1, 4 * a.shape[0] * a.shape[1]))
    return torch.cat([((a[:, None, :] - b[None, r0 : r0 + step, :]) ** 2).sum(-1)
                      for r0 in range(0, b.shape[0], step)], 1)


def _smallest(d: torch.Tensor, n: int) -> torch.Tensor:
    """Columns of each row's n smallest values, ascending, leftmost on ties."""
    return torch.sort(d, dim=1, stable=True).indices[:, :n]


def _decode(index: PlainIvfPq, pos: torch.Tensor) -> torch.Tensor:
    """The codewords of the rows at storage positions pos: (n, m * sub)."""
    m = index.codebooks.shape[0]
    codes = index.codes[pos].long()  # (n, m)
    return index.codebooks[torch.arange(m, device=codes.device)[None, :], codes].reshape(len(pos), -1)


def _block(index: PlainIvfPq, xq: torch.Tensor, k: int, nprobe: int, refine_k: int):
    nq, dim = xq.shape
    nlist = index.centroids.shape[0]
    probes = _smallest(_sq_dist(xq, index.centroids), min(nprobe, nlist))  # (nq, nprobe)
    width = int(index.lengths.max())
    adc = torch.full((nq, probes.shape[1], width), float("inf"), device=xq.device)
    probes_h = probes.cpu().numpy()
    for lst in np.unique(probes_h):
        n_l = int(index.lengths[lst])
        if n_l == 0:
            continue
        qi, pi = np.nonzero(probes_h == lst)
        qi_t, pi_t = torch.from_numpy(qi).to(xq.device), torch.from_numpy(pi).to(xq.device)
        resid = (xq[qi_t] - index.centroids[lst]) @ index.rotation.T  # R (q - c), as rows
        pos = torch.arange(int(index.offsets[lst]), int(index.offsets[lst]) + n_l, device=xq.device)
        adc[qi_t, pi_t, :n_l] = _sq_dist(resid, _decode(index, pos))
    n_cand = k * max(1, refine_k)
    flat = adc.reshape(nq, -1)
    sel = _smallest(flat, min(n_cand, flat.shape[1]))
    adc_d = torch.gather(flat, 1, sel)
    starts = torch.from_numpy(index.offsets[:-1]).to(xq.device)
    cand = torch.where(torch.isinf(adc_d), torch.full_like(sel, -1),
                       starts[torch.gather(probes, 1, sel // width)] + sel % width)
    rows = index.refine[cand.clamp(min=0)].float()  # (nq, n_cand, d)
    ref_d = ((xq[:, None, :] - rows) ** 2).sum(-1)
    ref_d = torch.where(cand >= 0, ref_d, torch.full_like(ref_d, float("inf")))
    top = _smallest(ref_d, min(k, ref_d.shape[1]))
    dists = torch.gather(ref_d, 1, top)
    pos = torch.gather(cand, 1, top)
    ids = torch.where(pos >= 0, index.row_ids[pos.clamp(min=0)], torch.full_like(pos, -1))
    if dists.shape[1] < k:
        dists = torch.nn.functional.pad(dists, (0, k - dists.shape[1]), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]), value=-1)
    return dists, ids, {"probes": probes, "adc_pos": cand, "adc_dist": adc_d}


def search(index: PlainIvfPq, xq: torch.Tensor, k: int, nprobe: int, refine_k: int,
           q_block: int = 64) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(squared L2 distances (nq, k) ascending, row ids (nq, k) int64, the
    intermediate results: `probes` (nq, nprobe), the ADC pool's storage
    positions `adc_pos` (nq, k x refine_k, -1 past the probed rows) and its
    distances `adc_dist`, ascending)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        parts = [_block(index, xq[q0 : q0 + q_block].float(), k, nprobe, refine_k)
                 for q0 in range(0, xq.shape[0], q_block)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    stages = {key: torch.cat([p[2][key] for p in parts]) for key in parts[0][2]}
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]), stages
