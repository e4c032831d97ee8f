"""The least time the card could take for a kernel's work, and the work of
IVF_PQ's ADC scan counted from the algorithm.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W
limit), as `chip_smoke.HBM_BYTES_PER_S` / `PEAK_OPS_PER_S` have them; the
bound is `chip_smoke.bound`'s: the larger of the bytes over the memory
rate and the operations over the peak of their type.

The ADC count is of the algorithm, not of how a kernel cuts or pads its
tasks. For each request of nq queries probing nprobe lists each, with m
sub-quantizers of ksub codewords over d dimensions. Under L2 by residual
the lookup table of a (query, list) pair splits, as Faiss's precomputed
table does (the rotation of OPQ is linear, so it splits the same): a
query's inner products with every codeword (ksub x d multiply-adds, once a
query), a (list, codeword) term that depends on no query (built with the
index), and m x ksub additions a (query, probed list) pair. So:
- operations: ksub x d multiply-adds a query, m x ksub additions a (query,
  probed list) pair, and m table additions a code row of a probed list;
  all float32, the precision the algorithm states;
- bytes: each code byte of a list that any query probes, read once; the
  queries, the probed lists' centroids, their (m, ksub) float32 terms of
  the precomputed table and the codebooks read once; each query's
  candidates (k x refine_k, a float32 score and an int32 id) written once.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound_s(nbytes: float, ops: Dict[str, float]) -> float:
    """Least seconds for `nbytes` moved and `ops` ({operand type: count})."""
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def adc_work(probed_sizes: np.ndarray, n_lists_probed: int, lists_code_rows: int, nq: int, d: int, m: int,
             ksub: int, nbits: int, n_out: int) -> Tuple[float, Dict[str, float]]:
    """(bytes, {"f32": operations}) of one ADC scan.

    probed_sizes: the sizes of every (query, probed list) pair, (nq, nprobe);
    n_lists_probed: the lists some query probes; lists_code_rows: their rows;
    n_out: candidates written per query."""
    nprobe = probed_sizes.shape[1]
    lut = nq * ksub * d * 2.0 + nq * nprobe * m * ksub
    scan = float(probed_sizes.sum()) * m
    code_bytes = lists_code_rows * m * nbits / 8.0
    tables = n_lists_probed * (d + m * ksub) * 4.0  # the probed lists' centroids and precomputed terms
    nbytes = code_bytes + nq * d * 4.0 + tables + m * ksub * (d // m) * 4.0 + nq * n_out * 8.0
    return nbytes, {"f32": lut + scan}


def coarse_probe(xq: torch.Tensor, centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Each query's nprobe nearest centroids under squared L2, full f32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d = (xq * xq).sum(1, keepdim=True) - 2.0 * xq @ centroids.T + (centroids * centroids).sum(1)[None, :]
        return torch.topk(d, nprobe, dim=1, largest=False).indices
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def adc_request_bound_s(xq: torch.Tensor, centroids: torch.Tensor, list_sizes: torch.Tensor, nprobe: int,
                        m: int, ksub: int, nbits: int, n_out: int) -> float:
    """Least seconds of the ADC work of one request's queries."""
    probes = coarse_probe(xq, centroids, nprobe)
    sizes = list_sizes[probes]
    lists = torch.unique(probes)
    nbytes, ops = adc_work(sizes.cpu().numpy(), int(lists.numel()), int(list_sizes[lists].sum()), xq.shape[0],
                           xq.shape[1], m, ksub, nbits, n_out)
    return bound_s(nbytes, ops)


def read_sections(blob: bytes) -> Tuple[Dict[str, np.ndarray], dict]:
    """The named arrays and meta of a serialized index section, Knowhere
    port's documented layout: magic "KWTPU\\x01", a u32 header length, a
    JSON header of {offset, nbytes, dtype, shape} per section."""
    magic = b"KWTPU\x01"
    if blob[: len(magic)] != magic:
        raise ValueError("not a KWTPU section")
    n = int(np.frombuffer(blob[len(magic) : len(magic) + 4], dtype=np.uint32)[0])
    header = json.loads(blob[len(magic) + 4 : len(magic) + 4 + n])
    arrays = {}
    for name, s in header["sections"].items():
        if s["dtype"] == "bfloat16":
            continue
        raw = blob[s["offset"] : s["offset"] + s["nbytes"]]
        arrays[name] = np.frombuffer(raw, dtype=np.dtype(s["dtype"])).reshape(s["shape"])
    return arrays, header.get("meta", {})
