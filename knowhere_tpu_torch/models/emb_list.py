"""emb_list: multi-vector (late-interaction) documents, MAX_SIM / DTW
(counterpart of knowhere_tpu/models/emb_list.py).

Behavioral parity target: the reference's emb_list machinery in the IndexNode
base + strategies (reference: include/knowhere/index/index_node.h:388-523
Build/Search/SerializeEmbListIfNeed glue, src/index/index_node.cc:251-293
two-stage search; src/index/emb_list/emb_list_strategy_tokenann.cc,
emb_list_strategy_muvera.cc:89-431 SimHash-partitioned FDE,
emb_list_strategy_lemur.cc + simple_mlp.h learned compression;
include/knowhere/emb_list_utils.h EmbListOffset).

A document is a list of vectors: dataset tensor (total_tokens, dim) + lims
(ndocs+1). Metrics: MAX_SIM[_COSINE|_IP|_L2|...] (sum over query tokens of the
best token match) and DTW[_*] (dynamic-time-warping aggregate). Strategies:

- tokenann: index every token in an underlying ANN index; stage 1 retrieves
  token neighbors per query token; stage 2 reranks candidate docs exactly.
- muvera: fixed-dimensional encoding: tokens are SimHash-partitioned
  (num_projections sign bits, num_repeats independent repetitions) and summed
  per partition after a random down-projection (the planes and projections
  drawn from np.random.default_rng(seed) as the reference draws them); docs
  become single FDE vectors in the underlying index; exact rerank follows.
- lemur: a small MLP (an nn.Module whose layers hold (in, out) weights, so
  the mlp_w{i} / mlp_b{i} sections keep the reference's layout), trained in
  process with torch.optim.Adam from a seeded torch.Generator, maps tokens to
  a learned space whose mean-pool approximates MaxSim ranking; pooled vectors
  are indexed; exact rerank follows.

The corpus tokens stay on the device (f32) for stage 2: every (query,
candidate document) pair of a block is gathered there, padded to the longest
document, and scored by one batched product; DTW runs an anti-diagonal
wavefront over every pair of the block at once. Each query's top-k is
ordered by score, then by document id (the reference's stable argsort over
ascending candidate ids).

A dataset without lims answers invalid_args (the JAX package raises a
TypeError there, internal_error).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..binaryset import BinarySet
from ..bitset import BitsetView
from ..config import Config, Stage
from ..dataset import DataSet, GenDataSetFromArray, GenResultDataSet
from ..device import get_device, to_device
from ..index_param import DTW_METRICS, metric as M, normalize_metric
from ..io.serialize import read_sections, write_sections
from ..ops.kmeans import cluster_sums
from ..status import KnowhereException, Status, expected
from ..utils.bf16 import as_f32

# emb_list metric -> underlying token metric (reference index_param.h:255-275)
_BASE_METRIC = {
    M.MAX_SIM: M.COSINE,
    M.MAX_SIM_COSINE: M.COSINE,
    M.MAX_SIM_IP: M.IP,
    M.MAX_SIM_L2: M.L2,
    M.MAX_SIM_HAMMING: M.HAMMING,
    M.MAX_SIM_JACCARD: M.JACCARD,
    M.DTW: M.COSINE,
    M.DTW_COSINE: M.COSINE,
    M.DTW_IP: M.IP,
    M.DTW_L2: M.L2,
    M.DTW_HAMMING: M.HAMMING,
    M.DTW_JACCARD: M.JACCARD,
}

# device bytes one block of stage 2 may gather: each pair's padded
# document rows, its query rows, and their similarity tile (and DTW's table)
PAIR_BLOCK_BYTES = 1 << 30
TOKEN_CHUNK = 1 << 18  # tokens through the MUVERA projections or the LEMUR MLP a step
_DTW_NEG = np.float32(-1e30)


def is_emb_list_metric(m: str) -> bool:
    return m.upper() in _BASE_METRIC


def _lims(dataset: DataSet) -> np.ndarray:
    if dataset.lims is None:
        raise KnowhereException("emb_list dataset requires lims", Status.invalid_args)
    lims = np.asarray(dataset.lims, dtype=np.int64)
    if len(lims) < 2:
        raise KnowhereException("emb_list dataset requires lims", Status.invalid_args)
    return lims


class EmbListOffset:
    """Offset table: token position -> doc id (reference emb_list_utils.h:29-60)."""

    def __init__(self, lims: np.ndarray):
        self.lims = np.asarray(lims, dtype=np.int64)

    @property
    def num_docs(self) -> int:
        return len(self.lims) - 1

    def doc_of_token(self, token_ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.lims, token_ids, side="right") - 1

    def tokens_of_doc(self, doc: int) -> Tuple[int, int]:
        return int(self.lims[doc]), int(self.lims[doc + 1])


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------


def max_sim_score(sim: np.ndarray) -> float:
    """Sum over query tokens of the best document-token similarity."""
    if sim.size == 0:
        return -np.inf
    return float(sim.max(axis=1).sum())


def dtw_score(sim: np.ndarray) -> float:
    """DTW aggregate over the (query_tokens x doc_tokens) similarity grid:
    maximize accumulated similarity along a monotone alignment path."""
    nq, nd = sim.shape
    if nq == 0 or nd == 0:
        return -np.inf
    acc = np.full((nq + 1, nd + 1), -np.inf)
    acc[0, 0] = 0.0
    for i in range(1, nq + 1):
        for j in range(1, nd + 1):
            best_prev = max(acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
            acc[i, j] = sim[i - 1, j - 1] + best_prev
    return float(acc[nq, nd])


def dtw_wavefront(sim: torch.Tensor, q_lens: torch.Tensor, d_lens: torch.Tensor) -> torch.Tensor:
    """DTW aggregate of every pair at once: sim (P, L, T) f32, pair p's grid
    its first q_lens[p] rows and d_lens[p] columns. Cell (i, j) is
    sim + the max of its three predecessors, computed one anti-diagonal at a
    time over every pair (the table has a border row and column of -1e30 and
    a 0 corner, the reference's start). Returns (P,) f32, -inf where a
    grid is empty."""
    P, L, T = sim.shape
    acc = torch.full((P, L + 1, T + 1), float(_DTW_NEG), dtype=torch.float32, device=sim.device)
    acc[:, 0, 0] = 0.0
    flat = acc.view(P, -1)
    s_flat = sim.reshape(P, -1)
    W = T + 1
    for dg in range(L + T - 1):
        ii = torch.arange(max(0, dg - T + 1), min(L - 1, dg) + 1, device=sim.device)
        jj = dg - ii
        up_left = flat[:, ii * W + jj]
        up = flat[:, ii * W + jj + 1]
        left = flat[:, (ii + 1) * W + jj]
        flat[:, (ii + 1) * W + jj + 1] = s_flat[:, ii * T + jj] + torch.maximum(torch.maximum(up_left, up), left)
    out = acc[torch.arange(P, device=sim.device), q_lens, d_lens]
    return torch.where((q_lens > 0) & (d_lens > 0), out, torch.full_like(out, -float("inf")))


def _segments(sim: np.ndarray, col_starts, col_ends) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column segments of one (nq_tok, total) tile as a padded (C, nq_tok,
    max len) tensor on the device (padding -1e30), their lengths and the
    (C, max len) mask of real columns."""
    starts = np.asarray(col_starts, np.int64)
    lens = np.asarray(col_ends, np.int64) - starts
    width = max(int(lens.max(initial=0)), 1)
    cols = starts[:, None] + np.arange(width)[None, :]
    valid = np.arange(width)[None, :] < lens[:, None]
    s = to_device(np.asarray(sim, np.float32))
    seg = s[:, torch.from_numpy(np.where(valid, cols, 0)).to(s.device)].permute(1, 0, 2)
    valid = to_device(valid)
    seg = torch.where(valid[:, None, :], seg, torch.full_like(seg, float(_DTW_NEG)))
    return seg, to_device(lens), valid


def dtw_scores_batch(sim: np.ndarray, col_starts: np.ndarray, col_ends: np.ndarray) -> np.ndarray:
    """DTW aggregate for many candidate documents at once (the columns
    [col_starts[c], col_ends[c]) of one similarity tile), by dtw_wavefront."""
    seg, lens, _ = _segments(sim, col_starts, col_ends)
    q_lens = torch.full_like(lens, seg.shape[1])
    return dtw_wavefront(seg, q_lens, lens).cpu().numpy()


def max_sim_scores_batch(sim: np.ndarray, col_starts: np.ndarray, col_ends: np.ndarray) -> np.ndarray:
    """MaxSim for many candidates: per-query-token best within each column
    segment, summed; -inf for an empty segment."""
    seg, lens, valid = _segments(sim, col_starts, col_ends)
    seg = torch.where(valid[:, None, :], seg, torch.full_like(seg, -float("inf")))
    out = seg.max(dim=2).values.sum(dim=1)
    return torch.where(lens > 0, out, torch.full_like(out, -float("inf"))).cpu().numpy()


def _token_sims(qv: torch.Tensor, dv: torch.Tensor, base_metric: str) -> torch.Tensor:
    """(P, La, d) x (P, Tb, d) -> (P, La, Tb) similarities (larger is
    better) of the token metric, per pair: pairwise_distance's formulas
    (cosine zero-norm-safe; L2 and the binary metrics negated)."""
    dots = torch.bmm(qv, dv.transpose(1, 2))
    if base_metric == M.IP:
        return dots
    if base_metric == M.COSINE:
        qn = torch.sqrt((qv * qv).sum(2))
        dn = torch.sqrt((dv * dv).sum(2))
        one = torch.ones((), device=qv.device)
        return dots / (torch.where(qn == 0.0, one, qn)[:, :, None] * torch.where(dn == 0.0, one, dn)[:, None, :])
    if base_metric == M.L2:
        qn = (qv * qv).sum(2)
        dn = (dv * dv).sum(2)
        return -torch.clamp(qn[:, :, None] - 2.0 * dots + dn[:, None, :], min=0.0)
    qp, dp = qv.sum(2)[:, :, None], dv.sum(2)[:, None, :]
    if base_metric == M.HAMMING:
        return -(qp + dp - 2.0 * dots)
    union = qp + dp - dots
    return -torch.where(union == 0.0, torch.zeros_like(union), 1.0 - dots / union)


def _padded_index(starts: torch.Tensor, lens: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, width) token positions starts[p] + t and their validity t < lens[p]."""
    t = torch.arange(width, device=starts.device)
    valid = t[None, :] < lens[:, None]
    return torch.where(valid, starts[:, None] + t[None, :], torch.zeros_like(valid, dtype=torch.long)), valid


def score_pairs(
    a_tok: torch.Tensor, a_starts: torch.Tensor, a_lens: torch.Tensor,
    b_tok: torch.Tensor, b_starts: torch.Tensor, b_lens: torch.Tensor,
    base_metric: str, dtw: bool,
) -> torch.Tensor:
    """Pair p's aggregate of the token lists a_tok[a_starts[p]:+a_lens[p]]
    (the query side) and b_tok[b_starts[p]:+b_lens[p]] (the document):
    MaxSim (each query token's best document token, summed) or DTW; -inf
    for an empty document. Pairs go in blocks under PAIR_BLOCK_BYTES."""
    P = int(a_starts.numel())
    out = torch.empty(P, dtype=torch.float32, device=a_tok.device)
    if P == 0:
        return out
    La = max(int(a_lens.max()), 1)
    Tb = max(int(b_lens.max()), 1)
    d = a_tok.shape[1]
    per_pair = 4 * ((La + Tb) * d + 2 * La * Tb + (La + 1) * (Tb + 1))
    step = max(1, PAIR_BLOCK_BYTES // per_pair)
    for s in range(0, P, step):
        sl = slice(s, min(P, s + step))
        a_idx, a_ok = _padded_index(a_starts[sl], a_lens[sl], La)
        b_idx, b_ok = _padded_index(b_starts[sl], b_lens[sl], Tb)
        sim = _token_sims(a_tok[a_idx], b_tok[b_idx], base_metric)
        if dtw:
            out[sl] = dtw_wavefront(sim, a_lens[sl], b_lens[sl])
            continue
        best = torch.where(b_ok[:, None, :], sim, torch.full_like(sim, -float("inf"))).max(dim=2).values
        agg = torch.where(a_ok, best, torch.zeros_like(best)).sum(dim=1)
        out[sl] = torch.where(b_lens[sl] > 0, agg, torch.full_like(agg, -float("inf")))
    return out


def _doc_of_token(lims: np.ndarray) -> np.ndarray:
    return (np.searchsorted(lims, np.arange(int(lims[-1])), side="right") - 1).astype(np.int64)


def _segment_mean(h: torch.Tensor, lims: np.ndarray) -> torch.Tensor:
    """Per-document mean of the rows of h (tokens in document order)."""
    n = len(lims) - 1
    counts = to_device(np.diff(lims)).float()
    sums = cluster_sums(h, to_device(_doc_of_token(lims)), n)
    return sums / counts[:, None]


class LemurMLP(torch.nn.Module):
    """The LEMUR MLP: layers of (in, out) weights, h @ w + b, ReLU between
    layers (the reference's simple_mlp.h and mlp_w{i} / mlp_b{i} layout)."""

    def __init__(self, ws: List[torch.Tensor], bs: List[torch.Tensor]):
        super().__init__()
        self.w = torch.nn.ParameterList([torch.nn.Parameter(w) for w in ws])
        self.b = torch.nn.ParameterList([torch.nn.Parameter(b) for b in bs])

    @classmethod
    def init(cls, dims: List[int], seed: int) -> "LemurMLP":
        """He-normal weights from a seeded CPU generator, zero biases."""
        g = torch.Generator().manual_seed(seed)
        ws = [torch.randn(dims[i], dims[i + 1], generator=g) * float(np.sqrt(2.0 / dims[i])) for i in range(len(dims) - 1)]
        bs = [torch.zeros(dims[i + 1]) for i in range(len(dims) - 1)]
        return cls([w.to(get_device()) for w in ws], [b.to(get_device()) for b in bs])

    @classmethod
    def from_params(cls, params: List[Dict[str, np.ndarray]]) -> "LemurMLP":
        return cls([to_device(np.asarray(p["w"], np.float32)) for p in params],
                   [to_device(np.asarray(p["b"], np.float32)) for p in params])

    def params(self) -> List[Dict[str, np.ndarray]]:
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            h = h @ w + b
            if i < len(self.w) - 1:
                h = torch.relu(h)
        return h

    @torch.no_grad()
    def pooled(self, tokens: torch.Tensor, lims: np.ndarray) -> torch.Tensor:
        """Per-document mean of the MLP's token outputs."""
        h = torch.cat([self(tokens[s : s + TOKEN_CHUNK]) for s in range(0, tokens.shape[0], TOKEN_CHUNK)])
        return _segment_mean(h, lims)


class EmbListIndex:
    """Adapter holding an underlying dense index + the emb_list strategy.

    Created by the facade when the config metric is MAX_SIM_*/DTW_* and the
    wrapped index type supports emb_list (reference BuildEmbListIfNeed)."""

    def __init__(self, make_underlying, index_type: str):
        self._make_underlying = make_underlying
        self.index_type = index_type
        self._under = None  # IndexNode
        self._offset: Optional[EmbListOffset] = None
        self._tokens: Optional[np.ndarray] = None  # raw token vectors, as given
        self._tok_dev: Optional[torch.Tensor] = None  # the same as f32 on the device (stage 2)
        self._metric = M.MAX_SIM_COSINE
        self._strategy = "tokenann"
        self._fde_params: Dict = {}
        self._mlp_params = None  # [{"w": (in, out), "b": (out,)}] host arrays
        self._mlp: Optional[LemurMLP] = None

    def _device_tokens(self) -> torch.Tensor:
        if self._tok_dev is None:
            self._tok_dev = to_device(as_f32(self._tokens))
        return self._tok_dev

    # --- strategies: doc -> retrieval vectors ------------------------------------
    def _muvera_fde(self, tokens: torch.Tensor, lims: np.ndarray, query: bool = False) -> np.ndarray:
        p = self._fde_params
        rng = np.random.default_rng(p["seed"])
        n_bits = int(p["num_projections"])  # uncapped, as in the reference
        B = 1 << n_bits
        reps = int(p["num_repeats"])
        d = tokens.shape[1]
        d_proj = min(d, max(8, 64 // max(reps // 4, 1)))
        if reps * B * d_proj > (1 << 22):
            # refuse loudly instead of silently shrinking the FDE
            raise KnowhereException(
                f"muvera FDE dim {reps * B * d_proj} too large "
                f"(num_projections={n_bits}, num_repeats={reps})",
                Status.invalid_args,
            )
        planes, projs = [], []
        for _ in range(reps):
            planes.append(rng.standard_normal((d, n_bits)).astype(np.float32))
            projs.append((rng.standard_normal((d, d_proj)).astype(np.float32) / np.sqrt(d)).astype(np.float32))
        ndocs = len(lims) - 1
        doc_of_tok = to_device(_doc_of_token(lims))
        counts = None if query else to_device(np.diff(lims))
        weights = 1 << torch.arange(n_bits, device=tokens.device)
        out = torch.zeros((ndocs, reps * B * d_proj), dtype=torch.float32, device=tokens.device)
        for r in range(reps):
            plane, proj = to_device(planes[r]), to_device(projs[r])
            parts, prows = [], []
            for s in range(0, tokens.shape[0], TOKEN_CHUNK):
                t = tokens[s : s + TOKEN_CHUNK]
                parts.append((((t @ plane) > 0).long() * weights).sum(1))
                prows.append(t @ proj)
            # every token into its (doc, partition) cell, added in token order
            seg = cluster_sums(torch.cat(prows), doc_of_tok * B + torch.cat(parts), ndocs * B).view(ndocs, B, d_proj)
            if counts is not None:
                cnt = torch.bincount(doc_of_tok * B + torch.cat(parts), minlength=ndocs * B).view(ndocs, B).float()
                seg = torch.where(cnt[:, :, None] > 0, seg / cnt.clamp(min=1.0)[:, :, None], seg)  # partition centroid
            out[:, r * B * d_proj : (r + 1) * B * d_proj] = seg.reshape(ndocs, B * d_proj)
        return out.cpu().numpy()

    def _train_lemur(self, tokens: torch.Tensor, lims: np.ndarray, cfg: Config) -> np.ndarray:
        """Train the LEMUR MLP in-process (reference simple_mlp.h SGD loop):
        Adam on the squared error between the pooled pair's inner product
        and its exact MaxSim per query token."""
        hidden = int(cfg.get("lemur_hidden_dim", 128) or 128)
        layers = int(cfg.get("lemur_num_layers", 2) or 2)
        epochs = int(cfg.get("lemur_num_epochs", 10) or 10)
        batch = int(cfg.get("lemur_batch_size", 256) or 256)
        lr = float(cfg.get("lemur_learning_rate", 1e-3) or 1e-3)
        n_samples = int(cfg.get("lemur_num_train_samples", 10000) or 10000)
        seed = int(cfg.get("lemur_seed", 0) or 0)
        base_metric = _BASE_METRIC[self._metric]

        rng = np.random.default_rng(seed)
        d = tokens.shape[1]
        mlp = LemurMLP.init([d] + [hidden] * layers, seed)

        ndocs = len(lims) - 1
        # training pairs: (doc_i, doc_j) with exact MaxSim target
        n_pairs = min(n_samples, max(ndocs * 4, 64))
        di = rng.integers(0, ndocs, n_pairs)
        dj = rng.integers(0, ndocs, n_pairs)
        starts, lens = lims[:-1], np.diff(lims)
        s_i, l_i = to_device(starts[di]), to_device(lens[di])
        s_j, l_j = to_device(starts[dj]), to_device(lens[dj])
        targets = score_pairs(tokens, s_i, l_i, tokens, s_j, l_j, base_metric, dtw=False)
        targets = targets / l_i.clamp(min=1).float()
        max_tok = int(max(lens[di].max(), lens[dj].max()))

        def pad_docs(sel_s, sel_l):
            idx, ok = _padded_index(sel_s, sel_l, max_tok)
            m = ok.float()
            return tokens[idx] * m[:, :, None], m

        def pool(xa, ma):
            h = mlp(xa)
            return (h * ma[:, :, None]).sum(1) / torch.clamp(ma.sum(1, keepdim=True), min=1.0)

        opt = torch.optim.Adam(mlp.parameters(), lr=lr)
        for _ in range(epochs):
            perm = rng.permutation(n_pairs)
            for s0 in range(0, n_pairs, batch):
                sel = perm[s0 : s0 + batch]
                if len(sel) < 2:
                    continue
                sel_t = to_device(sel)
                xa, ma = pad_docs(s_i[sel_t], l_i[sel_t])
                xb, mb = pad_docs(s_j[sel_t], l_j[sel_t])
                pred = (pool(xa, ma) * pool(xb, mb)).sum(1)
                loss = ((pred - targets[sel_t]) ** 2).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
        self._mlp = mlp
        self._mlp_params = mlp.params()
        return mlp.pooled(tokens, lims).cpu().numpy()

    def _lemur_encode_queries(self, q_tokens: torch.Tensor, q_lims: np.ndarray) -> np.ndarray:
        if self._mlp is None:
            self._mlp = LemurMLP.from_params(self._mlp_params)
        return self._mlp.pooled(q_tokens, q_lims).cpu().numpy()

    # --- lifecycle ----------------------------------------------------------------
    def Build(self, dataset: DataSet, cfg: Config) -> Status:
        self._metric = normalize_metric(cfg.metric_type)
        if self._metric not in _BASE_METRIC:
            return Status.invalid_metric_type
        lims = _lims(dataset)
        tokens = np.asarray(dataset.tensor)
        self._offset = EmbListOffset(lims)
        self._tokens = tokens
        self._tok_dev = None
        self._mlp, self._mlp_params = None, None
        self._strategy = (cfg.get("emb_list_strategy") or "tokenann").lower()
        base_metric = _BASE_METRIC[self._metric]

        self._under = self._make_underlying()
        if self._strategy == "tokenann":
            retrieval = tokens
            retrieval_metric = base_metric
        elif self._strategy == "muvera":
            self._fde_params = {
                "num_projections": cfg.get("muvera_num_projections", 8) or 8,
                "num_repeats": cfg.get("muvera_num_repeats", 10) or 10,
                "seed": cfg.get("muvera_seed", 0) or 0,
            }
            retrieval = self._muvera_fde(self._device_tokens(), lims)
            retrieval_metric = M.IP
        elif self._strategy == "lemur":
            retrieval = self._train_lemur(self._device_tokens(), lims, cfg)
            retrieval_metric = M.IP
        else:
            return Status.invalid_value_in_json
        self._retrieval_metric = retrieval_metric

        under_cfg = self._under.CreateConfig()
        raw_cfg = cfg.to_dict()
        raw_cfg["metric_type"] = retrieval_metric
        st, msg = Config.load(under_cfg, raw_cfg, Stage.TRAIN)
        if st != Status.success:
            raise KnowhereException(msg, st)
        return self._under.Build(GenDataSetFromArray(np.ascontiguousarray(retrieval)), under_cfg)

    # --- search -------------------------------------------------------------------
    def _candidates(self, q_tokens: np.ndarray, q_lims: np.ndarray, k: int, ratio: float):
        """Stage 1: the (query, document) candidate pairs, sorted by query,
        then document id (each query's unique documents), on the device;
        or an expected error of the underlying search."""
        nq = len(q_lims) - 1
        ndocs = self._offset.num_docs
        under_cfg = self._under.CreateConfig()
        if self._strategy == "tokenann":
            kk = int(min(max(k * max(ratio, 1.0), k) * 4, max(self._tokens.shape[0], 1)))
            Config.load(under_cfg, {"metric_type": self._retrieval_metric, "k": kk}, Stage.SEARCH)
            res = self._under.Search(GenDataSetFromArray(q_tokens), under_cfg, BitsetView.empty())
            if not res.has_value():
                return res
            hit = to_device(res.value().ids.reshape(q_tokens.shape[0], kk))
            row_q = to_device(np.repeat(np.arange(nq, dtype=np.int64), np.diff(q_lims)))
            lims_dev = to_device(self._offset.lims)
            docs = torch.searchsorted(lims_dev, hit.clamp(min=0), right=True) - 1
        else:
            q_dev = to_device(as_f32(q_tokens))
            q_vec = (
                self._muvera_fde(q_dev, q_lims, query=True)
                if self._strategy == "muvera"
                else self._lemur_encode_queries(q_dev, q_lims)
            )
            kk = int(min(max(k * max(ratio, 1.0) * 4, k), ndocs))
            Config.load(under_cfg, {"metric_type": self._retrieval_metric, "k": kk}, Stage.SEARCH)
            res = self._under.Search(GenDataSetFromArray(q_vec), under_cfg, BitsetView.empty())
            if not res.has_value():
                return res
            hit = to_device(res.value().ids.reshape(nq, kk))
            row_q = torch.arange(nq, device=hit.device)
            docs = hit
        key = (row_q[:, None] * ndocs + docs)[hit >= 0]
        key = torch.unique(key)  # sorted: by query, then document
        return key // ndocs, key % ndocs

    def Search(self, dataset: DataSet, cfg: Config, bitset: BitsetView) -> "expected[DataSet]":
        if self._under is None:
            return expected.Err(Status.empty_index, "emb_list index not built")
        metric = normalize_metric(cfg.metric_type)
        if metric != self._metric:
            return expected.Err(Status.invalid_metric_type, "metric mismatch")
        q_lims = _lims(dataset)
        q_tokens = np.asarray(dataset.tensor)
        nq = len(q_lims) - 1
        k = cfg.k
        ratio = float(cfg.get("retrieval_ann_ratio", 1.0) or 1.0)
        rerank = bool(cfg.get("emb_list_rerank", True))

        cand = self._candidates(q_tokens, q_lims, k, ratio)
        if isinstance(cand, expected):
            return cand
        qidx, docs = cand
        # doc-level bitset filtering
        if not bitset.empty_view():
            keep = to_device(bitset.host_mask(self._offset.num_docs))[docs]
            qidx, docs = qidx[keep], docs[keep]

        # stage 2: exact rerank with the emb_list aggregate
        counts = torch.bincount(qidx, minlength=nq)
        first = torch.cumsum(counts, 0) - counts
        if rerank or self._strategy == "tokenann":
            q_dev = to_device(as_f32(q_tokens))
            lims_dev = to_device(self._offset.lims)
            q_lims_dev = to_device(q_lims)
            scores = score_pairs(
                q_dev, q_lims_dev[qidx], q_lims_dev[qidx + 1] - q_lims_dev[qidx],
                self._device_tokens(), lims_dev[docs], lims_dev[docs + 1] - lims_dev[docs],
                _BASE_METRIC[self._metric], self._metric in DTW_METRICS,
            )
        else:  # keep ANN order
            scores = -(torch.arange(qidx.numel(), device=qidx.device) - first[qidx]).float()
        # by query, then score (descending), then document id: both sorts stable
        order = torch.sort(scores, descending=True, stable=True).indices
        order = order[torch.sort(qidx[order], stable=True).indices]
        rank = torch.arange(order.numel(), device=order.device) - first[qidx[order]]
        top = order[rank < k]
        out_ids = np.full((nq, k), -1, np.int64)
        out_d = np.zeros((nq, k), np.float32)
        rows, cols = qidx[top].cpu().numpy(), rank[rank < k].cpu().numpy()
        out_ids[rows, cols] = docs[top].cpu().numpy()
        out_d[rows, cols] = scores[top].cpu().numpy()
        return expected.Ok(GenResultDataSet(nq, k, out_ids, out_d))

    # --- persistence ------------------------------------------------------------------
    def GetEmbListByIds(self, dataset, metric_type: str = "L2"):
        """Per-document token vectors for the given emb_list ids (reference
        index.h:176-178): returns a tensor of concatenated vectors plus a
        lims array (EMB_LIST_OFFSET) marking per-document boundaries."""
        if self._offset is None or self._tokens is None:
            return expected.Err(Status.empty_index, "index not built")
        ids = np.asarray(dataset.ids if dataset.ids is not None else dataset.tensor).reshape(-1).astype(np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self._offset.num_docs):
            return expected.Err(Status.invalid_args, "emb_list id out of range")
        spans = [self._offset.tokens_of_doc(int(i)) for i in ids]
        chunks = [self._tokens[a:b] for a, b in spans]
        out = np.concatenate(chunks) if chunks else np.empty((0, self._tokens.shape[1]), np.float32)
        lims = np.zeros(len(ids) + 1, np.int64)
        for j, (a, b) in enumerate(spans):
            lims[j + 1] = lims[j] + (b - a)
        ds = DataSet(
            tensor=out,
            lims=lims,
            rows=len(ids),
            dim=out.shape[1] if out.size else self._tokens.shape[1],
        )
        return expected.Ok(ds)

    def Serialize(self, binset: BinarySet) -> Status:
        if self._under is None:
            return Status.empty_index
        st = self._under.Serialize(binset)
        if st != Status.success:
            return st
        arrays = {"lims": self._offset.lims, "tokens": self._tokens}
        meta = {"metric": self._metric, "strategy": self._strategy, "fde": self._fde_params}
        if self._mlp_params is not None:
            for i, layer in enumerate(self._mlp_params):
                arrays[f"mlp_w{i}"] = layer["w"]
                arrays[f"mlp_b{i}"] = layer["b"]
            meta["mlp_layers"] = len(self._mlp_params)
        bf16 = ("tokens",) if self._tokens.dtype == np.uint16 else ()
        binset.Append("EMB_LIST_META", write_sections(arrays, meta=meta, bf16=bf16))
        return Status.success

    def Deserialize(self, binset: BinarySet, cfg: Config) -> Status:
        blob = binset.GetByName("EMB_LIST_META")
        if blob is None:
            return Status.invalid_binary_set
        arrays, meta = read_sections(blob.data)
        self._metric = meta["metric"]
        self._strategy = meta["strategy"]
        self._fde_params = meta.get("fde", {})
        self._offset = EmbListOffset(np.asarray(arrays["lims"]))
        self._tokens = np.asarray(arrays["tokens"])
        self._tok_dev = None
        self._mlp, self._mlp_params = None, None
        if "mlp_layers" in meta:
            self._mlp_params = [
                {"w": np.asarray(arrays[f"mlp_w{i}"]), "b": np.asarray(arrays[f"mlp_b{i}"])}
                for i in range(meta["mlp_layers"])
            ]
        self._retrieval_metric = (
            _BASE_METRIC[self._metric] if self._strategy == "tokenann" else M.IP
        )
        self._under = self._make_underlying()
        return self._under.Deserialize(binset, cfg)

    def Count(self) -> int:
        return 0 if self._offset is None else self._offset.num_docs

    def Dim(self) -> int:
        return 0 if self._tokens is None else self._tokens.shape[1]
