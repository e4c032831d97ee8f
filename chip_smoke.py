#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (knowhere_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU. In order:

1. require a CUDA device and print the card's name and power limit;
2. build the CUDA kernels from knowhere_tpu_torch/csrc (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time both (the int8 scan also with a
   quarter of its tasks empty, at 32-query groups, at d=256 and on a
   heavy-tie corpus, every position equal; the f32 scan also at the HNSW
   build's per-launch shape, 8,192 tasks at kk=32; FLAT phase 1 also as its
   group-max and select launches apart, beside an f32 yardstick; the ADC
   table kernel bit for bit against its plain version's sequential sums,
   and the ADC scan at SIFT's, GIST's, the nibble and other widths, and its
   shared-memory figure against the wrapper's; the fused scan as its three
   launches apart, its rescore launch against its own plain version, at
   k=1024, d=256, d=96, 1,000 queries, on an exact tie grid and with empty
   slots; both graph walks' membership test, graph_fresh, at the HNSW
   walk's step shape and at DISKANN's unrouted ceiling of 1,024 entries
   (W 8, degree 56, ef 128: ring and beam staged in two chunks), every
   output bit for bit);
4. run the main path through the public API on the SIFT1M-like corpus
   (1M x 128 f32, 10,000 queries, seed 0): FLAT exact ground truth, its
   first 1,000 queries' ids held against an independent full-f32 answer
   (torch.matmul + torch.topk) and its warm search time, IVF_FLAT
   (nlist=1024, L2) FAST search at nprobe=12, k=10, recall@10 and warm QPS,
   a 50% bitset search, a Serialize/Deserialize round trip, and the same
   index served by the f32 scan (KNOWHERE_DISABLE_INT8_SCAN=1), its recall
   and warm QPS;
5. IVF_PQ at the north-star configuration on the same corpus (nlist=1024,
   m=16, nbits=8, OPQ, FP16 refine with refine_k=8, FAST, nprobe=12, k=10):
   recall@10 against the FLAT truth and warm QPS, a 50% bitset search, a
   Serialize/Deserialize round trip, and an EXACT-precision search of the
   first 1,000 queries (the plain decode scan) that FAST must come within
   0.01 recall of;
6. the range path on the same corpus, with FLAT, IVF_FLAT and IVF_PQ from
   steps 4 and 5 (the reference's range leg, bench.py:1033-1068: radius =
   the median 10th-NN distance of 200 queries, nprobe=64, 1,000 queries):
   FLAT RangeSearch identical to BruteForce.RangeSearch and to its own
   top-100 inside the radius; IVF_FLAT RangeSearch (FAST: the int8 scan's
   wide-k rounds) and IVF_PQ RangeSearch (the ADC scan's), every distance
   in the window, recall against FLAT's range sets, and the IVF_FLAT call
   once more in the smallest query blocks, bit for bit; IVF_FLAT
   AnnIterator, 100 queries x 1,000 items; GetVectorByIds and CalcDistByIDs
   of 1,000 ids; a huge radius on a 100,000-row IVF_FLAT (the covering
   exact pass); warm wall times, the rounds (k, nprobe), peak device
   memory. Every int8 and ADC scan launch of the first (untimed) call of
   each, and of the small-block call, is held against its plain version
   on the same inputs at the tolerance of step 3;
7. IVF_SQ8 on the SIFT1M-like corpus (nlist=1024, sq_type SQ8, FAST,
   nprobe=16, k=10; the bench's SQ8 leg): served by the int8 scan over the
   u8 codes with an SQ8-decode rerank; recall@10 against the FLAT truth,
   warm QPS, a 50% bitset search, a Serialize/Deserialize round trip,
   EXACT on the first 1,000 queries; then the same BinarySet loaded with
   KNOWHERE_DISABLE_INT8_SCAN=1, served by the SQ scan kernel, its recall,
   warm QPS and one torch-profiler pass over one search;
8. IVF_RABITQ on the same corpus (nlist=1024, raw refine, FAST, nprobe=16,
   refine_k=8, k=10): served by the RaBitQ scan kernel; recall, warm QPS,
   one torch-profiler pass over one search, bitset, round trip, EXACT on
   1,000 queries;
9. HNSW at the bench's configuration on the same corpus (M=16,
   efConstruction=200, L2, FAST): the build (its all-pairs kNN graph runs
   through the f32 scan kernel; the inline walk must be active), recall@10
   and warm QPS at ef=48, the ef ladder 32 / 48 / 64, a 50% bitset, a 95%
   bitset (the exact-scan fallback), a Serialize/Deserialize round trip, the
   same BinarySet in lean mode (KNOWHERE_GRAPH_INLINE=0, the general walk),
   and one torch-profiler pass over one search; then SCANN at the bench's
   leg (nlist=1024, sub_dim=2: 4-bit PQ with m=64 in the nibble layout,
   nprobe=12, reorder_k=256): recall@10 against the FLAT truth, warm
   search, every ADC launch of one search held against its plain version,
   a 50% bitset, a round trip, GetVectorByIds bit-equal to the input rows;
10. the single-pass fused kNN scan (fused_knn, the counterpart of the
   reference's pallas_knn) over all queries at k=10, held against its plain
   version on the same inputs, recall@10 against the FLAT truth and its wall
   time beside FLAT's;
11. the bench's GIST leg of IVF_PQ (m=96, nbits=8, FP16 refine, so
   m * ksub = 24,576 LUT entries) at a reduced size: a GIST-like corpus of
   100,000 x 960 with 1,000 queries instead of 1M, nlist=256 instead of
   1024 and nprobe=32 instead of 384 (refine_k=32), all cut for chip time;
   FLAT ground truth on that corpus, FAST recall within 0.01 of EXACT;
   then the binary path: 256-bit SimHash codes of the corpus (the sign bits
   under a seeded 128 x 256 gaussian projection), BIN_FLAT truth,
   BIN_IVF_FLAT HAMMING (nlist=1024, nprobe=16) served by the f32 scan over
   {0,1} rows, every launch of one search held against its plain version
   (max abs error 0, positions 1.0), tie-aware recall@10, and JACCARD on a
   second index (the plain scan: no f32-scan launch); the typed path:
   IVF_FLAT over the corpus cast to fp16 against FLAT on the same values
   (no scan kernel launched, GetVectorByIds fp16 rows bit-equal), and a bf16
   IVF_FLAT through Serialize / Deserialize with no ml_dtypes loaded; the
   cc path: IVF_FLAT_CC built on 600,000 rows while a writer Adds the other
   400,000 in 40 batches and two readers search 1,000 queries in a loop
   (every result full, every merge's epoch served by the int8 scan, 1,000
   acknowledged rows read back first, final recall@10 within 0.01 of the
   one-shot IVF_FLAT's), then IVF_SQ_CC at 100,000 rows; the graph families
   path (must launch graph_fresh: its bf16-held stores take the general
   walk): HNSW over the corpus cast to fp16 at 1M x 128 (HNSW_BUILD, ef=48;
   its kNN graph through the f32 scan, the first launch held against its
   plain version; recall against FLAT over the fp16 values beside the fp32
   HNSW's, warm search, a 50% bitset, a round trip whose search holds
   every graph_fresh launch bit for bit against fresh_step_plain, fp16 rows
   read back bit-equal, the store's device GB, feder's overview and walk replay),
   then at GRAPH_NB rows: HNSW over bf16 and over int8 rows (recall, round
   trip), binary HNSW over SimHash codes (HAMMING: the IP-ranked f32 build
   route, a launch held exactly, tie-aware recall against BIN_FLAT; JACCARD
   on 1,000 queries), SVS_VAMANA_LVQ on the forced inline walk and then
   lean, SVS_VAMANA_LEANVEC (svs_leanvec_dim 64), GPU_CUVS_CAGRA
   (graph_degree 32, itopk_size 64, refine_ratio 2), one FAST search each
   of GPU_CUVS_IVF_FLAT (the int8 scan; feder's IVF overview and probes)
   and GPU_CUVS_IVF_PQ (the ADC scan), and KMEANS Train on 1M x 128 at
   1,024 clusters twice (bit-equal) with its Assign held to FLAT's nearest
   centroid; the diskann path (must launch graph_fresh in its walk):
   DISKANN at bench.py's knobs (max_degree 56,
   search_list_size 128, 32 PQ bytes a row) built off a bin file of the 1M
   x 128 corpus in a temporary directory (its kNN graph through the f32
   scan, the first launch held against its plain version), loaded with no
   node cache (its warm-up search holding every graph_fresh launch bit for
   bit against fresh_step_plain),
   a BFS cache of a tenth of the rows and every row cached, each searched
   over the search_list_size ladder 16-256 (recall@10
   against the FLAT truth, QPS; the BFS cache's ids equal to no cache's), a
   50% bitset, a 0.96 bitset (the exact disk scan), RangeSearch on 100
   queries, AnnIterator (100 queries x 100 items), GetVectorByIds,
   GetIndexMeta and one profiled no-cache search (the walk, the rerank's
   host time, the idle share); the sharded build at 200,000 rows under a
   0.25 GB budget (4 shards, each through the f32 scan); AISAQ at 250,000
   rows with its inline records (their bytes, recall, QPS); the sparse
   path at bench.py's sparse leg (200,000 SPLADE-like rows over 30,000
   dims, 2,000 queries, seed 7): for IP and BM25 the truth from
   BruteForce.SearchSparse, SPARSE_INVERTED_INDEX over the drop ladder
   0.6 / 0.4 / 0.2 / 0.0 (refine_factor 4 when drop > 0) to recall@10 >=
   0.95, the engine each rung took and the engine probe's seconds, warm QPS
   (repeated searches bit-equal), the device MB of the head slab, the
   packed tail ids and the tail values, the host rescore's ms, recall at
   drop 0 (floors: IP 0.95 at the chosen rung, BM25 0.999 at drop 0); for
   IP also a 50% bitset, a round trip (ids and engine choice kept),
   TAAT_NAIVE and the windowed pruner (sindi_window_size 32768, 256
   queries) against the exact answer, the tail ids decoded on the device
   against the host decode, and SPARSE_INVERTED_INDEX_CC taking 50,000
   rows while a reader searches (every acknowledged row read back); the
   native host library must have built; then the api and emb_list path:
   a ColBERT-style corpus made on the device (20,000 documents of 32-128
   tokens x 128 drawn from 200 topics' concepts, 1,000 queries of 32
   tokens) with the exact MAX_SIM_COSINE truth, tokenann over HNSW (M 16,
   efConstruction 200; its first f32-scan build launch held against its
   plain version), over IVF_FLAT (nlist 1024; its first int8-scan launch
   held) and over FLAT, MUVERA (5 projections, 20 repeats) and LEMUR (the
   defaults) over FLAT, DTW_COSINE on 256 queries, a 50% document bitset, a
   round trip and GetEmbListByIds (recall@10, build s, warm QPS, device
   GB); MINHASH_LSH over 1M 128 x 32-bit signatures in families of 5
   near-duplicates (per-band and shared Bloom filters, batch and one-by-one
   ids equal, tie-aware recall@1 and @10 against the device brute force,
   every planted duplicate of agreement >= 0.8 at rank 1, a round trip
   that rebuilds no table); SCANN_DVR over a view of the 1M corpus' host
   rows (nprobe 12, reorder_k 256; its first ADC launch held) and its
   UINT8 / FP16 / BF16 refine copies at 100,000 rows, a 50% bitset with the
   materialized-view hint; FAISS's "Flat", "IVF256,Flat", "IVF256,PQ16",
   "IVF256,SQ8" and "HNSW16" at 100,000 rows, each with the ids of the
   native node of the same parameters; compat's SWIG-style flow over
   IVF_FLAT with fp32, fp16 and bf16 type objects (Dump / Load,
   BruteForceSearch, BitSet.SetBit after GetBitSetView), the mock wrapper
   over fp16 rows against an fp32 FLAT on the widened rows, and 4 threads
   through the thread-pool wrapper against the serial ids; then the sharded
   path, every leg over four shards of the one card ([cuda:0] * 4):
   bench.py's Deep10M-like leg (SHARDED_IVF_PQ over 10M x 96, nlist 4096,
   m 16, FP16 refine, refine_k 8, 500 queries of bench's second generator
   call) over the nprobe ladder 8, 16, ... to recall@10 >= 0.95 against
   FLAT's truth over the 10M rows, warm QPS, build s, device and host GB,
   a 50% bitset, a round trip onto the default device list (one shard:
   its refine pool a subset of the four shards', so no slot's distance
   better and >= 95% of slots the same); SHARDED_FLAT over the 1M corpus
   (its ids FLAT's but near-ties, and each 1,000-query block against an
   independent full-f32 answer), SHARDED_IVF_FLAT (nlist 1024, nprobe 12)
   and SHARDED_IVF_SQ8 (nprobe 16) with recall, QPS, a 50% bitset and a
   round trip of identical ids, SHARDED_HNSW (M 16, efConstruction 200, ef
   48; the 250,000-row shards build through the f32 scan, the first launch
   held, and walk 8-bit inline tables) with recall, QPS, a round trip and a
   5% keep bitset that takes the exact scan (SHARDED_FLAT's filtered ids
   but near-ties), and sharded k-means at k 1024 against the single-device
   Lloyd from the same k-means++ init (the rows' clusters and the mean
   squared distance); the sharded IVF scans take the plain scan, so the
   path launches only the FLAT truths' and the HNSW builds' kernels;
12. one torch-profiler pass over one search each of IVF_FLAT (the int8
   scan), IVF_PQ (the ADC scan at its real shape) and IVF_SQ8 FAST (the
   int8 scan over u8 codes), and over one IVF_FLAT RangeSearch of step 6
   (range_profile), after every timed search: device ms per
   kernel, device busy and idle share; then one more IVF_PQ search whose
   ADC launch is held against its plain version on the same inputs, with
   its task count, the share of empty tasks and the share of padded query
   rows in the others;
13. run the device build's Lloyd steps (a k-means step at the IVF build's
   shape, PQ's batched step at SIFT's codebook shape) twice each on the
   same inputs: the same bits;
14. print the reproducibility line (IVF_FLAT, IVF_PQ and GIST IVF_PQ
   recall, the ADC task count of one IVF_PQ search: two processes on the
   same seeds print the same), the kernel summary (each kernel's time,
   plain-version time and bound), the card line, and the contract line
   {"ok": true, "device": {...}} last.

Kernel launch counters are zeroed right before each of phases 4-11 and read
right after it; every kernel must have launched on its path. Each path
prints its wall time, and the script its own before the kernel summary.

Every phase raises on failure; the script then exits non-zero and prints no
result. Neither JAX, ml_dtypes nor optax is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the H100 SXM peaks and the least-time formula
from ann_bench.roofline import HBM_BYTES_PER_S, bound_s

ROOT = Path(__file__).resolve().parent

# Tolerances of the kernel-vs-plain comparisons (section 3 of the docstring).
# int8: the dot is exact in both and the epilogue rounds the same f32 ops in
# the same order, so scores agree to 1e-6 relative and positions exactly.
INT8_RTOL = 1e-6
# f32: the kernel and the plain version compute the same exact bf16 products
# (three passes, or one) and sum them in f32 in other orders (the tensor
# cores' accumulators against cuBLAS): scores agree within 1e-4 relative +
# 1e-3, and positions except near-ties (at least 99.9% equal).
F32_RTOL, F32_ATOL, F32_POS_AGREE = 1e-4, 1e-3, 0.999
# FLAT phase 1: the kernel and the plain version both compute the
# reference's 3-pass hi/lo bf16 product, summed in other orders: group maxima
# agree within 1e-5 of the largest magnitude + 1e-3, group-id sets on
# >= 99.9% of entries.
FLAT_RTOL, FLAT_ATOL, FLAT_ID_AGREE = 1e-5, 1e-3, 0.999
# FLAT against an independent full-f32 answer (torch.matmul + torch.topk,
# TF32 off) on the first 1,000 queries: ids identical except where the k-th
# and (k+1)-th exact distances lie within this much (and ranks swapped
# between distances this close).
FLAT_EXACT_TIE = 1e-3
RECALL_FLOOR = 0.95  # IVF_FLAT recall@10 at nprobe=12 (reference: 0.9585)
FILTERED_RECALL_FLOOR = 0.90
F32_PATH_RECALL_FLOOR = 0.95
# ADC: the kernel and the plain version round the same table entries and sum
# a row's lookups in other orders: scores agree within 1e-3 relative + 1e-2,
# positions on >= 99% of slots.
ADC_RTOL, ADC_ATOL, ADC_POS_AGREE = 1e-3, 1e-2, 0.99
PQ_RECALL_FLOOR = 0.945  # IVF_PQ recall@10 at nprobe=12
PQ_TPU_ANCHOR = 0.9544  # the JAX package's recall on a TPU (docs/BENCHMARKS.md:16)
IVF_PQ_BUILD = {"metric_type": "L2", "nlist": 1024, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"}
IVF_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12, "refine_k": 8}
GIST_PQ_BUILD = {"metric_type": "L2", "nlist": 256, "m": 96, "nbits": 8, "refine": True, "refine_type": "FP16"}
GIST_PQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 32, "refine_k": 32}
# SQ: decoded values and queries are rounded to bf16 in both (single pass) or
# split to hi/lo bf16 (three_pass); the products are exact, the sums and the
# f32 norms run in other orders: the f32 scan's tolerances hold.
SQ8_BUILD = {"metric_type": "L2", "nlist": 1024, "sq_type": "SQ8"}
SQ8_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 16}
SQ8_RECALL_FLOOR = 0.945  # IVF_SQ8 recall@10 at nprobe=16
SQ8_TPU_ANCHOR = 0.9520  # the JAX package's recall on a TPU (docs/BENCHMARKS.md:19)
SQ_SCAN_RECALL_FLOOR = 0.90  # the same index served by the SQ scan kernel
SQ_SCAN_VS_EXACT = 0.03
# RaBitQ: the same +/-bf16(qr) terms in both (qr_hi and qr_lo for three_pass),
# summed in another order; |qr|^2 and <q,c> too: the f32 scan's tolerances
# hold.
RBQ_BUILD = {"metric_type": "L2", "nlist": 1024}
RBQ_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 16, "refine_k": 8}
RBQ_RECALL_FLOOR = 0.85
FAST_VS_EXACT = 0.01  # FAST recall may trail EXACT recall by this much
# fused kNN scan: both round the same bf16 inputs and sum exact products in
# f32 in other orders: scores within 1e-4 relative + 1e-3, id sets equal on
# >= 99.9% of slots.
FUSED_RTOL, FUSED_ATOL, FUSED_ID_AGREE = 1e-4, 1e-3, 0.999
FUSED_RECALL_FLOOR = 0.95
# HNSW floors, each just under the JAX package's TPU anchor
# (docs/BENCHMARKS.md:17,20,22; the reference's figures, not the port's)
HNSW_BUILD = {"metric_type": "L2", "M": 16, "efConstruction": 200}
HNSW_RECALL_FLOOR, HNSW_TPU_ANCHOR = 0.96, 0.9728  # ef=48, 4-bit inline walk
HNSW_FILTERED_FLOOR, HNSW_FILTERED_ANCHOR = 0.94, 0.9575  # 50% bitset
HNSW_LEAN_FLOOR, HNSW_LEAN_ANCHOR = 0.96, 0.9734  # general walk
HNSW_FALLBACK_FLOOR = 0.99  # 95% bitset: the exact scan
# range path: the reference's range leg (bench.py:1033-1068): radius = the
# median 10th-NN distance of 200 queries, nprobe=64, 1,000 queries. Recall is
# the leg's: the mean over queries of |found & exact| / |exact|.
RANGE_NQ, RANGE_NPROBE = 1000, 64
RANGE_IVF_RECALL_FLOOR = 0.98  # the JAX package's TPU anchor is 0.9935 (docs/BENCHMARKS.md:23)
RANGE_PQ_RECALL_FLOOR = 0.975  # no anchor: just under the first measured value, 0.9785
RANGE_TIE = 1e-3  # FLAT's range set against its top-100: rows this close (relative) to the radius may differ
ITER_NQ, ITER_ITEMS, ITER_RECALL_FLOOR = 100, 1000, 0.95
# SCANN at the bench's leg (bench.py:426-440): 4-bit PQ with sub_dim 2 (m=64,
# ksub=16, the nibble layout), raw rows reordering max(k, reorder_k) = 256
SCANN_BUILD = {"metric_type": "L2", "nlist": 1024, "sub_dim": 2, "with_raw_data": True}
SCANN_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12, "reorder_k": 256}
SCANN_RECALL_FLOOR, SCANN_TPU_ANCHOR = 0.95, 0.9584  # the anchor: docs/BENCHMARKS.md:18
# binary path: 256-bit SimHash codes of the SIFT-like corpus (the sign bits
# under a seeded 128 x 256 gaussian projection), BIN_IVF_FLAT HAMMING with its
# f32 scan (one bf16 pass over {0,1} rows) held to the plain version exactly:
# the scores are integers, so ties decide positions
BIN_BITS, BIN_NB = 256, 1_000_000
BIN_BUILD = {"nlist": 1024}
BIN_SEARCH = {"k": 10, "nprobe": 16}
BIN_JACCARD_NQ = 1000
BIN_RECALL_FLOOR = 0.90  # tie-aware recall@10: just under the first measured value, 0.90335
# typed path: IVF_FLAT over the corpus cast to fp16 (the plain scan over the
# bf16 device rows, as the reference serves it); the floor just under the
# first measured value, 0.95575
TYPED_BUILD = {"metric_type": "L2", "nlist": 1024}
TYPED_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12}
TYPED_RECALL_FLOOR = 0.95
TYPED_BF16_NB = 100_000  # the bf16 round trip without ml_dtypes
# cc path: IVF_FLAT_CC (nlist CC_NLIST) built on the first CC_N0 of CC_NB
# rows, the rest added in CC_BATCHES batches while CC_READERS threads search
# CC_NQ queries; then IVF_SQ_CC (nlist CC_SQ_NLIST: at 100,000 rows a list
# padded to 512 rows would make 1024 lists five times the rows, and no merge
# would come) at CC_SQ_NB rows
CC_NB, CC_N0, CC_BATCHES, CC_READERS, CC_NQ = 1_000_000, 600_000, 40, 2, 1000
CC_SQ_NB, CC_SQ_N0, CC_SQ_NLIST = 100_000, 60_000, 256
CC_SEARCH, CC_NLIST = {"metric_type": "L2", "k": 10, "nprobe": 12}, 1024
CC_RECALL_SLACK = 0.01  # final recall may trail the one-shot build's by this much
CC_READBACK = 1000  # acknowledged rows searched by their own vectors
# graph families path: HNSW over the corpus cast to fp16 at full size
# (HNSW_BUILD, ef=48), then GRAPH_NB-row legs: bf16 and int8 HNSW, binary
# HNSW over SimHash codes, SVS_VAMANA_LVQ, SVS_VAMANA_LEANVEC, GPU_CUVS_CAGRA,
# one search each of GPU_CUVS_IVF_FLAT / GPU_CUVS_IVF_PQ, feder and KMEANS.
# Each recall floor sits just under its first measured value (the value in
# its comment: at GRAPH_NB = 100,000 rows, which the path was cut to from
# 200,000 to keep its wall under 90 s; H100 80GB HBM3, 700 W).
GRAPH_NB, GRAPH_NQ = 100_000, 1000
GRAPH_SEARCH = {"metric_type": "L2", "k": 10, "ef": 48}
FP16_HNSW_FLOOR = 0.97  # 0.97327 at 1M rows (the fp32 HNSW of the same run: 0.9735)
TYPED_HNSW_FLOOR = 0.93  # bf16 0.9376, int8 0.9332
BIN_HNSW_FLOOR = 0.84  # tie-aware recall@10, 0.8413
LVQ_FLOOR = 0.92  # 0.9252 on the inline walk, 0.9313 lean
LEANVEC_FLOOR = 0.71  # 0.7112 (64 of 128 dims walked)
CAGRA_FLOOR = 0.945  # 0.9478
CUVS_IVF_FLOOR = {"GPU_CUVS_IVF_FLAT": 0.73, "GPU_CUVS_IVF_PQ": 0.705}  # 0.7336, 0.7095
CUVS_IVF_BUILD = {"metric_type": "L2", "nlist": 256}
CUVS_IVF_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 16}
CAGRA_BUILD = {"metric_type": "L2", "graph_degree": 32}
CAGRA_SEARCH = {"metric_type": "L2", "k": 10, "itopk_size": 64, "refine_ratio": 2}
KMEANS_K = 1024
# diskann path: DISKANN at bench.py:1429-1435's knobs (max_degree 56,
# search_list_size 128, 32 PQ bytes a row, a 16 GB build budget) on the 1M x
# 128 corpus, loaded without a node cache, with a BFS cache of
# DISKANN_CACHE_SHARE of the rows and with every row cached, searched over
# bench.py:1462's search_list_size ladder; the sharded build at SHARD_NB
# rows under SHARD_BUDGET_GB (rows_in_budget 130,208: 4 shards, each above
# 65,536 rows); AISAQ at AISAQ_NB rows (bench.py's DISKANN_NB). Legs 2-3 and
# the 0.96-bitset, range and iterator calls use DISKANN_SMALL_NQ queries.
# Floors sit just under the first measured value at search_list_size 64 (the
# JAX package's TPU anchor is 0.9688 at 250,000 rows).
DISKANN_BUILD = {"metric_type": "L2", "max_degree": 56, "search_list_size": 128, "build_dram_budget_gb": 16.0}
DISKANN_LADDER = (16, 32, 64, 128, 256)
DISKANN_L = 64
DISKANN_CACHE_SHARE = 0.1
DISKANN_SMALL_NQ = 1000
DISKANN_FLOOR = 0.955  # 0.95719 (no cache, any cache: the same ids)
DISKANN_BITSET_FLOOR = 0.96  # 0.96324 under the 50% bitset
SHARD_NB, SHARD_BUDGET_GB, SHARD_FLOOR = 200_000, 0.25, 0.83  # 0.8362
AISAQ_NB, AISAQ_FLOOR = 250_000, 0.61  # 0.6197: one entry row, a 4-wide beam
SMALL_LADDER = (64, 128)  # legs 2-3
# The sparse path (sparse_path): bench.py's sparse leg (bench.py:1265-1383),
# nothing cut: gen_sparse_corpus(200,000, 2,000, 30,000, seed=7), k = 10, IP
# then BM25 (k1 1.2, b 0.75, avgdl 40), the truth from the port's
# BruteForce.SearchSparse, the drop ladder with refine_factor 4 when drop >
# 0, stopping at recall@10 >= SPARSE_TARGET. Floors sit just under the JAX
# package's TPU anchors (docs/BENCHMARKS.md:24-25): IP 0.9522 at the chosen
# rung, BM25 1.0 at drop 0. The pruned leg is bench's pruned row
# (sindi_window_size 32768, 256 queries); the cc leg builds
# SPARSE_INVERTED_INDEX_CC on SPARSE_CC_N0 rows and adds the rest in
# SPARSE_CC_BATCHES batches while a reader searches SPARSE_CC_NQ queries.
SPARSE_NB, SPARSE_NQ, SPARSE_VOCAB, SPARSE_K = 200_000, 2_000, 30_000, 10
SPARSE_BM25 = {"bm25_k1": 1.2, "bm25_b": 0.75, "bm25_avgdl": 40.0}
SPARSE_DROPS = (0.6, 0.4, 0.2, 0.0)
SPARSE_TARGET = 0.95  # bench.py's RECALL_TARGET
SPARSE_IP_FLOOR = 0.95  # the TPU anchor is 0.9522 at drop 0.6
SPARSE_BM25_FLOOR = 0.999  # the TPU anchor is 1.0 at drop 0
SPARSE_PRUNED_NQ, SPARSE_WINDOW = 256, 32768
SPARSE_CC_N0, SPARSE_CC_BATCHES, SPARSE_CC_NQ = 150_000, 10, 256
SPARSE_TIE_RTOL = 1e-5  # two exact engines' ids may differ only between scores this close


def gen_corpus(nb, nq, dim, n_clusters=500, intrinsic_dim=48, seed=0, center_scale=(0.9, 1.6)):
    """SIFT-like gaussian mixture with low intrinsic dimension (the same
    generator as the reference benchmark's corpus, bench.py:516-543): each
    cluster draws its center scale from U(center_scale), or takes a scalar
    center_scale as it is."""
    rng = np.random.default_rng(seed)
    if np.isscalar(center_scale):
        scales = np.full(n_clusters, float(center_scale), np.float32)
    else:
        scales = rng.uniform(*center_scale, size=n_clusters).astype(np.float32)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * scales[:, None]
    W = rng.standard_normal((intrinsic_dim, dim)).astype(np.float32)
    W *= np.sqrt(dim / intrinsic_dim) / np.sqrt(intrinsic_dim)

    def noise(n):
        return rng.standard_normal((n, intrinsic_dim)).astype(np.float32) @ W

    xb = centers[rng.integers(0, n_clusters, size=nb)] + noise(nb)
    xq = centers[rng.integers(0, n_clusters, size=nq)] + noise(nq)
    return xb, xq


def gen_sparse_corpus(nb, nq, vocab, seed=7):
    """Zipf-distributed term ids with lognormal weights, SPLADE-like (the
    reference benchmark's sparse generator, bench.py:546-562): rows of about
    40 terms, queries of about 20."""
    rng = np.random.default_rng(seed)

    def rows(n, avg_nnz):
        lens = rng.poisson(avg_nnz, size=n).clip(4, 4 * avg_nnz)
        total = int(lens.sum())
        terms = (rng.zipf(1.3, size=total).clip(1, vocab) - 1).astype(np.int64)
        vals = rng.lognormal(0.0, 0.6, size=total).astype(np.float32)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        out = []
        for i in range(n):
            s, e = bounds[i], bounds[i + 1]
            out.append({int(t): float(v) for t, v in zip(terms[s:e], vals[s:e])})
        return out

    return rows(nb, 40), rows(nq, 20)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() over reps runs, CUDA events, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i].tolist())) for i in range(len(gt)))
    return hits / gt.size


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations ({operand type: count}) over the peak
    rate of their type (ann_bench/roofline.bound_s). Returns {"bound_ms",
    "bound_by"}."""
    t = bound_s(nbytes, ops)
    return {"bound_ms": t * 1e3, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= t else "operations"}


def _task_work(blk, nrows, keep, Qg, kk, B=512):
    """What a task scan's data needs: the distinct list blocks it reads, the
    rows it scores (the sum of nrows), and the bytes of the task indices,
    the mask of the blocks read and the (score, position) outputs."""
    import torch

    n_blocks = int(torch.unique(blk).numel())
    rows = int(nrows.long().sum())
    T = blk.numel()
    side = T * 8 + T * Qg * kk * 8 + (n_blocks * B if keep is not None else 0)
    return n_blocks, rows, side


def _rows_read(blk, nrows):
    """The rows of the distinct list blocks up to each block's largest
    nrows: what a scan that stops at nrows must read."""
    import torch

    uniq, inv = torch.unique(blk, return_inverse=True)
    most = torch.zeros(uniq.numel(), dtype=torch.long, device=blk.device)
    return int(most.scatter_reduce_(0, inv, nrows.long(), "amax").sum())


def _dot_ops(three_pass: bool, dots: int, f32_ops: int) -> dict:
    """A scan's operations by type: its dots in f32 (three_pass, full f32) or
    bf16 (the single bf16 pass), plus f32_ops more in f32."""
    ops = {"f32": f32_ops}
    key = "f32" if three_pass else "bf16"
    ops[key] = ops.get(key, 0) + dots
    return ops


def _agreement(s_k, p_k, s_p, p_p, rtol, atol, pos_agree, sentinels) -> dict:
    """A kernel's (scores, positions) against its plain version's: scores
    within rtol/atol, positions on >= pos_agree of the slots; with
    sentinels, also the empty slots: the same slots, each exactly (-1e38,
    -1)."""
    import torch

    # the share of equal positions counted exactly (an f32 mean of millions
    # of ones can round below 1.0)
    same = int((p_k == p_p).sum())
    out = {"max_abs_err": (s_k - s_p).abs().max().item(), "pos_agree": same / p_k.numel()}
    ok = torch.allclose(s_k, s_p, rtol=rtol, atol=atol) and out["pos_agree"] >= pos_agree
    if sentinels:
        empty = p_p == -1
        out["empty_slots"] = int(empty.sum())
        ok = ok and bool(torch.equal(p_k == -1, empty) and (s_k[empty] == -1e38).all() and (s_p[empty] == -1e38).all())
    out["ok"] = bool(ok)
    return out


def _run_case(name, kernel, plain, args, kw, rtol, atol, pos_agree, work, reps=5, sentinels=False, **desc):
    """Run one kernel case and its plain version on the same inputs, time
    both, compare (_agreement) and raise on disagreement. work = (bytes,
    ops) for the bound."""
    import torch

    s_k, p_k = kernel(*args, **kw)
    s_p, p_p = plain(*args, **kw)
    torch.cuda.synchronize()
    agree = _agreement(s_k, p_k, s_p, p_p, rtol, atol, pos_agree, sentinels)
    ok = agree.pop("ok")
    ms = time_ms(lambda: kernel(*args, **kw), reps=reps)
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3)
    line = dict(desc, kk=kw["kk"], mask=args[-1] is not None, is_l2=kw["is_l2"], **agree, ms=ms,
                plain_ms=plain_ms, **bound(*work))
    print(name, json.dumps(line))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {line}")
    return line


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def _task_geometry(g, n_blocks, n_tasks, dev):
    import torch

    blk = torch.randint(0, n_blocks, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows = torch.randint(1, 513, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    nrows[: n_tasks // 2] = 512  # most list blocks are full
    return blk, nrows


def _int8_case(blk, nrows, q8, sz, codes, nrm, mask, kk, is_l2, **desc):
    """One int8-scan case against its plain version: scores to INT8_RTOL and
    every position equal (exact s32 dots, the same f32 roundings)."""
    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    n_tasks, Qg, d = q8.shape
    n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
    # the kernel stops at nrows: each block's rows up to its tasks' largest
    # nrows (every 512-row block in full: bound_full_blocks_ms)
    rows_read = _rows_read(blk, nrows)
    nbytes = rows_read * (d + 4 * is_l2) + n_tasks * Qg * (d + 4) + side
    full = n_blk * 512 * (d + 4 * is_l2) + n_tasks * Qg * (d + 4) + side
    ops = {"int8": 2 * n_rows * Qg * d}
    return _run_case(
        "ivf_int8_scan", ivf_cuda.int8_scan_tasks, ivf_cuda.int8_scan_plain, (blk, nrows, q8, sz, codes, nrm, mask),
        dict(B=512, kk=kk, is_l2=is_l2), INT8_RTOL, 0.0, 1.0, (nbytes, ops), reps=10,
        u8=codes.dtype == torch.uint8, tasks=n_tasks, Qg=Qg, d=d, bound_full_blocks_ms=bound(full, ops)["bound_ms"],
        **desc,
    )


def check_ivf_kernels(dev, n_tasks=4096, n_blocks=2048, Qg=128, d=128):
    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    B = ivf_cuda.LIST_ALIGN
    nb_pad = n_blocks * B
    blk, nrows = _task_geometry(g, n_blocks, n_tasks, dev)
    keep = torch.rand(nb_pad, generator=g, device=dev) < 0.5
    codes = torch.randint(-127, 128, (nb_pad, d), generator=g, device=dev, dtype=torch.int8)
    nrm = torch.rand(nb_pad, generator=g, device=dev) * 100.0
    q8 = torch.randint(-127, 128, (n_tasks, Qg, d), generator=g, device=dev, dtype=torch.int8)
    sz = torch.rand((n_tasks, Qg, 1), generator=g, device=dev) * 0.01
    rows = torch.randn((nb_pad, d), generator=g, device=dev)
    qf = torch.randn((n_tasks, Qg, d), generator=g, device=dev)
    results = {"ivf_int8_scan": [], "ivf_f32_scan": [], "ivf_sq_scan": [], "ivf_rbq_scan": []}

    # (kk, mask, is_l2, u8 codes): the main path's L2 cases first, then IP
    # and the SQ8 u8-code branch of the same kernel
    int8_cases = [(16, None, True, False), (16, keep, True, False), (32, None, True, False),
                  (32, keep, True, False), (16, keep, False, False), (16, None, True, True)]
    for kk, mask, is_l2, u8 in int8_cases:
        c = codes.view(torch.uint8) if u8 else codes
        results["ivf_int8_scan"].append(_int8_case(blk, nrows, q8, sz, c, nrm, mask, kk, is_l2))
    # a quarter of the tasks empty; a 32-query group (the N=32 instance)
    nrows_e = nrows.clone()
    nrows_e[::4] = 0
    results["ivf_int8_scan"].append(_int8_case(blk, nrows_e, q8, sz, codes, nrm, keep, 16, True, empty=True))
    q32, sz32 = q8[:, :32].contiguous(), sz[:, :32].contiguous()
    results["ivf_int8_scan"].append(_int8_case(blk, nrows, q32, sz32, codes, nrm, keep, 32, True))
    del q32, sz32, nrows_e
    # heavy ties: i8 codes and queries in {-1, 0, 1} (u8 codes 127..129),
    # norms and scales from a few values, so most scores of a row tie (own
    # generators: the later kernels' inputs stay as they were)
    g2 = torch.Generator(device=dev).manual_seed(4)
    ties_c = torch.randint(-1, 2, (nb_pad, d), generator=g2, device=dev, dtype=torch.int8)
    ties_q = torch.randint(-1, 2, (n_tasks, Qg, d), generator=g2, device=dev, dtype=torch.int8)
    ties_n = (ties_c != 0).sum(1).float()
    ties_s = torch.randint(1, 4, (n_tasks, Qg, 1), generator=g2, device=dev).float() * 0.25
    for kk, mask, is_l2, u8 in [(32, None, True, False), (16, keep, True, True), (32, keep, False, False),
                                (16, None, False, True)]:
        c = (ties_c.view(torch.uint8) ^ 0x80) if u8 else ties_c  # u8 c ^ 0x80 recentres to the same i8
        results["ivf_int8_scan"].append(
            _int8_case(blk, nrows, ties_q, ties_s, c, ties_n, mask, kk, is_l2, ties=True))
    del ties_c, ties_q, ties_n, ties_s
    # d=256: two feature chunks, 1,024 tasks of 64 queries
    g2 = torch.Generator(device=dev).manual_seed(3)
    blk2, nrows2 = _task_geometry(g2, n_blocks // 4, 1024, dev)
    codes2 = torch.randint(-127, 128, (nb_pad // 4, 256), generator=g2, device=dev, dtype=torch.int8)
    q2 = torch.randint(-127, 128, (1024, 64, 256), generator=g2, device=dev, dtype=torch.int8)
    sz2 = torch.rand((1024, 64, 1), generator=g2, device=dev) * 0.01
    for kk, mask, is_l2, u8 in [(16, None, True, False), (32, keep, True, True)]:
        c = codes2.view(torch.uint8) if u8 else codes2
        results["ivf_int8_scan"].append(_int8_case(blk2, nrows2, q2, sz2, c, nrm, mask, kk, is_l2))
    del codes2, q2, sz2

    # (three_pass, kk, mask, is_l2, tasks): the path's shape first, then the
    # HNSW build's per-launch shape (8,192 tasks, kk=32)
    f32_cases = [(True, 16, None, True, n_tasks), (True, 32, keep, True, n_tasks), (False, 16, None, True, n_tasks),
                 (False, 32, keep, True, n_tasks), (True, 16, keep, False, n_tasks), (True, 32, None, True, 8192)]
    path_inputs = blk, nrows, qf
    for three_pass, kk, mask, is_l2, tasks in f32_cases:
        if tasks != n_tasks:  # its own generator: the later cases keep their inputs
            g2 = torch.Generator(device=dev).manual_seed(2)
            blk, nrows = _task_geometry(g2, n_blocks, tasks, dev)
            qf = torch.randn((tasks, Qg, d), generator=g2, device=dev)
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        # the kernel stops at nrows: each block's rows up to its tasks' largest
        # nrows (every 512-row block in full: bound_full_blocks_ms)
        rows_read = _rows_read(blk, nrows)
        nbytes = rows_read * d * 4 + tasks * Qg * d * 4 + side
        # the tensor cores' bf16 passes over the scored rows, the L2 norms in f32
        ops = {"bf16": (3 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 2 * rows_read * d * is_l2}
        full = n_blk * B * d * 4 + tasks * Qg * d * 4 + side
        bound_full = bound(full, {"bf16": ops["bf16"], "f32": 2 * n_blk * B * d * is_l2})["bound_ms"]
        # the bound as if the dots ran in f32 on the CUDA cores, for comparison
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 2 * n_blk * B * d * is_l2))["bound_ms"]
        results["ivf_f32_scan"].append(_run_case(
            "ivf_f32_scan", ivf_cuda.f32_scan_tasks, ivf_cuda.f32_scan_plain, (blk, nrows, qf, rows, mask),
            dict(B=B, kk=kk, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL, F32_POS_AGREE,
            (nbytes, ops), three_pass=three_pass, tasks=tasks, bound_full_blocks_ms=bound_full,
            bound_f32_ms=bound_f32,
        ))
    blk, nrows, qf = path_inputs
    del rows, codes, q8

    # SQ: u8 codes and the grid; (three_pass, kk, mask, is_l2, levels), the
    # path's single bf16 pass first
    codes_u8 = torch.randint(0, 256, (nb_pad, d), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    vmin = torch.randn(d, generator=g, device=dev) - 2.0
    vdiff = torch.rand(d, generator=g, device=dev) * 4.0 + 0.5
    sq_cases = [(False, 16, None, True, 256), (False, 32, keep, True, 256), (False, 16, keep, False, 256),
                (False, 32, None, True, 64), (True, 16, None, True, 256), (True, 32, keep, True, 256)]
    rows_read = _rows_read(blk, nrows)  # the kernels stop at nrows
    for three_pass, kk, mask, is_l2, levels in sq_cases:
        c = codes_u8 if levels == 256 else codes_u8 >> 2
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        nbytes = rows_read * d + 2 * d * 4 + n_tasks * Qg * d * 4 + side
        # the tensor cores' bf16 passes over the scored rows, the decode (and
        # the norms for L2) once per code read in f32
        ops = {"bf16": (3 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 2 * rows_read * d * (1 + is_l2)}
        full = n_blk * B * d + 2 * d * 4 + n_tasks * Qg * d * 4 + side
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 2 * n_blk * B * d * (1 + is_l2)))
        results["ivf_sq_scan"].append(_run_case(
            "ivf_sq_scan", ivf_cuda.sq_scan_tasks, ivf_cuda.sq_scan_plain, (blk, nrows, qf, c, vmin, vdiff, mask),
            dict(B=B, kk=kk, levels=levels, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL,
            F32_POS_AGREE, (nbytes, ops), three_pass=three_pass, levels=levels, bound_f32_ms=bound_f32["bound_ms"],
        ))
    del codes_u8

    # RaBitQ: packed sign bits, corrections, rotated centroids; (three_pass,
    # kk, mask, is_l2), the path's single bf16 pass at kk=32 first
    nlist = 1024
    signs = torch.randint(0, 256, (nb_pad, d // 8), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    rn = torch.rand(nb_pad, generator=g, device=dev) * 4.0
    tt = torch.rand(nb_pad, generator=g, device=dev) * 0.3 + 0.6
    cents = torch.randn((nlist, d), generator=g, device=dev)
    lids = torch.randint(0, nlist, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    n_lids = int(torch.unique(lids).numel())
    rbq_cases = [(False, 32, None, True), (False, 16, keep, True), (False, 16, keep, False), (True, 32, None, True),
                 (True, 16, keep, False)]
    for three_pass, kk, mask, is_l2 in rbq_cases:
        n_blk, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
        nbytes = rows_read * (d // 8 + 8) + n_lids * d * 4 + n_tasks * (Qg * d * 4 + 4) + side
        # the tensor cores' sign dots (two passes for three_pass) over the
        # scored rows, plus qr and |qr|^2 or <q,c> once per query row in f32
        ops = {"bf16": (2 if three_pass else 1) * 2 * n_rows * Qg * d, "f32": 3 * n_tasks * Qg * d}
        full = n_blk * B * (d // 8 + 8) + n_lids * d * 4 + n_tasks * (Qg * d * 4 + 4) + side
        bound_f32 = bound(full, _dot_ops(three_pass, 2 * n_rows * Qg * d, 3 * n_tasks * Qg * d))
        results["ivf_rbq_scan"].append(_run_case(
            "ivf_rbq_scan", ivf_cuda.rbq_scan_tasks, ivf_cuda.rbq_scan_plain,
            (blk, nrows, lids, qf, cents, signs, rn, tt, mask),
            dict(B=B, kk=kk, is_l2=is_l2, three_pass=three_pass), F32_RTOL, F32_ATOL, F32_POS_AGREE,
            (nbytes, ops), three_pass=three_pass, bound_f32_ms=bound_f32["bound_ms"],
        ))
    return results


def _adc_case(g, dev, n_tasks, n_blocks, Qg, d, m, sub, ksub, nq, nlist=1024):
    """Random ADC inputs at one shape: nq f32 queries (the last 16 zero)
    and each task's Qg query ids among them, bf16 books, the bf16 L2 CLUT
    made from them in float64 as the index makes it."""
    import torch

    B = 512
    blk, nrows = _task_geometry(g, n_blocks, n_tasks, dev)
    lids = torch.randint(0, nlist, (n_tasks,), generator=g, device=dev, dtype=torch.int32)
    books = (torch.randn((m, ksub, sub), generator=g, device=dev) * 0.3).to(torch.bfloat16)
    cents = torch.randn((nlist, d), generator=g, device=dev)
    b64 = books.double()
    c3 = cents[:, : m * sub].double().reshape(nlist, m, sub)
    clut = 2.0 * torch.einsum("lms,mvs->lmv", c3, b64) + (b64 * b64).sum(-1)[None]
    clut = clut.float().reshape(nlist, m * ksub).to(torch.bfloat16)
    q = torch.randn((nq, d), generator=g, device=dev)
    q[-16:] = 0  # a padded batch's zero rows: their table entries are signed zeros
    qids = torch.randint(0, nq, (n_tasks, Qg), generator=g, device=dev, dtype=torch.int32)
    return blk, nrows, lids, qids, q, books, clut, cents, n_blocks * B


def _adc_table(q, books, is_l2) -> tuple:
    """The table kernel (adc_qtable) against compute_qlut's sequential sums
    on the card: (its table, {rows, entries, largest ulp gap, entries
    differing, max_abs_err, ok, ms, plain_ms, bound}). The bound: the
    queries, books and table once, two f32 FMA chains an entry."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda

    qtab = adc_cuda.adc_qtable(q, books, is_l2=is_l2)
    want = adc_cuda.compute_qlut(q, books, is_l2=is_l2)
    torch.cuda.synchronize()
    (nq, d), (m, ksub, sub) = q.shape, books.shape
    line = {**_table_agreement(qtab, want),
            "ms": time_ms(lambda: adc_cuda.adc_qtable(q, books, is_l2=is_l2), reps=5),
            "plain_ms": time_ms(lambda: adc_cuda.compute_qlut(q, books, is_l2=is_l2), reps=3),
            **bound(nq * d * 4 + m * ksub * sub * 2 + qtab.numel() * 4, {"f32": 2 * 2 * qtab.numel() * sub})}
    return qtab, line


def _adc_run(args, kk, is_l2, nib, tol=(ADC_RTOL, ADC_ATOL, ADC_POS_AGREE), **desc):
    """One ADC case (adc_cases' inputs): its table from the table kernel,
    held bit for bit against compute_qlut's (_adc_table), then the scan
    against its plain version on that table, with every empty slot equal
    (-1e38, -1). Returns (the scan's line, the table's). The scan's bound counts what the kernel does: an empty task
    loads nothing and rounds no table entry, a block's code rows are read up
    to its tasks' largest nrows, the table is read once."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda

    blk, nrows, lids, qids, q, books, clut, cents, codes, mask = args
    n_tasks, Qg = qids.shape
    nq, d = q.shape
    m, ksub, sub = books.shape
    mb = m // 2 if nib else m
    qtab, table = _adc_table(q, books, is_l2)
    print("ivf_adc_qtable", json.dumps(dict(desc, m=m, ksub=ksub, sub=sub, is_l2=is_l2, **table)))
    if not table["ok"]:
        raise AssertionError(f"the ADC table kernel differs from compute_qlut: {table}")
    live = nrows > 0
    n_live = int(live.sum())
    n_lids = int(torch.unique(lids[live]).numel())
    _, n_rows, side = _task_work(blk, nrows, mask, Qg, kk)
    nbytes = (_rows_read(blk, nrows) * mb + n_live * Qg * 4 + nq * (d + m * ksub) * 4
              + n_lids * (m * ksub * 2 + d * 4) + side)
    # a subtract and a rounding a table entry of every non-empty task, then m lookups a scored row
    ops = {"f32": n_live * Qg * m * ksub + n_rows * Qg * m}
    return _run_case(
        "ivf_adc_scan", adc_cuda.adc_scan_tasks, adc_cuda.adc_scan_plain,
        (blk, nrows, lids, qids, q, qtab, clut, cents, codes, mask),
        dict(m=m, B=512, kk=kk, is_l2=is_l2, nib=nib), *tol, (nbytes, ops), sentinels=True,
        tasks=n_tasks, d=d, m=m, ksub=ksub, sub=sub, nib=nib, empty_tasks=n_tasks - n_live,
        qtable_ms=table["ms"], **desc,
    ), table


def _adc_grid(g, dev, m, ksub, sub, d, nlist, nq, n_codes):
    """ADC inputs on a power-of-two grid (queries in {-1/2, 0, 1/2},
    centroids in halves, codebooks in {-1/4, 0, 1/4}, 4 in 5 of them 0,
    codes from 2 codewords a subspace): every LUT entry, sum and base is
    exact, so kernel and plain version agree bit for bit and many scores
    of a row tie (tests/test_torch_ivf_pq.py uses the same grid)."""
    import torch

    books = torch.randint(-1, 2, (m, ksub, sub), generator=g, device=dev).float() * 0.25
    books = (books * (torch.rand((m, ksub, sub), generator=g, device=dev) < 0.2)).to(torch.bfloat16)
    cents = torch.randint(-2, 3, (nlist, d), generator=g, device=dev).float() * 0.5
    q = torch.randint(-1, 2, (nq, d), generator=g, device=dev).float() * 0.5
    codes = torch.randint(0, 2, (n_codes, m), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    b64 = books.double()
    c3 = cents[:, : m * sub].double().reshape(nlist, m, sub)
    clut = 2.0 * torch.einsum("lms,mvs->lmv", c3, b64) + (b64 * b64).sum(-1)[None]
    return q, books, clut.float().reshape(nlist, m * ksub).to(torch.bfloat16), cents, codes


# check_adc_kernel's shapes: (n_tasks, n_blocks, d, m, sub, ksub, nib, nq,
# [(kk, mask, is_l2), ...], extras); extras adds the table shape with a
# quarter of its tasks empty and the exact tie grid. nq is the table's
# query rows: the SIFT path's 10,240 padded queries (a 168 MB table, past
# the L2) and GIST's first scan block of 974 (not a multiple of the table
# kernel's 16-row blocks). GIST's m=96 codebooks cover 960 of the 1024
# padded columns; the last three shapes hold other widths (sub 4 and 16,
# and sub 6: m * sub = 120 of the 128 columns).
ADC_SHAPES = [
    (4096, 2048, 128, 16, 8, 256, False, 10_240, [(16, False, True), (32, True, True), (16, False, False)], True),
    (4096, 2048, 128, 64, 2, 16, True, 2048, [(16, False, True)], False),
    (512, 256, 1024, 96, 10, 256, False, 974, [(16, False, True), (16, True, True)], False),
    (512, 256, 128, 32, 4, 256, False, 2048, [(16, True, True)], False),
    (512, 256, 128, 8, 16, 256, False, 2048, [(16, True, True)], False),
    (512, 256, 128, 20, 6, 256, False, 2048, [(16, True, True), (32, False, False)], False),
]


def adc_cases(dev, shapes=ADC_SHAPES):
    """check_adc_kernel's inputs, in order: yields (args, kk, is_l2, nib,
    desc) for each case of each shape, args = (blk, nrows, lids, qids, q,
    books, clut, cents, codes, keep) (seeded generators, so adc_ab.py
    reproduces them)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    for n_tasks, n_blocks, d, m, sub, ksub, nib, nq, cases, extras in shapes:
        blk, nrows, lids, qids, q, books, clut, cents, nb_pad = _adc_case(g, dev, n_tasks, n_blocks, 128, d, m,
                                                                          sub, ksub, nq=nq)
        mb = m // 2 if nib else m
        codes = torch.randint(0, 256 if nib else ksub, (nb_pad + 2048, mb), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        keep = torch.rand(nb_pad + 2048, generator=g, device=dev) < 0.5
        for kk, masked, is_l2 in cases:
            yield (blk, nrows, lids, qids, q, books, clut, cents, codes, keep if masked else None), kk, is_l2, nib, {}
        if not extras:
            continue
        # the table shape with a quarter of the tasks empty (own generators
        # from here: the later shapes keep their inputs)
        nrows_e = nrows.clone()
        nrows_e[::4] = 0
        yield (blk, nrows_e, lids, qids, q, books, clut, cents, codes, keep), 32, True, nib, {"empty": True}
        del nrows_e
        g2 = torch.Generator(device=dev).manual_seed(5)
        qg, books_g, clut_g, cents_g, codes_g = _adc_grid(g2, dev, m, ksub, sub, d, 1024, q.shape[0], nb_pad + 2048)
        for kk, masked, is_l2 in [(32, True, True), (16, False, False)]:
            args = (blk, nrows, lids, qids, qg, books_g, clut_g, cents_g, codes_g, keep if masked else None)
            yield args, kk, is_l2, nib, {"ties": True}
        del qg, books_g, clut_g, cents_g, codes_g


def check_adc_kernel(dev):
    """The ADC kernels on ADC_SHAPES: at each case the table kernel against
    compute_qlut's sequential sums, bit for bit, and the scan against
    adc_scan_plain on that table: the main path's shape (4096 tasks, Qg=128,
    d=128, m=16, ksub=256; also with a quarter of the tasks empty, and on
    the exact tie grid with every score and position equal), the 4-bit
    nibble layout (m=64, ksub=16), the GIST shape (d=1024, m=96, ksub=256,
    512 tasks) and other widths. First the wrapper's shared-memory figure
    (adc_cuda.adc_smem_bytes, which decides the search's route) against the
    kernel's own at each shape. Returns (the scan lines, the table lines)."""
    from knowhere_tpu_torch.ops import adc_cuda, cuda_build

    for _, _, _, m, _, ksub, nib, _, _, _ in ADC_SHAPES:
        want = cuda_build.lib().kw_ivf_adc_smem_bytes(m, ksub, int(nib))
        if adc_cuda.adc_smem_bytes(m, ksub, nib) != want:
            raise AssertionError(f"adc_smem_bytes({m}, {ksub}, {nib}) differs from the kernel's {want}")
    scans, tables = [], []
    for args, kk, is_l2, nib, desc in adc_cases(dev):
        tol = (0.0, 0.0, 1.0) if desc.get("ties") else (ADC_RTOL, ADC_ATOL, ADC_POS_AGREE)
        scan, table = _adc_run(args, kk, is_l2, nib, tol=tol, **desc)
        scans.append(scan)
        tables.append(table)
    return scans, tables


def check_graph_fresh_kernel(dev, nq=10_240, W=6, deg=32, ef=48, n_seed=8, reps=10):
    """graph_fresh (both walks' membership test, csrc/graph_walk.cu)
    against fresh_step_plain, by default at the HNSW walk's step shape
    (10,240 rows, G = W x deg = 192, V = 200, ef 48): fresh, the ring, the
    masked scores and new_p bit for bit, kernel and plain ms, the byte bound
    (ids, scores and outputs once) and the shared-memory chunks the ring and
    beam are staged in. Ids come from a range twice the ring and beam, so
    about half the candidates repeat, sit in the ring or in the beam, as in
    the walk; each timed launch gets its own copy of the ring, whose slot it
    writes."""
    import torch

    from knowhere_tpu_torch.ops import cuda_build
    from knowhere_tpu_torch.ops.graph import fresh_step, fresh_step_plain

    g = np.random.default_rng(5)
    G = W * deg
    V = n_seed + max(1, 256 // G) * G
    hi = 2 * (V + ef)

    def ids(shape, empty):
        a = np.where(g.random(shape) < empty, -1, g.integers(0, hi, shape)).astype(np.int32)
        return torch.from_numpy(a).to(dev)

    nbrs, visited, bids = ids((nq, G), 0.05), ids((nq, V), 0.25), ids((nq, ef), 0.1)
    scores = torch.from_numpy(g.standard_normal((nq, G)).astype(np.float32)).to(dev)
    rings = [visited.clone() for _ in range(2 * reps + 4)]
    out_k = fresh_step(nbrs, rings[0], bids, scores.clone(), n_seed, True)
    out_p = fresh_step_plain(nbrs, rings[1], bids, scores.clone(), n_seed, True)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
               for a, b in zip((*out_k, rings[0]), (*out_p, rings[1])))
    fresh_share = float(out_p[0].float().mean())
    it = iter(rings[2:])
    ms = time_ms(lambda: fresh_step(nbrs, next(it), bids, scores, n_seed, True), reps=reps)
    plain_ms = time_ms(lambda: fresh_step_plain(nbrs, next(it), bids, scores, n_seed, True), reps=3)
    nbytes = nq * (4 * (G + V + ef) + 17 * G)
    chunks = -(-(V + ef) // cuda_build.lib().kw_graph_fresh_chunk_ids())
    line = dict(nq=nq, G=G, V=V, ef=ef, n_seed=n_seed, staging_chunks=chunks, bit_equal=same, fresh_share=fresh_share,
                max_abs_err=0.0 if same else None, ms=ms, plain_ms=plain_ms, **bound(nbytes, {}))
    print("graph_fresh", json.dumps(line))
    if not same:
        raise AssertionError(f"graph_fresh disagrees with fresh_step_plain: {line}")
    return line


def check_lloyd_repro(dev, xb: np.ndarray, k=1024, m=16, ksub=256, reps=2) -> dict:
    """The device build's Lloyd sums add in a fixed order: one k-means step
    (ops/kmeans._lloyd_step) at the IVF build's shape (262,144 x 128 rows,
    k=1024) and PQ's batched step (ops/quant._pq_lloyd_batched) at SIFT's
    codebook shape (m=16, ksub=256, 65,536 rows of 8 features, two
    iterations) run twice each on the same inputs and must give the same
    bits. Also their wall ms (host clock around a synchronised call)."""
    import torch

    from knowhere_tpu_torch.ops import kmeans, quant

    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.ascontiguousarray(xb[: k * 256])).to(dev)
    c0 = x[torch.from_numpy(rng.choice(x.shape[0], k, replace=False)).to(dev)]
    xs = x[: ksub * 256].reshape(-1, m, x.shape[1] // m).transpose(0, 1).contiguous()
    b0 = xs[:, torch.from_numpy(rng.choice(xs.shape[1], ksub, replace=False)).to(dev)]
    out = {}
    for name, fn in (
        ("kmeans_step", lambda: kmeans._lloyd_step(x, c0, k=k)),
        ("pq_lloyd", lambda: (quant._pq_lloyd_batched(xs, b0, ksub=ksub, n_iters=2, nc=2048),)),
    ):
        runs, times = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append([r.clone() for r in fn()])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 else torch.equal(a, b)
                   for run in runs[1:] for a, b in zip(runs[0], run))
        out[name] = {"bit_equal": same, "ms": times}
        if not same:
            raise AssertionError(f"{name} gave other bits on the same inputs: {out}")
    print("lloyd:", json.dumps(out))
    return out


def check_flat_kernel(dev, xb: np.ndarray, xq: np.ndarray):
    """flat_group_scan against flat_group_scan_plain on the 1M corpus with
    1,024 queries (k=10 and k=100 L2, k=10 IP), and at d=256 on a random
    corpus. Times the whole scan, its
    group-max and select launches apart, and the f32 yardstick
    topk(((a q @ base^T) - |x|^2) grouped by 16 and maxed) in full f32."""
    import torch

    from knowhere_tpu_torch.ops import cuda_flat

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be full f32")
    base = torch.from_numpy(xb).to(dev)
    out = []
    for is_l2, k in ((True, 10), (True, 100), (False, 10)):
        store = cuda_flat.FlatScanStore(base, None, is_l2)
        q = torch.nn.functional.pad(torch.from_numpy(xq[:1024]).to(dev), (0, store.d_pad - store.d))
        args = (store.base, store.nrm, q, k, store.a_coef)
        err, agree = _flat_agreement(*args)
        ms = time_ms(lambda: cuda_flat.flat_group_scan(*args), reps=5)
        nq = q.shape[0]
        q_op = cuda_flat.query_operand(q)
        gmax = cuda_flat.flat_group_max(store.base, store.nrm, q_op, store.a_coef)
        group_max_ms = time_ms(lambda: cuda_flat.flat_group_max(store.base, store.nrm, q_op, store.a_coef), reps=5)
        select_ms = time_ms(lambda: cuda_flat.flat_select(gmax, nq, k), reps=5)
        del gmax
        plain_ms = time_ms(lambda: cuda_flat.flat_group_scan_plain(*args), reps=3)
        yardstick_ms = time_ms(lambda: torch.topk(
            (store.a_coef * (q @ store.base.T) - store.nrm).view(nq, -1, cuda_flat.GROUP).amax(-1), k), reps=3)
        nbytes = store.nb * (store.d + 1) * 4 + nq * store.d * 4 + nq * k * 8
        dots = 2 * store.nb * nq * store.d
        line = dict(nb=store.nb, nq=nq, k=k, is_l2=is_l2, max_abs_err=err, id_agree=agree, ms=ms,
                    group_max_ms=group_max_ms, select_ms=select_ms, plain_ms=plain_ms, yardstick_ms=yardstick_ms,
                    **bound(nbytes, {"bf16": 3 * dots}), bound_f32_ms=bound(nbytes, {"f32": dots})["bound_ms"])
        print("flat_group_scan", json.dumps(line))
        out.append(line)
        del store
    # d = 256 (two feature chunks: the corpus chunk is staged again for each
    # query tile, as at GIST's d = 960) on a random corpus
    g = torch.Generator(device=dev).manual_seed(3)
    store = cuda_flat.FlatScanStore(torch.randn((65536, 256), generator=g, device=dev), None, True)
    q = torch.randn((300, 256), generator=g, device=dev)
    err, agree = _flat_agreement(store.base, store.nrm, q, 10, store.a_coef)
    print("flat_group_scan", json.dumps(dict(nb=store.nb, nq=300, d=256, k=10, max_abs_err=err, id_agree=agree)))
    return out


def _flat_agreement(base, nrm, q, k, a_coef):
    """flat_group_scan against its plain version on the same inputs: (max
    abs error of the group maxima, mean share of equal group ids a query);
    raises beyond FLAT_RTOL / FLAT_ATOL or under FLAT_ID_AGREE."""
    import torch

    from knowhere_tpu_torch.ops import cuda_flat

    v_k, g_k = cuda_flat.flat_group_scan(base, nrm, q, k, a_coef)
    v_p, g_p = cuda_flat.flat_group_scan_plain(base, nrm, q, k, a_coef)
    torch.cuda.synchronize()
    err = (v_k - v_p).abs().max().item()
    tol = FLAT_ATOL + FLAT_RTOL * v_p.abs().max().item()
    gk, gp = g_k.cpu().numpy(), g_p.cpu().numpy()
    agree = float(np.mean([len(set(gk[i]) & set(gp[i])) / k for i in range(len(gk))]))
    if err > tol or agree < FLAT_ID_AGREE:
        raise AssertionError(f"flat_group_scan disagrees with its plain version: d={base.shape[1]} k={k} "
                             f"max_abs_err={err} tol={tol} id_agree={agree}")
    return err, agree


def flat_vs_exact(xb: np.ndarray, xq: np.ndarray, ids: np.ndarray, k: int) -> dict:
    """FLAT's ids against an independent full-f32 answer on the card:
    |q|^2 - 2 q.x + |x|^2 by torch.matmul (TF32 off), torch.topk of k + 1.
    A row may differ only where its k-th and (k+1)-th exact distances lie
    within FLAT_EXACT_TIE (another id set) or where the swapped ranks'
    distances do (another order)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the exact answer would not be full f32")
    b, q = torch.from_numpy(xb).cuda(), torch.from_numpy(xq).cuda()
    d2 = (q * q).sum(1, keepdim=True) - 2.0 * (q @ b.T) + (b * b).sum(1)[None, :]
    dist, idx = torch.topk(d2, k + 1, dim=1, largest=False)
    d_ids = torch.gather(d2, 1, torch.from_numpy(ids).long().cuda()).cpu().numpy()
    ex, dist = idx.cpu().numpy(), dist.cpu().numpy()
    del d2, b, q
    diff = np.nonzero((ex[:, :k] != ids).any(1))[0]
    other_set = [r for r in diff if set(ex[r, :k].tolist()) != set(ids[r].tolist())]
    bad = [int(r) for r in diff if np.abs(d_ids[r] - dist[r, :k]).max() > FLAT_EXACT_TIE
           or (r in other_set and dist[r, k] - dist[r, k - 1] > FLAT_EXACT_TIE)]
    out = {"queries": len(ids), "rows_differing": int(len(diff)), "rows_other_id_set": len(other_set),
           "rows_not_near_tie": len(bad)}
    if bad:
        raise AssertionError(f"FLAT ids disagree with the full-f32 answer beyond near-ties: {out}, rows {bad[:10]}")
    return out


def _fused_case(q, b, k, is_l2, exact=False, **desc):
    """One fused_knn_scan case against fused_knn_scan_plain on the same
    inputs (the corpus b padded as fused_knn pads it, q to its width):
    scores within FUSED_RTOL / FUSED_ATOL, id sets on >= FUSED_ID_AGREE of
    the slots, the empty slots the same in both and each exactly (-1e38,
    -1); with exact (the tie grid), every score and id equal. Times the scan,
    its plain version and its three launches apart (one block of <= 1,024
    queries); holds the rescore launch to fused_rescore_plain on the
    kernel's own group ids. bound_ms is the function's, at b's own (unpadded)
    rows and width: the corpus and norms read once, the queries read and the
    results written once, 2 nq nb d bf16 operations. design_floor_ms is the
    bytes the three launches must move at the padded sizes they run (the
    group maxima written once and read twice by the select's pre-filter, six
    times on its radix path for kg > 256)."""
    import torch

    from knowhere_tpu_torch.ops import cuda_flat, fused_topk

    nb = b.shape[0]
    nrm = (b * b).sum(1) if is_l2 else torch.zeros(nb, device=b.device)
    base, norms = fused_topk.pad_base(b, nrm)
    q = torch.nn.functional.pad(q, (0, base.shape[1] - q.shape[1]))
    args, kw = (q, base, norms), dict(k=k, is_l2=is_l2)
    s_k, i_k = fused_topk.fused_knn_scan(*args, **kw)
    s_p, i_p = fused_topk.fused_knn_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    agree = _agreement(s_k, i_k, s_p, i_p, FUSED_RTOL, FUSED_ATOL, 0.0, True)
    ok = agree.pop("ok")
    ik, ip_ = i_k.cpu().numpy(), i_p.cpu().numpy()
    agree["id_agree"] = float(np.mean([len(set(a) & set(b)) / len(set(b)) for a, b in zip(ik, ip_)]))  # -1 once
    ok = ok and agree["id_agree"] >= FUSED_ID_AGREE
    if exact:
        ok = ok and agree["max_abs_err"] == 0.0 and agree["pos_agree"] == 1.0
    nq, d = q.shape
    d0 = b.shape[1]
    nb_pad = base.shape[0]
    a, kg, n_groups = (2.0 if is_l2 else 1.0), min(k, nb_pad // cuda_flat.GROUP), nb_pad // cuda_flat.GROUP
    ms = time_ms(lambda: fused_topk.fused_knn_scan(*args, **kw), reps=5)
    plain_ms = time_ms(lambda: fused_topk.fused_knn_scan_plain(*args, **kw), reps=3)
    q1 = q[: cuda_flat.NQ_BLOCK]
    q_op = cuda_flat.query_operand_hi(q1)
    gmax = cuda_flat.fused_group_max(base, norms, q_op, a)
    group_max_ms = time_ms(lambda: cuda_flat.fused_group_max(base, norms, q_op, a), reps=5)
    select_ms = time_ms(lambda: cuda_flat.flat_select(gmax, len(q1), kg), reps=5)
    _, gids = cuda_flat.flat_select(gmax, len(q1), kg)
    del gmax
    rescore_ms = time_ms(lambda: cuda_flat.fused_rescore(q1, base, norms, gids, k, a), reps=5)
    r_k, j_k = cuda_flat.fused_rescore(q1, base, norms, gids, k, a)
    r_p, j_p = cuda_flat.fused_rescore_plain(q1, base, norms, gids, k, a)
    rescore = _agreement(r_k, j_k, r_p, j_p, FUSED_RTOL, FUSED_ATOL, FUSED_ID_AGREE, True)
    ok = ok and rescore["ok"]
    nbytes = nb * (d0 + 1) * 4 + nq * d0 * 4 + nq * k * 8
    nq_pad = -(-nq // 128) * 128
    floor = (nb_pad * (d + 1) * 4 + nq_pad * d * 2 + nq_pad * n_groups * 4 + nq * n_groups * 4 * (2 if kg <= 256 else 6)
             + nq * kg * 8 + nq * kg * cuda_flat.GROUP * (d + 1) * 4 + nq * d * 4 + nq * k * 8)
    line = dict(desc, nb=nb, nq=nq, d=d, k=k, is_l2=is_l2, **agree, ms=ms, plain_ms=plain_ms,
                group_max_ms=group_max_ms, select_ms=select_ms, rescore_ms=rescore_ms, rescore_vs_plain=rescore,
                **bound(nbytes, {"bf16": 2 * nq * nb * d0}), design_floor_ms=floor / HBM_BYTES_PER_S * 1e3)
    print("fused_knn_scan", json.dumps(line))
    if not ok:
        raise AssertionError(f"fused_knn_scan disagrees with its plain version: {line}")
    return line, base, norms, q


def check_fused_kernel(dev, xb: np.ndarray, xq: np.ndarray):
    """fused_knn_scan against fused_knn_scan_plain (_fused_case) on the 1M
    corpus with 1,024 queries: k=10 and k=100 L2, k=10 IP, a corpus whose
    row count is not a tile multiple (padded as fused_knn pads it), and 1,000
    queries (not a multiple of 128); k=1024 (the select's and the rescore's
    radix paths) on its first 262,144 rows; a 1/8-grid corpus of repeated
    rows (every sum exact, k cutting through ties: every score and id
    equal); random corpora at d=256 (two feature chunks) and d=96 (feature
    padding); 100 rows at k=200 (empty slots). Also times the two-call
    yardstick torch.topk(2 (q_bf16 @ b_bf16^T) - norms, k)."""
    import torch

    out = []
    q = torch.from_numpy(xq[:1024]).to(dev)
    b_all = torch.from_numpy(xb).to(dev)
    for nb, k, is_l2, nq in ((len(xb), 10, True, 1024), (len(xb), 100, True, 1024), (len(xb), 10, False, 1024),
                             (len(xb) - 37, 10, True, 1024), (len(xb), 10, True, 1000), (262144, 1024, True, 1024)):
        line, base, _, qp = _fused_case(q[:nq], b_all[:nb], k, is_l2)
        if not out:
            qb, bb = qp.to(torch.bfloat16), base[:nb].to(torch.bfloat16)
            nrm = (b_all * b_all).sum(1)
            line["two_call_topk_ms"] = time_ms(lambda: torch.topk(2.0 * (qb @ bb.T).float() - nrm, k), reps=3)
            print("fused_knn_scan two-call yardstick ms:", line["two_call_topk_ms"])
            del qb, bb, nrm
        out.append(line)
        del base, qp
    del b_all
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(4)
    grid = lambda x: torch.clamp(torch.round(x * 8) / 8, -8, 8)  # noqa: E731
    distinct = grid(torch.randn((4096, 128), generator=g, device=dev))
    perm = torch.randperm(262144, generator=g, device=dev)
    tie_q = grid(torch.randn((512, 128), generator=g, device=dev)).repeat(2, 1)  # repeated across query tiles
    out.append(_fused_case(tie_q, distinct[perm % 4096], 100, True, exact=True, ties=True)[0])
    for d in (256, 96):
        b = torch.randn((65536, d), generator=g, device=dev)
        out.append(_fused_case(torch.randn((300, d), generator=g, device=dev), b, 10, True)[0])
    small = torch.randn((100, 128), generator=g, device=dev)
    out.append(_fused_case(torch.randn((64, 128), generator=g, device=dev), small, 200, True, empty=True)[0])
    return out


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def _search(idx, kt, xq, cfg, bitset=None):
    res = idx.Search(kt.GenDataSetFromArray(xq), cfg, bitset or kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"Search failed: {res.error().name}: {res.what()}")
    k = cfg["k"]
    return res.value().ids.reshape(len(xq), k), res.value().distance.reshape(len(xq), k)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(kt, xb, xq, k=10, nlist=1024, nprobe=12, search_reps=5):
    """FLAT ground truth, IVF_FLAT build + FAST search, filtered search,
    serialize round trip and the f32-scan path, all through the public API.
    Returns (numbers, the FLAT index, its ground truth ids)."""
    nq = len(xq)
    cfg_flat = {"metric_type": "L2", "k": k}
    cfg_ivf = {"metric_type": "L2", "k": k, "nprobe": nprobe}
    out = {}

    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    st, out["flat_build_s"] = _timed(lambda: flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}))
    if st != kt.Status.success:
        raise RuntimeError(f"FLAT Build: {st.name}")
    (gt, gt_d), out["flat_search_s"] = _timed(lambda: _search(flat, kt, xq, cfg_flat))
    if (gt < 0).any() or not np.isfinite(gt_d).all():
        raise AssertionError("FLAT ground truth has empty slots")
    d_chk = ((xq[:64, None, :] - xb[gt[:64]]) ** 2).sum(-1)
    if not np.allclose(d_chk, gt_d[:64], rtol=1e-3, atol=1e-2):
        raise AssertionError("FLAT distances disagree with numpy on the first 64 queries")
    if not (np.diff(gt_d, axis=1) >= -1e-3).all():
        raise AssertionError("FLAT results are not sorted")
    out["flat_vs_full_f32"] = flat_vs_exact(xb, xq[:1000], gt[:1000], k)
    # the first search also built the device copy and the scan store
    out["flat_warm_search_s_all"] = [_timed(lambda: _search(flat, kt, xq, cfg_flat))[1] for _ in range(3)]
    out["flat_warm_search_s_median"] = float(np.median(out["flat_warm_search_s_all"]))

    ivf = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    st, out["ivf_build_s"] = _timed(
        lambda: ivf.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": nlist})
    )
    if st != kt.Status.success:
        raise RuntimeError(f"IVF_FLAT Build: {st.name}")
    ids, dists = _search(ivf, kt, xq, cfg_ivf)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(ivf, kt, xq, cfg_ivf))
        times.append(dt)
    out["ivf_search_s_median"] = float(np.median(times))
    out["ivf_search_s_all"] = times
    out["ivf_qps"] = nq / out["ivf_search_s_median"]
    out["recall_at_10"] = recall_at(ids, gt)
    if not np.isfinite(dists).all() or ids.shape != (nq, k):
        raise AssertionError("IVF_FLAT results not finite / wrong shape")
    if out["recall_at_10"] < RECALL_FLOOR:
        raise AssertionError(f"IVF_FLAT recall@10 {out['recall_at_10']} < {RECALL_FLOOR}")
    _profile_later("ivf_profile", lambda idx=ivf: _search(idx, kt, xq, cfg_ivf))  # the int8 scan's search
    out["_index"] = ivf  # handed to the range path, removed before printing

    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    fids, _ = _search(ivf, kt, xq, cfg_ivf, kt.BitsetView.from_bool_array(drop))
    fgt, _ = _search(flat, kt, xq, cfg_flat, kt.BitsetView.from_bool_array(drop))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError("filtered search returned a filtered or empty id")
    out["filtered_recall_at_10"] = recall_at(fids, fgt)
    out["filtered_ids_returned"] = int(fids.size)
    if out["filtered_recall_at_10"] < FILTERED_RECALL_FLOOR:
        raise AssertionError(f"filtered recall {out['filtered_recall_at_10']} < {FILTERED_RECALL_FLOOR}")

    bs = kt.BinarySet()
    if ivf.Serialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT Serialize failed")
    again = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT Deserialize failed")
    ids2, _ = _search(again, kt, xq, cfg_ivf)
    out["roundtrip_ids_identical"] = bool(np.array_equal(ids2, ids))
    if not out["roundtrip_ids_identical"]:
        raise AssertionError("Serialize/Deserialize changed the result ids")

    # the same index without the int8 sidecar: FAST serves from the f32 scan
    os.environ["KNOWHERE_DISABLE_INT8_SCAN"] = "1"
    try:
        f32_idx = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
        if f32_idx.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("IVF_FLAT Deserialize (f32 scan) failed")
    finally:
        del os.environ["KNOWHERE_DISABLE_INT8_SCAN"]
    ids3, _ = _search(f32_idx, kt, xq, cfg_ivf)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids3, _), dt = _timed(lambda: _search(f32_idx, kt, xq, cfg_ivf))
        times.append(dt)
    out["f32_scan_search_s_all"] = times
    out["f32_scan_search_s_median"] = float(np.median(times))
    out["f32_scan_qps"] = nq / out["f32_scan_search_s_median"]
    out["f32_scan_recall_at_10"] = recall_at(ids3, gt)
    if out["f32_scan_recall_at_10"] < F32_PATH_RECALL_FLOOR:
        raise AssertionError(f"f32-scan recall {out['f32_scan_recall_at_10']} < {F32_PATH_RECALL_FLOOR}")
    return out, flat, gt


def _flat_truth(kt, xb, xq, k=10):
    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    if flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}) != kt.Status.success:
        raise RuntimeError("FLAT Build failed")
    return flat, _search(flat, kt, xq, {"metric_type": "L2", "k": k})[0]


def _exact_vs_fast(kt, idx, xq, gt, cfg, name="IVF_PQ"):
    """recall@k of EXACT (the plain decode scan) and FAST on the same queries;
    FAST must come within FAST_VS_EXACT."""
    kt.KnowhereConfig.SetSimdType("GENERIC")  # EXACT
    try:
        exact = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    finally:
        kt.KnowhereConfig.SetSimdType("AUTO")  # back to FAST
    fast = recall_at(_search(idx, kt, xq, cfg)[0], gt)
    if fast < exact - FAST_VS_EXACT:
        raise AssertionError(f"{name} FAST recall {fast} < EXACT recall {exact} - {FAST_VS_EXACT}")
    return exact, fast


def _serve(kt, name, tag, xb, xq, gt, build, search, floor, search_reps=5):
    """Build `name`, then a warm-up and search_reps timed FAST searches of all
    queries; recall@k against gt must reach floor. Returns (index, ids,
    numbers keyed by tag)."""
    nq, k = len(xq), search["k"]
    out = {}
    idx = kt.IndexFactory.Instance().Create(name).value()
    st, out[f"{tag}_build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), build))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Build: {st.name}")
    ids, dists = _search(idx, kt, xq, search)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(idx, kt, xq, search))
        times.append(dt)
    out[f"{tag}_search_s_median"] = float(np.median(times))
    out[f"{tag}_search_s_all"] = times
    out[f"{tag}_qps"] = nq / out[f"{tag}_search_s_median"]
    out[f"{tag}_recall_at_10"] = recall_at(ids, gt)
    if not np.isfinite(dists).all() or ids.shape != (nq, k) or (ids < 0).any():
        raise AssertionError(f"{name} results not finite / wrong shape / short")
    if out[f"{tag}_recall_at_10"] < floor:
        raise AssertionError(f"{name} recall@10 {out[f'{tag}_recall_at_10']} < {floor}")
    return idx, ids, out


def _filtered_and_round_trip(kt, name, tag, idx, ids, xb, xq, flat, search):
    """A 50% bitset search (no filtered or empty id; recall against the
    filtered FLAT truth) and a Serialize/Deserialize round trip that must
    give identical ids. Returns (numbers keyed by tag, the BinarySet)."""
    out = {}
    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    fids, _ = _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(drop))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError(f"{name} filtered search returned a filtered or empty id")
    fgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": search["k"]}, kt.BitsetView.from_bool_array(drop))
    out[f"{tag}_filtered_recall_at_10"] = recall_at(fids, fgt)

    bs = kt.BinarySet()
    if idx.Serialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} Serialize failed")
    again = kt.IndexFactory.Instance().Create(name).value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} Deserialize failed")
    out[f"{tag}_roundtrip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
    if not out[f"{tag}_roundtrip_ids_identical"]:
        raise AssertionError(f"{name} Serialize/Deserialize changed the result ids")
    return out, bs


def pq_path(kt, xb, xq, gt, flat):
    """IVF_PQ at the north-star configuration through the public API."""
    pq, ids, out = _serve(kt, "IVF_PQ", "pq", xb, xq, gt, IVF_PQ_BUILD, IVF_PQ_SEARCH, PQ_RECALL_FLOOR)
    out["_index"] = pq  # handed to the range path, removed before printing
    out["pq_tpu_anchor_recall_at_10"] = PQ_TPU_ANCHOR  # the reference's, not the port's
    # ivf_adc_scan at its real shape, held against its plain version there,
    # and the share of its tasks that are empty
    _profile_later("pq_profile", lambda idx=pq: _search(idx, kt, xq, IVF_PQ_SEARCH), _adc_real_launch)
    out.update(_filtered_and_round_trip(kt, "IVF_PQ", "pq", pq, ids, xb, xq, flat, IVF_PQ_SEARCH)[0])
    out["pq_exact_recall_1k"], out["pq_fast_recall_1k"] = _exact_vs_fast(
        kt, pq, xq[:1000], gt[:1000], IVF_PQ_SEARCH
    )
    return out


def sq8_path(kt, xb, xq, gt, flat):
    """IVF_SQ8 (SQ8) through the public API: FAST serves from the int8 scan
    over the u8 codes; then the same BinarySet, loaded without the int8
    sidecar, serves from the SQ scan kernel."""
    from knowhere_tpu_torch.ops import ivf_cuda

    sq, ids, out = _serve(kt, "IVF_SQ8", "sq8", xb, xq, gt, SQ8_BUILD, SQ8_SEARCH, SQ8_RECALL_FLOOR)
    out["sq8_tpu_anchor_recall_at_10"] = SQ8_TPU_ANCHOR  # the reference's, not the port's
    if ivf_cuda.int8_scan_tasks.launches == 0:
        raise AssertionError("IVF_SQ8 FAST did not run the int8 scan")
    _profile_later("sq8_profile", lambda idx=sq: _search(idx, kt, xq, SQ8_SEARCH))
    more, bs = _filtered_and_round_trip(kt, "IVF_SQ8", "sq8", sq, ids, xb, xq, flat, SQ8_SEARCH)
    out.update(more)
    exact, out["sq8_fast_recall_1k"] = _exact_vs_fast(kt, sq, xq[:1000], gt[:1000], SQ8_SEARCH, "IVF_SQ8")
    out["sq8_exact_recall_1k"] = exact
    del sq

    # the same BinarySet without the int8 sidecar: FAST serves from the SQ scan
    os.environ["KNOWHERE_DISABLE_INT8_SCAN"] = "1"
    try:
        sq_idx = kt.IndexFactory.Instance().Create("IVF_SQ8").value()
        if sq_idx.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("IVF_SQ8 Deserialize (SQ scan) failed")
    finally:
        del os.environ["KNOWHERE_DISABLE_INT8_SCAN"]
    before = ivf_cuda.sq_scan_tasks.launches
    ids_sq, _ = _search(sq_idx, kt, xq, SQ8_SEARCH)  # warm-up
    times = []
    for _ in range(3):
        (ids_sq, _), dt = _timed(lambda: _search(sq_idx, kt, xq, SQ8_SEARCH))
        times.append(dt)
    if ivf_cuda.sq_scan_tasks.launches == before:
        raise AssertionError("IVF_SQ8 without the int8 sidecar did not run the SQ scan")
    out["sq_scan_search_s_all"] = times
    out["sq_scan_qps"] = len(xq) / float(np.median(times))
    out["sq_scan_profile"] = _profile_search(lambda: _search(sq_idx, kt, xq, SQ8_SEARCH))
    out["sq_scan_recall_at_10"] = recall_at(ids_sq, gt)
    out["sq_scan_recall_1k"] = recall_at(ids_sq[:1000], gt[:1000])
    if out["sq_scan_recall_at_10"] < SQ_SCAN_RECALL_FLOOR or out["sq_scan_recall_1k"] < exact - SQ_SCAN_VS_EXACT:
        raise AssertionError(f"IVF_SQ8 SQ-scan recall {out['sq_scan_recall_at_10']} (first 1,000: "
                             f"{out['sq_scan_recall_1k']}, EXACT {exact}) below its floor")
    return out


def rabitq_path(kt, xb, xq, gt, flat):
    """IVF_RABITQ with its default raw refine store through the public API."""
    rbq, ids, out = _serve(kt, "IVF_RABITQ", "rbq", xb, xq, gt, RBQ_BUILD, RBQ_SEARCH, RBQ_RECALL_FLOOR)
    out["rbq_profile"] = _profile_search(lambda: _search(rbq, kt, xq, RBQ_SEARCH))
    out.update(_filtered_and_round_trip(kt, "IVF_RABITQ", "rbq", rbq, ids, xb, xq, flat, RBQ_SEARCH)[0])
    out["rbq_exact_recall_1k"], out["rbq_fast_recall_1k"] = _exact_vs_fast(
        kt, rbq, xq[:1000], gt[:1000], RBQ_SEARCH, "IVF_RABITQ"
    )
    return out


def gist_pq_path(kt, nb=100_000, nq=1_000):
    """The bench's GIST leg of IVF_PQ (m=96) at the reduced size of the
    docstring, against FLAT ground truth on its own corpus."""
    from knowhere_tpu_torch.ops import adc_cuda

    t0 = time.perf_counter()
    xb, xq = gen_corpus(nb, nq, 960, seed=0)
    out = {"gist_corpus_s": time.perf_counter() - t0}
    _, gt = _flat_truth(kt, xb, xq)
    pq = kt.IndexFactory.Instance().Create("IVF_PQ").value()
    st, out["gist_pq_build_s"] = _timed(lambda: pq.Build(kt.GenDataSetFromArray(xb), GIST_PQ_BUILD))
    if st != kt.Status.success:
        raise RuntimeError(f"GIST IVF_PQ Build: {st.name}")
    m, ksub, _ = pq.node._store["books"].shape
    out["gist_lut_entries"] = m * ksub
    before = adc_cuda.adc_scan_tasks.launches
    (ids, _), out["gist_pq_search_s"] = _timed(lambda: _search(pq, kt, xq, GIST_PQ_SEARCH))
    if m * ksub != 24576 or adc_cuda.adc_scan_tasks.launches == before:
        raise AssertionError(f"the ADC kernel did not serve m * ksub = {m * ksub} (want 24576)")
    out["gist_pq_recall_at_10"] = recall_at(ids, gt)
    out["gist_exact_recall"], out["gist_fast_recall"] = _exact_vs_fast(kt, pq, xq, gt, GIST_PQ_SEARCH)
    return out


def _peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def _warm(fn, reps: int = 5):
    """fn() once to warm up, then reps timed calls: (the last output, the
    times in ms, their median)."""
    out = fn()
    times = []
    for _ in range(reps):
        out, dt = _timed(fn)
        times.append(dt * 1e3)
    return out, times, float(np.median(times))


def _store_gb(idx, *keys) -> dict:
    """Device GB of the index's store tensors ``keys`` (the refine store as
    "refine")."""
    node = idx.node
    out = {}
    for key in keys:
        t = node._refine_store.data if key == "refine" else node._store[key]
        out[key] = t.numel() * t.element_size() / 1e9
    return out


def scann_path(kt, xb, xq, gt, flat):
    """SCANN at the bench's leg through the public API: 4-bit PQ in the
    nibble layout scanned by the ADC kernel (every launch of one search held
    against adc_scan_plain), the raw rows re-scoring max(k, reorder_k)
    candidates; recall against the FLAT truth, a 50% bitset, a round trip and
    GetVectorByIds bit-equal to the input rows."""
    import torch

    from knowhere_tpu_torch.ops.ivf_scan import _nib

    torch.cuda.reset_peak_memory_stats()
    scann, ids, out = _serve(kt, "SCANN", "scann", xb, xq, gt, SCANN_BUILD, SCANN_SEARCH, SCANN_RECALL_FLOOR)
    out["scann_tpu_anchor_recall_at_10"] = SCANN_TPU_ANCHOR  # the reference's, not the port's
    node = scann.node
    if node._pq.codebooks.shape != (64, 16, 2) or not _nib(node._store):
        raise AssertionError(f"SCANN's codes are not the m=64 nibble layout: {node._pq.codebooks.shape}")
    out["scann_device_gb"] = _store_gb(scann, "codes", "refine")
    held = _adc_real_launch(lambda: _search(scann, kt, xq, SCANN_SEARCH))
    out["scann_adc_held"] = {k: v for k, v in held.items() if k != "adc_vs_plain"}
    out["scann_adc_held"]["max_abs_err"] = max(c["max_abs_err"] for c in held["adc_vs_plain"])
    out["scann_adc_held"]["min_pos_agree"] = min(c["pos_agree"] for c in held["adc_vs_plain"])
    out["scann_adc_held"]["kk"] = sorted({c["kk"] for c in held["adc_vs_plain"]})
    out.update(_filtered_and_round_trip(kt, "SCANN", "scann", scann, ids, xb, xq, flat, SCANN_SEARCH)[0])
    sel = np.random.default_rng(2).choice(len(xb), 1000, replace=False)
    got = scann.GetVectorByIds(kt.GenIdsDataSet(sel)).value().tensor
    out["scann_get_vector_bit_equal"] = bool(np.array_equal(np.asarray(got).view(np.uint32), xb[sel].view(np.uint32)))
    if not out["scann_get_vector_bit_equal"]:
        raise AssertionError("SCANN GetVectorByIds differs from the input rows")
    out["scann_peak_device_gb"] = _peak_gb()
    return out


def simhash(x: np.ndarray, proj: np.ndarray, chunk: int = 131072) -> np.ndarray:
    """The sign bits of x @ proj, packed eight a byte, LSB first."""
    out = np.empty((len(x), proj.shape[1] // 8), np.uint8)
    for s0 in range(0, len(x), chunk):
        out[s0 : s0 + chunk] = np.packbits(x[s0 : s0 + chunk] @ proj > 0, axis=1, bitorder="little")
    return out


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Popcount of a ^ b over the last axis of packed rows."""
    return np.unpackbits(a ^ b, axis=-1).sum(-1)


def _tie_aware_recall(cq, cb, ids, kth) -> float:
    """The share of returned ids whose true HAMMING distance is at most the
    true k-th distance of their query (any of a tie may count); an empty
    slot counts as a miss."""
    d = _hamming(cb[np.clip(ids, 0, None)], cq[:, None, :])
    return float(((d <= kth[:, None]) & (ids >= 0)).mean())


def binary_path(kt, xb, xq, nb=None):
    """BIN_FLAT truth and BIN_IVF_FLAT over 256-bit SimHash codes of the
    corpus: HAMMING served by the f32 scan (every launch of one search held
    against f32_scan_plain: max abs error 0, positions 1.0), tie-aware
    recall, warm search; JACCARD on a second index takes the plain scan (no
    f32-scan launch)."""
    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    torch.cuda.reset_peak_memory_stats()
    nb = nb or BIN_NB
    proj = np.random.default_rng(7).standard_normal((xb.shape[1], BIN_BITS)).astype(np.float32)
    t0 = time.perf_counter()
    cb, cq = simhash(xb[:nb], proj), simhash(xq, proj)
    out = {"bin_nb": nb, "bin_codes_s": time.perf_counter() - t0}

    def ds(a):
        return kt.GenDataSet(a.shape[0], BIN_BITS, a)

    def build(name, metric):
        idx = kt.IndexFactory.Instance().Create(name, data_type="bin1").value()
        st, secs = _timed(lambda: idx.Build(ds(cb), dict(BIN_BUILD, metric_type=metric)))
        if st != kt.Status.success:
            raise RuntimeError(f"{name} {metric} Build: {st.name}")
        return idx, secs

    def search(idx, q, metric):
        res = idx.Search(ds(q), dict(BIN_SEARCH, metric_type=metric), kt.BitsetView())
        if not res.has_value():
            raise RuntimeError(f"binary Search failed: {res.what()}")
        k = BIN_SEARCH["k"]
        return res.value().ids.reshape(len(q), k), res.value().distance.reshape(len(q), k)

    flat, out["bin_flat_build_s"] = build("BIN_FLAT", "HAMMING")
    (gt, gt_d), out["bin_flat_search_s"] = _timed(lambda: search(flat, cq, "HAMMING"))
    sample = np.arange(0, len(cq), 97)
    if not np.array_equal(gt_d[sample], _hamming(cb[gt[sample]], cq[sample][:, None, :]).astype(np.float32)):
        raise AssertionError("BIN_FLAT distances differ from the popcount of the xor")
    kth = gt_d[:, -1]
    ivf, out["bin_ivf_build_s"] = build("BIN_IVF_FLAT", "HAMMING")
    out["bin_device_gb"] = _store_gb(ivf, "data")
    (ids, dists), out["bin_search_ms_all"], out["bin_search_ms_median"] = _warm(lambda: search(ivf, cq, "HAMMING"))
    out["bin_qps"] = len(cq) / out["bin_search_ms_median"] * 1e3
    if (ids < 0).any() or not np.array_equal(dists, _hamming(cb[ids], cq[:, None, :]).astype(np.float32)):
        raise AssertionError("BIN_IVF_FLAT returned an empty slot or a distance that is not the popcount")
    out["bin_recall_at_10_tie_aware"] = _tie_aware_recall(cq, cb, ids, kth)
    out["bin_recall_at_10_ids"] = recall_at(ids, gt)
    if out["bin_recall_at_10_tie_aware"] < BIN_RECALL_FLOOR:
        raise AssertionError(f"BIN_IVF_FLAT tie-aware recall {out['bin_recall_at_10_tie_aware']} < {BIN_RECALL_FLOOR}")
    _, held = _hold_launches(lambda: search(ivf, cq, "HAMMING"), ("ivf_f32_scan",))
    out["bin_f32_held"] = _held_summary(held)["ivf_f32_scan"]
    del ivf, flat
    torch.cuda.empty_cache()

    jac, out["bin_jaccard_build_s"] = build("BIN_IVF_FLAT", "JACCARD")
    qj = cq[:BIN_JACCARD_NQ]
    before = ivf_cuda.f32_scan_tasks.launches
    (jids, jd), out["bin_jaccard_search_s"] = _timed(lambda: search(jac, qj, "JACCARD"))
    out["bin_jaccard_f32_launches"] = ivf_cuda.f32_scan_tasks.launches - before
    if out["bin_jaccard_f32_launches"]:
        raise AssertionError("BIN_IVF_FLAT JACCARD launched the f32 scan (it takes the plain scan)")
    if (jids < 0).any() or not ((jd >= 0) & (jd <= 1)).all():
        raise AssertionError("BIN_IVF_FLAT JACCARD returned an empty slot or a distance outside [0, 1]")
    out["bin_peak_device_gb"] = _peak_gb()
    return out


def typed_path(kt, xb, xq, wrappers):
    """IVF_FLAT over the corpus cast to fp16, against FLAT on the f32 view of
    the same rows (tests/test_typed_storage.py): the plain scan, no kernel
    launched by the search, GetVectorByIds float16 rows bit-equal to the
    input; then a bf16 IVF_FLAT (its rows given as bf16 bit patterns, the
    port's host form) through Serialize / Deserialize with no ml_dtypes
    loaded. ``wrappers``: the kernels whose launches the search must not
    add to."""
    import torch

    from knowhere_tpu_torch.utils.bf16 import bf16_bits

    torch.cuda.reset_peak_memory_stats()
    xb16, xq16 = xb.astype(np.float16), xq.astype(np.float16)
    flat, gt = _flat_truth(kt, xb16.astype(np.float32), xq16.astype(np.float32))
    del flat
    torch.cuda.empty_cache()
    out = {}
    idx = kt.IndexFactory.Instance().Create("IVF_FLAT", data_type="fp16").value()
    st, out["typed_build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb16), TYPED_BUILD))
    if st != kt.Status.success:
        raise RuntimeError(f"IVF_FLAT fp16 Build: {st.name}")
    if idx.node._store["data"].dtype != torch.bfloat16 or "i8_nrm" in idx.node._store:
        raise AssertionError("the fp16 store is not held in bf16 without an int8 sidecar")
    out["typed_device_gb"] = _store_gb(idx, "data")
    before = {n: w.launches for n, w in wrappers.items()}
    (ids, _), out["typed_search_ms_all"], out["typed_search_ms_median"] = _warm(
        lambda: _search(idx, kt, xq16, TYPED_SEARCH)
    )
    out["typed_scan_launches"] = {n: w.launches - before[n] for n, w in wrappers.items()}
    if any(out["typed_scan_launches"].values()):
        raise AssertionError(f"a scan kernel served the fp16 store: {out['typed_scan_launches']}")
    out["typed_qps"] = len(xq) / out["typed_search_ms_median"] * 1e3
    out["typed_recall_at_10"] = recall_at(ids, gt)
    if (ids < 0).any() or out["typed_recall_at_10"] < TYPED_RECALL_FLOOR:
        raise AssertionError(f"IVF_FLAT fp16 recall@10 {out['typed_recall_at_10']} < {TYPED_RECALL_FLOOR}")
    sel = np.random.default_rng(3).choice(len(xb), 1000, replace=False)
    got = np.asarray(idx.GetVectorByIds(kt.GenIdsDataSet(sel)).value().tensor)
    if got.dtype != np.float16 or not np.array_equal(got.view(np.uint16), xb16[sel].view(np.uint16)):
        raise AssertionError(f"IVF_FLAT fp16 GetVectorByIds: {got.dtype}, not the input rows")
    out["typed_peak_device_gb"] = _peak_gb()
    del idx
    torch.cuda.empty_cache()

    bits = bf16_bits(xb[:TYPED_BF16_NB])
    b16 = kt.IndexFactory.Instance().Create("IVF_FLAT", data_type="bf16").value()
    if b16.Build(kt.GenDataSetFromArray(bits), {"metric_type": "L2", "nlist": 256}) != kt.Status.success:
        raise RuntimeError("IVF_FLAT bf16 Build failed")
    bs = kt.BinarySet()
    if b16.Serialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT bf16 Serialize failed")
    again = kt.IndexFactory.Instance().Create("IVF_FLAT", data_type="bf16").value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError("IVF_FLAT bf16 Deserialize failed")
    q = bf16_bits(xq[:1000])
    out["bf16_roundtrip_ids_identical"] = bool(np.array_equal(
        _search(again, kt, q, TYPED_SEARCH)[0], _search(b16, kt, q, TYPED_SEARCH)[0]
    ))
    if not out["bf16_roundtrip_ids_identical"] or "ml_dtypes" in sys.modules:
        raise AssertionError("the bf16 round trip changed the ids, or loaded ml_dtypes")
    return out


def _cc_run(kt, name, xb, xq, xq_eval, gt, one_shot, n0, batches, nlist):
    """Build ``name`` on xb[:n0]; a writer Adds the rest in ``batches``
    batches while CC_READERS threads search xq in a loop. Every reader result
    must be full with ids in range; every merge's epoch must serve through
    the int8 scan; after the last Add each of CC_READBACK acknowledged rows,
    searched by its own vector, comes back first (IVF_FLAT_CC: at distance
    0 up to f32 rounding; IVF_SQ_CC scores merged rows by their SQ8 decode);
    the final recall@10 of xq_eval against gt must reach one_shot -
    CC_RECALL_SLACK."""
    import threading

    import torch

    from knowhere_tpu_torch.ops import ivf_cuda

    torch.cuda.reset_peak_memory_stats()
    nb, k = len(xb), CC_SEARCH["k"]
    idx = kt.IndexFactory.Instance().Create(name).value()
    st, build_s = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb[:n0]), dict(CC_SEARCH, nlist=nlist)))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Build: {st.name}")
    stop, errors, reader_ms = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            try:
                (ids, d), dt = _timed(lambda: _search(idx, kt, xq, CC_SEARCH))
            except Exception as e:  # noqa: BLE001 - reported by the main thread
                errors.append(repr(e))
                return
            if (ids < 0).any() or ids.max() >= nb or not np.isfinite(d).all():
                errors.append(f"a reader got a short or out-of-range result (max id {ids.max()})")
                return
            reader_ms.append(dt * 1e3)

    threads = [threading.Thread(target=reader) for _ in range(CC_READERS)]
    for t in threads:
        t.start()
    merges, add_s, step = [], 0.0, (nb - n0) // batches
    try:
        for b in range(batches):
            lo, hi = n0 + b * step, (nb if b == batches - 1 else n0 + (b + 1) * step)
            pending = idx.node._pending_count
            st, dt = _timed(lambda: idx.Add(kt.GenDataSetFromArray(xb[lo:hi]), CC_SEARCH))
            add_s += dt
            if st != kt.Status.success:
                raise RuntimeError(f"{name} Add: {st.name}")
            if idx.node._pending_count == 0:  # this Add merged the pending rows into a new epoch
                before = ivf_cuda.int8_scan_tasks.launches
                _search(idx, kt, xq[:16], CC_SEARCH)
                if "i8_nrm" not in idx.node._store or ivf_cuda.int8_scan_tasks.launches == before:
                    raise AssertionError(f"{name}: the epoch after merge {len(merges) + 1} did not serve the int8 scan")
                merges.append({"after_add": b + 1, "pending_merged": pending + hi - lo, "add_s": dt})
            if errors:
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=600)
    if errors:
        raise AssertionError(f"{name} reader: {errors[0]}")
    if idx.Count() != nb or not merges or not reader_ms:
        raise AssertionError(f"{name}: Count {idx.Count()} of {nb}, {len(merges)} merges, {len(reader_ms)} reads")
    out = {"rows": nb, "build_rows": n0, "build_s": build_s, "merges": merges, "add_rows_per_s": (nb - n0) / add_s,
           "reader_searches": len(reader_ms), "reader_ms_median": float(np.median(reader_ms)),
           "reader_ms_p99": float(np.percentile(reader_ms, 99)), "pending_after_last_add": idx.node._pending_count}
    sel = np.random.default_rng(4).choice(np.arange(n0, nb), CC_READBACK, replace=False)
    ids, d = _search(idx, kt, xb[sel], CC_SEARCH)
    tol = 1e-5 * (xb[sel].astype(np.float64) ** 2).sum(1) + 1e-3
    out["readback_top1_own_id"] = float((ids[:, 0] == sel).mean())
    out["readback_max_own_dist"] = float(d[:, 0].max())
    if out["readback_top1_own_id"] < 1.0 or (name == "IVF_FLAT_CC" and (d[:, 0] > tol).any()):
        raise AssertionError(f"{name}: an acknowledged row did not come back first at distance 0: {out}")
    (ids, _), out["final_search_ms_all"], out["final_search_ms_median"] = _warm(
        lambda: _search(idx, kt, xq_eval, CC_SEARCH)
    )
    out["recall_at_10"], out["one_shot_recall_at_10"] = recall_at(ids, gt), one_shot
    if out["recall_at_10"] < one_shot - CC_RECALL_SLACK:
        raise AssertionError(f"{name} recall {out['recall_at_10']} < one-shot {one_shot} - {CC_RECALL_SLACK}")
    out["peak_device_gb"] = _peak_gb()
    return out


def _one_shot(kt, name, xs, qs, nlist, k=10):
    """(FLAT truth of qs over xs, recall@10 of ``name`` built on all of xs
    at once): the bar of a cc run over rows other than the main path's."""
    import torch

    _, gt = _flat_truth(kt, xs, qs, k)
    ref = kt.IndexFactory.Instance().Create(name).value()
    if ref.Build(kt.GenDataSetFromArray(xs), dict(CC_SEARCH, nlist=nlist)) != kt.Status.success:
        raise RuntimeError(f"{name} one-shot Build failed")
    recall = recall_at(_search(ref, kt, qs, CC_SEARCH)[0], gt)
    del ref
    torch.cuda.empty_cache()
    return gt, recall


def cc_path(kt, xb, xq, gt, one_shot_recall):
    """IVF_FLAT_CC at CC_NB rows (at the full corpus, the main path's FLAT
    truth and one-shot IVF_FLAT recall are the bar), then IVF_SQ_CC at
    CC_SQ_NB rows against a one-shot IVF_SQ_CC build of the same rows, each
    with concurrent readers."""
    if CC_NB != len(xb):
        gt, one_shot_recall = _one_shot(kt, "IVF_FLAT", xb[:CC_NB], xq, CC_NLIST)
    out = {"ivf_flat_cc": _cc_run(kt, "IVF_FLAT_CC", xb[:CC_NB], xq[:CC_NQ], xq, gt, one_shot_recall,
                                  CC_N0 * CC_NB // 1_000_000, CC_BATCHES, CC_NLIST)}
    xs, qs = xb[:CC_SQ_NB], xq[:CC_NQ]
    gt_s, one_shot = _one_shot(kt, "IVF_SQ_CC", xs, qs, CC_SQ_NLIST)
    out["ivf_sq_cc"] = _cc_run(kt, "IVF_SQ_CC", xs, qs, qs, gt_s, one_shot, CC_SQ_N0, CC_BATCHES, CC_SQ_NLIST)
    return out


# (name, search): torch-profiler passes run after every timed search of the
# script (late_profiles), so that the searches timed on the paths before
# them do not follow a profiler pass, which can slow the searches timed
# after it in the same process; the closures keep their indexes alive
_LATE_PROFILES = []


def _profile_later(name, fn, extra=None) -> None:
    """extra(fn), if given, runs after the profiler pass and adds to its numbers."""
    _LATE_PROFILES.append((name, fn, extra))


def late_profiles() -> dict:
    out = {}
    for name, fn, extra in _LATE_PROFILES:
        out[name] = _profile_search(fn)
        if extra is not None:
            out[name].update(extra(fn))
    _LATE_PROFILES.clear()
    return out


def _held_kernels() -> dict:
    """The kernels whose launches a path's run can hold against their plain
    versions: (the name ops/ivf_scan launches it by, its plain version,
    rtol, atol, position agreement, empty slots exactly (-1e38, -1)), the
    tolerances of their own checks in step 3; the f32 scan's over {0,1}
    rows (the binary path), where every product and sum is an exact
    integer: scores and positions equal. The ADC table (sentinels None)
    returns one table, held bit for bit against compute_qlut's."""
    from knowhere_tpu_torch.ops import adc_cuda, ivf_cuda

    return {
        "ivf_int8_scan": ("int8_scan_tasks", ivf_cuda.int8_scan_plain, INT8_RTOL, 0.0, 1.0, False),
        "ivf_adc_scan": ("adc_scan_tasks", adc_cuda.adc_scan_plain, ADC_RTOL, ADC_ATOL, ADC_POS_AGREE, True),
        "ivf_adc_qtable": ("adc_qtable", adc_cuda.compute_qlut, 0.0, 0.0, 1.0, None),
        "ivf_f32_scan": ("f32_scan_tasks", ivf_cuda.f32_scan_plain, 0.0, 0.0, 1.0, True),
    }


def _table_agreement(got, want) -> dict:
    """The ADC table kernel's output against compute_qlut's on the same
    inputs: entries, largest gap in f32 units of the last place, entries
    that differ, largest absolute error; ok only bit for bit."""
    import torch

    gap = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    out = {"rows": int(got.shape[0]), "entries": got.numel(), "max_ulp_gap": int(gap.max()),
           "entries_differing": int((gap > 0).sum()), "max_abs_err": float((got - want).abs().max())}
    out["ok"] = out["max_ulp_gap"] == 0
    return out


def _hold_launches(fn, names, limit=None, tol=None):
    """fn() with every launch of the kernels ``names`` held against its
    plain version on the same inputs as it returns (_held_kernels; ``tol``,
    if given, replaces their (rtol, atol, position agreement); only the
    first ``limit`` launches of each when given); the first that disagrees
    raises. Returns (fn's output, {name: one agreement a launch, with its
    tasks, empty tasks, Qg and kk; the table's with its query rows}). The
    checks sync the host: not for timed calls."""
    import torch

    from knowhere_tpu_torch.ops import ivf_scan

    spec = _held_kernels()
    real = {n: getattr(ivf_scan, spec[n][0]) for n in names}
    seen = {n: [] for n in names}

    def holding(name):
        _, plain, rtol, atol, pos_agree, sentinels = spec[name]
        if tol is not None:
            rtol, atol, pos_agree = tol

        def call(*args, **kw):
            if limit is not None and len(seen[name]) >= limit:
                return real[name](*args, **kw)
            if sentinels is None:
                got = real[name](*args, **kw)
                agree = _table_agreement(got, plain(*args, **kw))
                seen[name].append(agree)
                if not agree["ok"]:
                    raise AssertionError(f"{name} differs from compute_qlut on a path launch: {agree}")
                return got
            s_k, p_k = real[name](*args, **kw)
            s_p, p_p = plain(*args, **kw)
            torch.cuda.synchronize()
            agree = _agreement(s_k, p_k, s_p, p_p, rtol, atol, pos_agree, sentinels)
            agree["scores_differing"] = int((s_k.view(torch.int32) != s_p.view(torch.int32)).sum())
            agree.update(tasks=int(args[1].numel()), empty_tasks=int((args[1] <= 0).sum()),
                         Qg=int(s_k.shape[1]), kk=int(kw["kk"]))
            seen[name].append(agree)
            if not agree["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version on a path launch: {agree}")
            return s_k, p_k

        return call

    for n in names:
        setattr(ivf_scan, spec[n][0], holding(n))
    try:
        out = fn()
    finally:
        for n in names:
            setattr(ivf_scan, spec[n][0], real[n])
    return out, seen


def _hold_fresh(fn):
    """fn() with every graph_fresh launch of both walks held against
    fresh_step_plain on clones of its inputs: fresh, the ring, the masked
    scores and new_p bit for bit; the first that differs raises, as does a
    run that launches none. Returns (fn's output, {launches held, their
    (nq, G, V, ef, dedup) shapes, those whose ring and beam take more than
    one staging chunk}). The checks sync the host: not for timed calls."""
    import torch

    from knowhere_tpu_torch.ops import cuda_build, graph, graph_inline

    real, plain = graph.fresh_step, graph.fresh_step_plain
    chunk = cuda_build.lib().kw_graph_fresh_chunk_ids()
    seen = {"launches_held": 0, "shapes": set(), "past_one_chunk": 0}

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def call(nbrs, visited, bids, scores, off, dedup):
        ring, sc = visited.clone(), scores.clone()
        want = (*plain(nbrs, ring, bids, sc, off, dedup), ring)
        got = real(nbrs, visited, bids, scores, off, dedup)
        nq, G = nbrs.shape
        V, E = visited.shape[1], bids.shape[1]
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip((*got, visited), want)):
            raise AssertionError(f"graph_fresh differs from fresh_step_plain on a path launch: "
                                 f"nq {nq}, G {G}, V {V}, ef {E}, off {off}, dedup {dedup}")
        seen["launches_held"] += 1
        seen["shapes"].add((nq, G, V, E, bool(dedup)))
        seen["past_one_chunk"] += V + E > chunk
        return got

    # the real wrapper counts its launches on the name it is called by
    call.launches = real.launches
    graph.fresh_step = graph_inline.fresh_step = call
    try:
        out = fn()
    finally:
        graph.fresh_step = graph_inline.fresh_step = real
        real.launches = call.launches
    seen["shapes"] = sorted(seen["shapes"])
    if not seen["launches_held"]:
        raise AssertionError("the held run launched no graph_fresh")
    return out, seen


def _held_summary(seen: dict) -> dict:
    """One line a kernel of _hold_launches' agreements; raises if a kernel
    held was not launched."""
    out = {}
    for name, checks in seen.items():
        if not checks:
            raise AssertionError(f"the held run launched no {name}")
        if "max_ulp_gap" in checks[0]:  # the ADC table
            out[name] = {
                "launches_held": len(checks), "rows": sum(c["rows"] for c in checks),
                "entries": sum(c["entries"] for c in checks), "max_ulp_gap": max(c["max_ulp_gap"] for c in checks),
                "max_abs_err": max(c["max_abs_err"] for c in checks),
            }
            continue
        out[name] = {
            "launches_held": len(checks), "tasks": sum(c["tasks"] for c in checks),
            "empty_tasks": sum(c["empty_tasks"] for c in checks),
            "Qg": sorted({c["Qg"] for c in checks}), "kk": sorted({c["kk"] for c in checks}),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "min_pos_agree": min(c["pos_agree"] for c in checks),
            "scores_differing": sum(c["scores_differing"] for c in checks),
        }
    return out


def _adc_real_launch(fn) -> dict:
    """One more fn() with the search's ADC launches held against
    adc_scan_plain (_hold_launches: the ADC tolerance, every empty slot
    exactly (-1e38, -1)) and its table launches against compute_qlut, bit
    for bit; its tasks and those with nrows == 0 (padding of
    the device task builder's static bound, which the kernel skips) are
    counted. Its task builder is wrapped to count the query rows of the
    non-empty tasks and those that are padding (qids < 0, scanned as query
    0 and dropped by the merge). Outside the profiler pass: the counts sync
    the host."""
    from knowhere_tpu_torch.ops import ivf_scan

    real_tasks = ivf_scan._tasks
    seen = {"adc_live_query_rows": 0, "adc_padded_query_rows": 0}

    def counting_tasks(*args, **kw):
        out = real_tasks(*args, **kw)
        if out is not None:
            nr, qids = out[1], out[3]
            live = nr > 0
            seen["adc_live_query_rows"] += int(live.sum()) * qids.shape[1]
            seen["adc_padded_query_rows"] += int(((qids < 0) & live[:, None]).sum())
        return out

    ivf_scan._tasks = counting_tasks
    try:
        _, held = _hold_launches(fn, ("ivf_adc_qtable", "ivf_adc_scan"))
    finally:
        ivf_scan._tasks = real_tasks
    checks = held["ivf_adc_scan"]
    if not checks or not held["ivf_adc_qtable"]:
        raise AssertionError("the IVF_PQ search launched no ADC table or scan")
    seen["adc_qtable_vs_compute_qlut"] = _held_summary({"ivf_adc_qtable": held["ivf_adc_qtable"]})["ivf_adc_qtable"]
    seen["adc_tasks"] = sum(c.pop("tasks") for c in checks)
    seen["adc_empty_tasks"] = sum(c.pop("empty_tasks") for c in checks)
    seen["adc_vs_plain"] = checks
    seen["adc_empty_share"] = seen["adc_empty_tasks"] / max(seen["adc_tasks"], 1)
    seen["adc_padded_row_share"] = seen["adc_padded_query_rows"] / max(seen["adc_live_query_rows"], 1)
    return seen


def _profile_search(fn) -> dict:
    """One torch-profiler pass over fn(): wall ms, device busy ms (the sum of
    the device kernels' time), the idle share, the device ms under each
    library range (graph_inline.seed / walk / rerank, graph.walk,
    hnsw.refine, hnsw.brute_force), the device ms and launches of each of the
    port's CUDA kernels (namespace kw) and the top ops by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_ms(e, attr):
        return (getattr(e, attr, None) or getattr(e, attr.replace("device", "cuda"), 0.0) or 0.0) / 1e3

    avgs = prof.key_averages()
    # the ranges (every span name of utils/tracing.py's callers) appear
    # twice: as host events (device time of the kernels they launched) and
    # as spans on the device timeline, which busy skips
    spans = ("graph_inline.", "graph.", "hnsw.", "ivf.", "ivf_scan.", "knowhere_", "search.")
    is_range = [e.key.startswith(spans) for e in avgs]
    busy = sum(dev_ms(e, "self_device_time_total") for e, r in zip(avgs, is_range)
               if e.device_type == DeviceType.CUDA and not r)
    ranges = {e.key: round(dev_ms(e, "device_time_total"), 3) for e, r in zip(avgs, is_range)
              if r and e.device_type == DeviceType.CPU}
    ops = sorted((e for e in avgs if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")),
                 key=lambda e: dev_ms(e, "self_device_time_total"), reverse=True)
    top = [(e.key, round(dev_ms(e, "self_device_time_total"), 3), e.count) for e in ops[:10]]
    kernels = {e.key.split("(")[0].replace("void ", "")[:90]: (round(dev_ms(e, "self_device_time_total"), 3), e.count)
               for e in avgs if e.device_type == DeviceType.CUDA and "kw::" in e.key}
    if busy > wall:
        raise AssertionError(f"profile: device busy {busy} ms exceeds the wall {wall} ms (time counted twice)")
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall, "ranges": ranges,
            "kernels": kernels, "top_ops": top}


def hnsw_path(kt, xb, xq, gt, flat, search_reps=5):
    """HNSW at the bench's configuration through the public API (see the
    module docstring, step 8). Returns its numbers."""
    from knowhere_tpu_torch.ops import ivf_cuda

    nq, k = len(xq), 10
    search = {"metric_type": "L2", "k": k, "ef": 48}
    out = {}
    idx = kt.IndexFactory.Instance().Create("HNSW").value()
    f32_before = ivf_cuda.f32_scan_tasks.launches
    os.environ["KNOWHERE_BUILD_TIMING"] = "1"  # the build prints its phases
    try:
        st, out["hnsw_build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), HNSW_BUILD))
    finally:
        del os.environ["KNOWHERE_BUILD_TIMING"]
    if st != kt.Status.success:
        raise RuntimeError(f"HNSW Build: {st.name}")
    out["hnsw_build_f32_scan_launches"] = ivf_cuda.f32_scan_tasks.launches - f32_before
    if out["hnsw_build_f32_scan_launches"] == 0:
        raise AssertionError("the HNSW build's kNN graph did not run the f32 scan kernel")
    inline = idx.node._inline
    if inline is None:
        raise AssertionError("the HNSW inline walk is not active at 1M rows")
    out["hnsw_inline_bits"] = inline.bits
    ids, dists = _search(idx, kt, xq, search)  # warm-up
    times = []
    for _ in range(search_reps):
        (ids, dists), dt = _timed(lambda: _search(idx, kt, xq, search))
        times.append(dt)
    out["hnsw_search_s_all"] = times
    out["hnsw_qps"] = nq / float(np.median(times))
    out["hnsw_recall_at_10"] = recall_at(ids, gt)
    out["hnsw_tpu_anchor_recall_at_10"] = HNSW_TPU_ANCHOR  # the reference's, not the port's
    if not np.isfinite(dists).all() or ids.shape != (nq, k) or (ids < 0).any():
        raise AssertionError("HNSW results not finite / wrong shape / short")
    if out["hnsw_recall_at_10"] < HNSW_RECALL_FLOOR:
        raise AssertionError(f"HNSW recall@10 {out['hnsw_recall_at_10']} < {HNSW_RECALL_FLOOR}")
    out["hnsw_profile"] = _profile_search(lambda: _search(idx, kt, xq, search))
    for ef in (32, 48, 64):
        (ids_e, _), dt = _timed(lambda: _search(idx, kt, xq, dict(search, ef=ef)))
        out[f"hnsw_ef{ef}"] = {"recall_at_10": recall_at(ids_e, gt), "qps": nq / dt}

    drop = np.random.default_rng(1).random(len(xb)) < 0.5
    (fids, _), out["hnsw_filtered_s"] = _timed(lambda: _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(drop)))
    if (fids < 0).any() or drop[fids].any():
        raise AssertionError("HNSW filtered search returned a filtered or empty id")
    fgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": k}, kt.BitsetView.from_bool_array(drop))
    out["hnsw_filtered_recall_at_10"] = recall_at(fids, fgt)
    out["hnsw_filtered_tpu_anchor"] = HNSW_FILTERED_ANCHOR
    if out["hnsw_filtered_recall_at_10"] < HNSW_FILTERED_FLOOR:
        raise AssertionError(f"HNSW 50% bitset recall {out['hnsw_filtered_recall_at_10']} < {HNSW_FILTERED_FLOOR}")

    # 95% filtered: the exact-scan fallback must answer
    dense = np.random.default_rng(2).random(len(xb)) < 0.95
    node, calls = idx.node, []
    brute = node._brute_force
    node._brute_force = lambda *a: (calls.append(1), brute(*a))[1]
    try:
        (bids, _), out["hnsw_fallback_s"] = _timed(
            lambda: _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(dense)))
    finally:
        del node._brute_force
    bgt, _ = _search(flat, kt, xq, {"metric_type": "L2", "k": k}, kt.BitsetView.from_bool_array(dense))
    out["hnsw_fallback_recall_at_10"] = recall_at(bids, bgt)
    if not calls or (bids < 0).any() or dense[bids].any() or out["hnsw_fallback_recall_at_10"] < HNSW_FALLBACK_FLOOR:
        raise AssertionError(f"HNSW 95% bitset: fallback calls {len(calls)}, recall {out['hnsw_fallback_recall_at_10']}")

    bs = kt.BinarySet()
    if idx.Serialize(bs) != kt.Status.success:
        raise RuntimeError("HNSW Serialize failed")
    again = kt.IndexFactory.Instance().Create("HNSW").value()
    (st, out["hnsw_load_s"]) = _timed(lambda: again.Deserialize(bs))
    if st != kt.Status.success:
        raise RuntimeError("HNSW Deserialize failed")
    out["hnsw_roundtrip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
    if not out["hnsw_roundtrip_ids_identical"]:
        raise AssertionError("HNSW Serialize/Deserialize changed the result ids")
    del idx, again, node, brute

    # the same BinarySet in lean mode: the general walk
    os.environ["KNOWHERE_GRAPH_INLINE"] = "0"
    try:
        lean = kt.IndexFactory.Instance().Create("HNSW").value()
        if lean.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("HNSW Deserialize (lean mode) failed")
    finally:
        del os.environ["KNOWHERE_GRAPH_INLINE"]
    if lean.node._inline is not None:
        raise AssertionError("lean mode built the inline table")
    ids_l, _ = _search(lean, kt, xq, search)  # warm-up
    times = []
    for _ in range(3):
        (ids_l, _), dt = _timed(lambda: _search(lean, kt, xq, search))
        times.append(dt)
    out["hnsw_lean_profile"] = _profile_search(lambda: _search(lean, kt, xq, search))
    out["hnsw_lean_search_s_all"] = times
    out["hnsw_lean_qps"] = nq / float(np.median(times))
    out["hnsw_lean_recall_at_10"] = recall_at(ids_l, gt)
    out["hnsw_lean_tpu_anchor"] = HNSW_LEAN_ANCHOR
    if out["hnsw_lean_recall_at_10"] < HNSW_LEAN_FLOOR:
        raise AssertionError(f"HNSW lean-mode recall {out['hnsw_lean_recall_at_10']} < {HNSW_LEAN_FLOOR}")
    return out


def _graph_build(kt, name, x, cfg, dt="fp32", ds=None):
    """Create and Build ``name`` over x; (index, build seconds)."""
    idx = kt.IndexFactory.Instance().Create(name, data_type=dt).value()
    st, secs = _timed(lambda: idx.Build(ds(x) if ds else kt.GenDataSetFromArray(x), cfg))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} {dt} Build: {st.name}")
    return idx, secs


def _round_trip(kt, idx, name, dt, search_fn, ids):
    """Serialize -> Deserialize into a fresh index; the same ids required."""
    bs = kt.BinarySet()
    if idx.Serialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} {dt} Serialize failed")
    again = kt.IndexFactory.Instance().Create(name, data_type=dt).value()
    if again.Deserialize(bs) != kt.Status.success:
        raise RuntimeError(f"{name} {dt} Deserialize failed")
    same = bool(np.array_equal(search_fn(again), ids))
    if not same:
        raise AssertionError(f"{name} {dt}: Serialize/Deserialize changed the result ids")
    return same, bs


def _floor(out, key, floor):
    """Record a recall under its floor; graph_families_path raises after its
    last leg, with every number it took."""
    if out[key] < floor:
        out.setdefault("below_floor", []).append([key, out[key], floor])


def graph_families_path(kt, xb, xq, fp32_hnsw_recall):
    """HNSW over the corpus cast to fp16 at 1M x 128 (its kNN graph through
    the f32 scan, the first launch held against f32_scan_plain; the general
    walk over the bf16-held rows, as the reference serves them, its round
    trip's graph_fresh launches held bit for bit), then
    GRAPH_NB-row legs: bf16 and int8 HNSW, binary HNSW over SimHash codes
    (above 65,536 rows: the IP-ranked f32 build route, a launch held
    exactly), SVS_VAMANA_LVQ (inline forced, and lean), SVS_VAMANA_LEANVEC,
    GPU_CUVS_CAGRA, one FAST search each of GPU_CUVS_IVF_FLAT (int8 scan)
    and GPU_CUVS_IVF_PQ (ADC scan), feder's JSON on the fp16 HNSW and the
    cuVS IVF_FLAT, and KMEANS Train on 1M x 128 twice (bit-equal) with its
    Assign against FLAT's nearest centroid. Each index is freed before the
    next is built."""
    import torch

    from knowhere_tpu_torch.ops import adc_cuda, ivf_cuda
    from knowhere_tpu_torch.utils.bf16 import bf16_bits, bf16_to_f32

    f32 = ivf_cuda.f32_scan_tasks
    out = {"graph_nb": GRAPH_NB, "graph_nq": GRAPH_NQ}
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()

    # --- fp16 HNSW at full size ---------------------------------------------
    xb16, xq16 = xb.astype(np.float16), xq.astype(np.float16)
    flat, gt = _flat_truth(kt, xb16.astype(np.float32), xq16.astype(np.float32))
    drop = np.random.default_rng(11).random(len(xb)) < 0.5
    fgt, _ = _search(flat, kt, xq16.astype(np.float32), {"metric_type": "L2", "k": 10},
                     kt.BitsetView.from_bool_array(drop))
    del flat
    torch.cuda.empty_cache()
    before = f32.launches
    (idx, out["fp16_build_s"]), held = _hold_launches(
        lambda: _graph_build(kt, "HNSW", xb16, HNSW_BUILD, "fp16"), ("ivf_f32_scan",),
        limit=1, tol=(F32_RTOL, F32_ATOL, F32_POS_AGREE))
    out["fp16_build_f32_scan_launches"] = f32.launches - before
    out["fp16_build_f32_held"] = _held_summary(held)["ivf_f32_scan"]
    node = idx.node
    if node._store["data"].dtype != torch.bfloat16 or node._inline is not None:
        raise AssertionError("the fp16 HNSW store is not held in bf16 on the general walk")
    out["fp16_device_gb"] = _store_gb(idx, "data")
    (ids, dists), out["fp16_search_ms_all"], out["fp16_search_ms_median"] = _warm(
        lambda: _search(idx, kt, xq16, GRAPH_SEARCH))
    out["fp16_qps"] = len(xq) / out["fp16_search_ms_median"] * 1e3
    out["fp16_recall_at_10"] = recall_at(ids, gt)
    out["fp32_hnsw_recall_at_10_same_run"] = fp32_hnsw_recall
    out["fp16_short_rows"] = int((ids < 0).any(1).sum())
    if not np.isfinite(dists[ids >= 0]).all():
        raise AssertionError("fp16 HNSW returned a distance that is not finite")
    _floor(out, "fp16_recall_at_10", FP16_HNSW_FLOOR)
    (fids, _), out["fp16_filtered_s"] = _timed(
        lambda: _search(idx, kt, xq16, GRAPH_SEARCH, kt.BitsetView.from_bool_array(drop)))
    if drop[fids[fids >= 0]].any():
        raise AssertionError("fp16 HNSW filtered search returned a filtered id")
    out["fp16_filtered_recall_at_10"] = recall_at(fids, fgt)
    # the reloaded index's search (untimed) holds the general walk's launches
    (out["fp16_roundtrip_ids_identical"], _), out["fp16_fresh_held"] = _hold_fresh(lambda: _round_trip(
        kt, idx, "HNSW", "fp16", lambda again: _search(again, kt, xq16, GRAPH_SEARCH)[0], ids))
    sel = np.random.default_rng(4).choice(len(xb), 1000, replace=False)
    got = np.asarray(idx.GetVectorByIds(kt.GenIdsDataSet(sel)).value().tensor)
    out["fp16_get_vector_bit_equal"] = bool(got.dtype == np.float16 and np.array_equal(got.view(np.uint16),
                                                                                       xb16[sel].view(np.uint16)))
    if not out["fp16_get_vector_bit_equal"]:
        raise AssertionError("fp16 HNSW GetVectorByIds differs from the input rows")
    # feder on the fp16 HNSW: the overview parses, each trace starts at an entry
    meta = json.loads(idx.GetIndexMeta({"overview_levels": 3}).value().get("json_info"))
    scfg = idx.node.CreateConfig()
    kt.Config.load(scfg, GRAPH_SEARCH, kt.Stage.SEARCH)
    (visit, out["feder_hnsw_visit_s"]) = _timed(
        lambda: json.loads(idx.node.GetFederVisit(kt.GenDataSetFromArray(xq16[:2]), scfg).value().get("json_id_set")))
    entries = set(idx.node._entry.tolist())
    if meta["count"] != len(xb) or len(meta["overview_levels"]) != 3 or not all(
            tr and tr[0]["source"] == -1 and tr[0]["id"] in entries for tr in visit):
        raise AssertionError("feder on the fp16 HNSW: a bad overview or a trace not from an entry")
    out["feder_hnsw_visits"] = [len(tr) for tr in visit]
    out["fp16_peak_device_gb"] = _peak_gb()
    del idx, node
    torch.cuda.empty_cache()
    out["fp16_leg_s"] = time.perf_counter() - t_path

    # --- GRAPH_NB-row legs ----------------------------------------------------
    xs, qs = xb[:GRAPH_NB], xq[:GRAPH_NQ]
    flat, gt_s = _flat_truth(kt, xs, qs)
    del flat
    scale = np.float32(127.0 / np.abs(xs).max())
    typed = {
        "bf16": (lambda a: bf16_bits(a), lambda a: bf16_to_f32(bf16_bits(a))),
        "int8": (lambda a: np.clip(np.round(a * scale), -127, 127).astype(np.int8),
                 lambda a: np.clip(np.round(a * scale), -127, 127).astype(np.float32)),
    }
    for dt, (cast, values) in typed.items():
        t0 = time.perf_counter()
        flat, gt_t = _flat_truth(kt, values(xs), values(qs))
        del flat
        before = f32.launches
        idx, out[f"{dt}_build_s"] = _graph_build(kt, "HNSW", cast(xs), HNSW_BUILD, dt)
        out[f"{dt}_build_f32_scan_launches"] = f32.launches - before
        out[f"{dt}_inline"] = idx.node._inline is not None
        q = cast(qs)
        ids, _ = _search(idx, kt, q, GRAPH_SEARCH)
        out[f"{dt}_recall_at_10"] = recall_at(ids, gt_t)
        _floor(out, f"{dt}_recall_at_10", TYPED_HNSW_FLOOR)
        out[f"{dt}_roundtrip_ids_identical"], _ = _round_trip(
            kt, idx, "HNSW", dt, lambda again: _search(again, kt, q, GRAPH_SEARCH)[0], ids)
        del idx
        torch.cuda.empty_cache()
        out[f"{dt}_leg_s"] = time.perf_counter() - t0

    # binary HNSW over 256-bit SimHash codes: the f32 build route ranks {0,1}
    # rows by IP, held exactly (integer scores)
    t0 = time.perf_counter()
    proj = np.random.default_rng(7).standard_normal((xb.shape[1], BIN_BITS)).astype(np.float32)
    cb, cq = simhash(xs, proj), simhash(qs, proj)

    def bds(a):
        return kt.GenDataSet(a.shape[0], BIN_BITS, a)

    bflat, _ = _graph_build(kt, "BIN_FLAT", cb, {"metric_type": "HAMMING"}, "bin1", bds)
    res = bflat.Search(bds(cq), {"metric_type": "HAMMING", "k": 10}, kt.BitsetView()).value()
    kth = res.distance.reshape(len(cq), 10)[:, -1]
    del bflat
    before = f32.launches
    (bidx, out["bin_build_s"]), held = _hold_launches(
        lambda: _graph_build(kt, "HNSW", cb, dict(HNSW_BUILD, metric_type="HAMMING"), "bin1", bds),
        ("ivf_f32_scan",), limit=1)
    out["bin_build_f32_scan_launches"] = f32.launches - before
    out["bin_build_f32_held"] = _held_summary(held)["ivf_f32_scan"]
    if out["bin_build_f32_scan_launches"] == 0:
        raise AssertionError("the binary HNSW build did not run the f32 scan kernel")
    bres = bidx.Search(bds(cq), dict(GRAPH_SEARCH, metric_type="HAMMING"), kt.BitsetView()).value()
    bids = bres.ids.reshape(len(cq), 10)
    if not np.array_equal(bres.distance.reshape(len(cq), 10)[bids >= 0],
                          _hamming(cb[bids], cq[:, None, :]).astype(np.float32)[bids >= 0]):
        raise AssertionError("binary HNSW distances are not the popcount of the xor")
    out["bin_recall_at_10_tie_aware"] = _tie_aware_recall(cq, cb, bids, kth)
    _floor(out, "bin_recall_at_10_tie_aware", BIN_HNSW_FLOOR)
    del bidx
    jidx, out["bin_jaccard_build_s"] = _graph_build(kt, "HNSW", cb, dict(HNSW_BUILD, metric_type="JACCARD"), "bin1", bds)
    jres = jidx.Search(bds(cq[:BIN_JACCARD_NQ]), dict(GRAPH_SEARCH, metric_type="JACCARD"), kt.BitsetView()).value()
    jd = jres.distance[jres.ids >= 0]
    if not ((jd >= 0) & (jd <= 1)).all():
        raise AssertionError("binary HNSW JACCARD returned a distance outside [0, 1]")
    out["bin_jaccard_full_rows"] = float((jres.ids.reshape(-1, 10) >= 0).all(1).mean())
    del jidx
    torch.cuda.empty_cache()
    out["bin_leg_s"] = time.perf_counter() - t0

    # SVS: LVQ (inline forced, then the same BinarySet lean), LeanVec
    t0 = time.perf_counter()
    os.environ["KNOWHERE_GRAPH_INLINE"] = "1"
    try:
        lvq, out["lvq_build_s"] = _graph_build(kt, "SVS_VAMANA_LVQ", xs, HNSW_BUILD)
    finally:
        del os.environ["KNOWHERE_GRAPH_INLINE"]
    if lvq.node._inline is None or lvq.node._kind != "lvq":
        raise AssertionError("SVS_VAMANA_LVQ did not take the inline walk over its LVQ store")
    ids, _ = _search(lvq, kt, qs, GRAPH_SEARCH)
    out["lvq_recall_at_10"] = recall_at(ids, gt_s)
    _floor(out, "lvq_recall_at_10", LVQ_FLOOR)
    out["lvq_device_gb"] = _store_gb(lvq, "codes", "refine")
    bs = kt.BinarySet()
    lvq.Serialize(bs)
    del lvq
    os.environ["KNOWHERE_GRAPH_INLINE"] = "0"
    try:
        lean = kt.IndexFactory.Instance().Create("SVS_VAMANA_LVQ").value()
        if lean.Deserialize(bs) != kt.Status.success or lean.node._inline is not None:
            raise RuntimeError("SVS_VAMANA_LVQ lean Deserialize failed or built the inline table")
    finally:
        del os.environ["KNOWHERE_GRAPH_INLINE"]
    out["lvq_lean_recall_at_10"] = recall_at(_search(lean, kt, qs, GRAPH_SEARCH)[0], gt_s)
    _floor(out, "lvq_lean_recall_at_10", LVQ_FLOOR)
    del lean, bs
    lv, out["leanvec_build_s"] = _graph_build(kt, "SVS_VAMANA_LEANVEC", xs, dict(HNSW_BUILD, svs_leanvec_dim=64))
    if lv.node._lv_proj.shape != (xb.shape[1], 64):
        raise AssertionError("SVS_VAMANA_LEANVEC's basis is not 128 x 64")
    out["leanvec_recall_at_10"] = recall_at(_search(lv, kt, qs, GRAPH_SEARCH)[0], gt_s)
    _floor(out, "leanvec_recall_at_10", LEANVEC_FLOOR)
    del lv
    torch.cuda.empty_cache()
    out["svs_leg_s"] = time.perf_counter() - t0

    # CAGRA and the cuVS IVF names
    t0 = time.perf_counter()
    cg, out["cagra_build_s"] = _graph_build(kt, "GPU_CUVS_CAGRA", xs, CAGRA_BUILD)
    out["cagra_M_efConstruction"] = [cg.node._M, cg.node._efc]
    out["cagra_recall_at_10"] = recall_at(_search(cg, kt, qs, CAGRA_SEARCH)[0], gt_s)
    _floor(out, "cagra_recall_at_10", CAGRA_FLOOR)
    del cg
    cuvs_launches = {}
    for name, kernel in (("GPU_CUVS_IVF_FLAT", ivf_cuda.int8_scan_tasks), ("GPU_CUVS_IVF_PQ", adc_cuda.adc_scan_tasks)):
        ivf, out[f"{name}_build_s"] = _graph_build(kt, name, xs, CUVS_IVF_BUILD)
        before = kernel.launches
        ids, _ = _search(ivf, kt, qs, CUVS_IVF_SEARCH)
        cuvs_launches[name] = kernel.launches - before
        out[f"{name}_recall_at_10"] = recall_at(ids, gt_s)
        _floor(out, f"{name}_recall_at_10", CUVS_IVF_FLOOR[name])
        if name == "GPU_CUVS_IVF_FLAT":
            meta = json.loads(ivf.GetIndexMeta({}).value().get("json_info"))
            icfg = ivf.node.CreateConfig()
            kt.Config.load(icfg, CUVS_IVF_SEARCH, kt.Stage.SEARCH)
            traces = json.loads(ivf.node.GetFederVisit(kt.GenDataSetFromArray(qs[:3]), icfg).value().get("json_id_set"))
            if sum(meta["list_sizes"]) != GRAPH_NB or any(len(t) != CUVS_IVF_SEARCH["nprobe"] for t in traces):
                raise AssertionError("feder on GPU_CUVS_IVF_FLAT: list sizes or traces wrong")
            out["feder_ivf_nlist"] = meta["nlist"]
        del ivf
        torch.cuda.empty_cache()
    out["cuvs_kernel_launches"] = cuvs_launches
    if not all(cuvs_launches.values()):
        raise AssertionError(f"a cuVS IVF search launched no kernel: {cuvs_launches}")
    out["cuvs_leg_s"] = time.perf_counter() - t0

    # KMEANS: Train twice (bit-equal), Assign against FLAT's nearest centroid
    t0 = time.perf_counter()
    cents = []
    for _ in range(2):
        cl = kt.ClusterFactory.Instance().Create("KMEANS").value()
        res, secs = _timed(lambda: cl.Train(kt.GenDataSetFromArray(xb), {"num_clusters": KMEANS_K}))
        cents.append(np.asarray(res.value().tensor).reshape(KMEANS_K, -1))
        out.setdefault("kmeans_train_s", []).append(secs)
    out["kmeans_bit_equal"] = bool(np.array_equal(cents[0].view(np.uint32), cents[1].view(np.uint32)))
    if not out["kmeans_bit_equal"]:
        raise AssertionError("KMEANS Train on the same rows gave other centroids")
    (assign, out["kmeans_assign_s"]) = _timed(lambda: np.asarray(cl.Assign(kt.GenDataSetFromArray(xs)).value().ids))
    cflat, _ = _flat_truth(kt, cents[1], qs[:1])
    nearest, nd = _search(cflat, kt, xs, {"metric_type": "L2", "k": 2})
    agree = assign == nearest[:, 0]
    near_tie = np.abs(nd[:, 1] - nd[:, 0]) <= 1e-3 * np.maximum(np.abs(nd[:, 0]), 1.0)
    out["kmeans_assign_agree"] = float(agree.mean())
    if not (agree | near_tie).all():
        raise AssertionError(f"KMEANS Assign differs from FLAT's nearest centroid off near-ties: {agree.mean()}")
    del cflat
    torch.cuda.empty_cache()
    out["kmeans_leg_s"] = time.perf_counter() - t0
    out["graph_peak_device_gb"] = _peak_gb()
    out["path_s"] = time.perf_counter() - t_path
    if out.get("below_floor"):
        raise AssertionError(f"graph families path: recall under its floor: {json.dumps(out)}")
    return out


def _write_diskann_bin(path: str, x: np.ndarray) -> int:
    """DiskANN's bin format ([npts int32][dim int32][rows]); returns bytes."""
    with open(path, "wb") as f:
        np.asarray(x.shape, dtype=np.int32).tofile(f)
        np.ascontiguousarray(x, dtype=np.float32).tofile(f)
    return os.path.getsize(path)


def _diskann_build(kt, name, data_path, prefix, n, extra=None):
    """Build ``name`` off data_path into prefix at DISKANN_BUILD (32 PQ bytes
    a row); (the index, build seconds, f32-scan launches in the build)."""
    from knowhere_tpu_torch.ops import ivf_cuda

    f32 = ivf_cuda.f32_scan_tasks
    before = f32.launches
    idx = kt.IndexFactory.Instance().Create(name).value()
    cfg = dict(DISKANN_BUILD, index_prefix=prefix, data_path=data_path, pq_code_budget_gb=32 * n / 1e9, **(extra or {}))
    st, secs = _timed(lambda: idx.Build(kt.DataSet(), cfg))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Build: {st.name}")
    return idx, secs, f32.launches - before


def _diskann_load(kt, name, prefix, extra=None):
    idx = kt.IndexFactory.Instance().Create(name).value()
    st, secs = _timed(lambda: idx.Deserialize(kt.BinarySet(), {"metric_type": "L2", "index_prefix": prefix,
                                                                **(extra or {})}))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Deserialize: {st.name}")
    return idx, secs


def _small_ladder(kt, idx, q, gt) -> dict:
    """recall@10 and QPS of one search a rung of SMALL_LADDER."""
    rungs = {}
    for L in SMALL_LADDER:
        (ids, _), secs = _timed(lambda: _search(idx, kt, q, {"metric_type": "L2", "k": 10, "search_list_size": L}))
        rungs[L] = {"recall_at_10": recall_at(ids, gt), "qps": len(q) / secs}
    return rungs


def diskann_path(kt, xb, xq, gt):
    """DISKANN (whose node DISKANN_DEPRECATED shares) and AISAQ through the
    public API (the module docstring, step 11): (1) DISKANN at 1M x 128, its
    build's first f32-scan launch held against f32_scan_plain; three loads
    (no node cache, whose warm-up search holds every graph_fresh launch bit
    for bit against fresh_step_plain; a BFS cache of a tenth of the rows;
    every row cached), each
    searched over the search_list_size ladder (recall@10 against the FLAT
    truth, QPS), the BFS cache's ids equal to no cache's; a 50% bitset, a
    0.96 bitset (the exact disk scan), RangeSearch, AnnIterator,
    GetVectorByIds, GetIndexMeta and a profiled no-cache search; (2) the
    sharded build at SHARD_NB rows; (3) AISAQ at AISAQ_NB rows with its
    inline records. The files live in a temporary directory that is removed
    at the end."""
    import shutil
    import tempfile

    import torch

    n, d = xb.shape
    nq, k = len(xq), 10
    out = {"nb": n, "nq": nq, "floors": {"recall_at_10": DISKANN_FLOOR, "bitset_50_recall_at_10": DISKANN_BITSET_FLOOR,
                                         "sharded_recall_at_10": SHARD_FLOOR, "aisaq_recall_at_10": AISAQ_FLOOR}}
    t_path = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_diskann_")
    try:
        # --- 1. DISKANN at 1M x 128 -------------------------------------------
        data_path = os.path.join(tmp, "base.bin")
        out["data_file_bytes"] = _write_diskann_bin(data_path, xb)
        prefix = os.path.join(tmp, "diskann")
        (_, out["build_s"], out["build_f32_scan_launches"]), held = _hold_launches(
            lambda: _diskann_build(kt, "DISKANN", data_path, prefix, n), ("ivf_f32_scan",),
            limit=1, tol=(F32_RTOL, F32_ATOL, F32_POS_AGREE))
        out["build_f32_held"] = _held_summary(held)["ivf_f32_scan"]
        out["file_bytes"] = {sfx: os.path.getsize(prefix + sfx) for sfx in ("_kwtpu_mem.bin", "_kwtpu_disk.bin")}
        print("diskann build:", json.dumps({key: out[key] for key in (
            "build_s", "build_f32_scan_launches", "data_file_bytes", "file_bytes")}), flush=True)

        row_gb = d * 4 / 1e9
        loads = {
            "no_cache": {},
            "bfs_cache": {"search_cache_budget_gb": row_gb * int(DISKANN_CACHE_SHARE * n), "use_bfs_cache": True},
            "full_cache": {"search_cache_budget_gb": row_gb * n * 1.01},
        }
        ladder_ids = {}
        for tag, extra in loads.items():
            idx, out[f"{tag}_load_s"] = _diskann_load(kt, "DISKANN", prefix, extra)
            node = idx.node
            if tag == "bfs_cache":
                out["bfs_cache_rows"] = int(node._cache_rows.shape[0])
            if (node._refine_store is not None) != (tag == "full_cache"):
                raise AssertionError(f"diskann {tag}: the node cache is not what the budget asks for")
            if tag == "no_cache":  # the process's first walk: warm-up, its launches held
                _, out["warmup_fresh_held"] = _hold_fresh(lambda: _search(
                    idx, kt, xq, {"metric_type": "L2", "k": k, "search_list_size": DISKANN_L}))
            rungs = {}
            for L in DISKANN_LADDER:
                (ids, dists), secs = _timed(lambda: _search(idx, kt, xq, {"metric_type": "L2", "k": k,
                                                                            "search_list_size": L}))
                if not np.isfinite(dists[ids >= 0]).all() or (ids < 0).any():
                    raise AssertionError(f"diskann {tag} L={L}: an empty slot or a distance not finite")
                rungs[L] = {"recall_at_10": recall_at(ids, gt), "qps": nq / secs, "ms": secs * 1e3}
                ladder_ids[(tag, L)] = ids
            out[f"{tag}_ladder"] = rungs
            print(f"diskann {tag}:", json.dumps(rungs), flush=True)
            if tag == "no_cache":
                nc_idx = idx
            else:
                del idx, node
                torch.cuda.empty_cache()
        out["bfs_cache_ids_equal_no_cache"] = all(
            np.array_equal(ladder_ids[("bfs_cache", L)], ladder_ids[("no_cache", L)]) for L in DISKANN_LADDER)
        if not out["bfs_cache_ids_equal_no_cache"]:
            raise AssertionError("diskann: the BFS node cache changed the result ids")
        out["full_cache_id_agreement"] = {
            L: float((ladder_ids[("full_cache", L)] == ladder_ids[("no_cache", L)]).mean()) for L in DISKANN_LADDER}
        out["recall_at_10"] = out["no_cache_ladder"][DISKANN_L]["recall_at_10"]
        _floor(out, "recall_at_10", DISKANN_FLOOR)

        # filtered: 50% (the walk under a mask) and 0.96 (the exact disk scan)
        scfg = {"metric_type": "L2", "k": k, "search_list_size": DISKANN_L}
        flat = kt.IndexFactory.Instance().Create("FLAT").value()
        if flat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}) != kt.Status.success:
            raise RuntimeError("FLAT Build failed")
        node = nc_idx.node
        for tag, ratio, q in (("bitset_50", 0.5, xq), ("bitset_96", 0.96, xq[:DISKANN_SMALL_NQ])):
            drop = np.random.default_rng(12).random(n) < ratio
            bs = kt.BitsetView.from_bool_array(drop)
            fgt, _ = _search(flat, kt, q, {"metric_type": "L2", "k": k}, bs)
            calls = []
            real = node._brute_force_disk
            node._brute_force_disk = lambda *a, **kw: calls.append(1) or real(*a, **kw)
            try:
                (fids, _), secs = _timed(lambda: _search(nc_idx, kt, q, scfg, bs))
            finally:
                del node._brute_force_disk
            if drop[fids[fids >= 0]].any() or (fids < 0).any():
                raise AssertionError(f"diskann {tag}: a filtered or empty id")
            out[f"{tag}_recall_at_10"] = recall_at(fids, fgt)
            out[f"{tag}_ms"] = secs * 1e3
            out[f"{tag}_exact_disk_scan_calls"] = len(calls)
        if out["bitset_96_exact_disk_scan_calls"] != 1 or out["bitset_96_recall_at_10"] < 0.99:
            raise AssertionError("diskann: the 0.96 bitset did not take the exact disk scan, or missed it")
        _floor(out, "bitset_50_recall_at_10", DISKANN_BITSET_FLOOR)

        # RangeSearch at the median 10th-NN distance, against the exact sets
        rq = xq[:100]
        dq = torch.cdist(torch.from_numpy(rq).cuda(), torch.from_numpy(xb).cuda()).pow(2).cpu().numpy()
        radius = float(np.median(np.sort(dq, 1)[:, 9]))
        res, out["range_ms"] = _timed(lambda: nc_idx.RangeSearch(
            kt.GenDataSetFromArray(rq), {"metric_type": "L2", "radius": radius}, kt.BitsetView()))
        out["range_ms"] *= 1e3
        if not res.has_value():
            raise RuntimeError(f"diskann RangeSearch: {res.what()}")
        r = res.value()
        if not (r.distance < radius).all():
            raise AssertionError("diskann RangeSearch returned a distance outside the radius")
        want = [set(np.nonzero(dq[i] < radius)[0].tolist()) for i in range(len(rq))]
        hits = sum(len(set(r.ids[r.lims[i]:r.lims[i + 1]].tolist()) & want[i]) for i in range(len(rq)))
        out["range_recall"] = hits / max(sum(len(w) for w in want), 1)
        out["range_rows"] = int(r.lims[-1])

        # AnnIterator: 100 queries x 100 items, distances non-decreasing
        items, secs = _timed(lambda: [[it.Next() for _ in range(100)] for it in nc_idx.AnnIterator(
            kt.GenDataSetFromArray(rq), {"metric_type": "L2"}, kt.BitsetView()).value()])
        out["iterator_ms"] = secs * 1e3
        dist_seq = np.array([[v for _, v in row] for row in items])
        if (np.diff(dist_seq, axis=1) < -1e-3).any():
            raise AssertionError("diskann AnnIterator: distances go down")
        out["iterator_recall_at_10"] = recall_at(np.array([[i for i, _ in row[:10]] for row in items]), gt[:100])

        sel = np.random.default_rng(4).choice(n, 1000, replace=False)
        got = np.asarray(nc_idx.GetVectorByIds(kt.GenIdsDataSet(sel)).value().tensor)
        out["get_vector_bit_equal"] = bool(np.array_equal(got, xb[sel]))
        meta = json.loads(nc_idx.GetIndexMeta({"metric_type": "L2"}).value().get("json_info"))
        out["meta"] = {key: meta[key] for key in ("count", "max_degree", "avg_degree")}
        if not out["get_vector_bit_equal"] or meta["count"] != n or meta["max_degree"] != DISKANN_BUILD["max_degree"]:
            raise AssertionError("diskann GetVectorByIds or GetIndexMeta disagree with the corpus")

        # one profiled no-cache search: the walk, the rerank's host time, idle
        rerank_s = []
        real = node._rerank_from_disk

        def timed_rerank(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(*a, **kw)
            rerank_s.append(time.perf_counter() - t0)
            return res

        node._rerank_from_disk = timed_rerank
        try:
            prof = _profile_search(lambda: _search(nc_idx, kt, xq, scfg))
        finally:
            del node._rerank_from_disk
        prof["rerank_ms"] = rerank_s[0] * 1e3
        prof.pop("top_ops")
        out["profile"] = prof
        del nc_idx, node, flat
        torch.cuda.empty_cache()
        out["leg1_s"] = time.perf_counter() - t_path

        # --- 2. the sharded build ----------------------------------------------
        t0 = time.perf_counter()
        xs, qs = xb[:SHARD_NB], xq[:DISKANN_SMALL_NQ]
        sflat, sgt = _flat_truth(kt, xs, qs)
        del sflat
        s_path = os.path.join(tmp, "shard.bin")
        _write_diskann_bin(s_path, xs)
        sprefix = os.path.join(tmp, "sharded")
        sidx, out["sharded_build_s"], out["sharded_f32_scan_launches"] = _diskann_build(
            kt, "DISKANN", s_path, sprefix, SHARD_NB, {"build_dram_budget_gb": SHARD_BUDGET_GB})
        stats = dict(sidx.node._build_stats)
        if sidx.Deserialize(kt.BinarySet(), {"metric_type": "L2", "index_prefix": sprefix}) != kt.Status.success:
            raise RuntimeError("DISKANN (sharded) Deserialize failed")
        out["sharded_build_stats"] = stats
        if not stats["sharded"] or out["sharded_f32_scan_launches"] < stats["n_shards"]:
            raise AssertionError(f"diskann sharded build: {stats}, {out['sharded_f32_scan_launches']} f32 launches")
        out["sharded_ladder"] = _small_ladder(kt, sidx, qs, sgt)
        out["sharded_recall_at_10"] = out["sharded_ladder"][DISKANN_L]["recall_at_10"]
        _floor(out, "sharded_recall_at_10", SHARD_FLOOR)
        del sidx
        out["leg2_s"] = time.perf_counter() - t0

        # --- 3. AISAQ and its inline records -----------------------------------
        t0 = time.perf_counter()
        xa = xb[:AISAQ_NB]
        aflat, agt = _flat_truth(kt, xa, qs)
        del aflat
        a_path = os.path.join(tmp, "aisaq.bin")
        _write_diskann_bin(a_path, xa)
        aprefix = os.path.join(tmp, "aisaq")
        _, out["aisaq_build_s"], _ = _diskann_build(kt, "AISAQ", a_path, aprefix, AISAQ_NB, {"inline_pq": True})
        aidx, _ = _diskann_load(kt, "AISAQ", aprefix)
        deg, m = aidx.node._inline_geom
        out["aisaq_inline_bytes"] = int(aidx.node._inline_nodes.nbytes)
        out["aisaq_inline_file_bytes"] = os.path.getsize(aprefix + "_aisaq_inline.bin")
        out["aisaq_record_bytes_expected"] = AISAQ_NB * (4 * deg + m + deg * m)
        if out["aisaq_inline_bytes"] != out["aisaq_record_bytes_expected"] or "codes" in aidx.node._store:
            raise AssertionError("AISAQ: inline records of the wrong size, or PQ codes left on the device")
        out["aisaq_ladder"] = _small_ladder(kt, aidx, qs, agt)
        out["aisaq_recall_at_10"] = out["aisaq_ladder"][DISKANN_L]["recall_at_10"]
        _floor(out, "aisaq_recall_at_10", AISAQ_FLOOR)
        del aidx
        out["leg3_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["tmp_removed"] = not os.path.exists(tmp)
    out["path_s"] = time.perf_counter() - t_path
    if out.get("below_floor"):
        raise AssertionError(f"diskann path: recall under its floor: {json.dumps(out)}")
    return out


def _sparse_search(idx, kt, rows, cfg, bitset=None):
    res = idx.Search(kt.GenSparseDataSet(rows, SPARSE_VOCAB), cfg, bitset or kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"sparse Search failed: {res.error().name}: {res.what()}")
    return res.value().ids.reshape(len(rows), cfg["k"]), res.value().distance.reshape(len(rows), cfg["k"])


def _tie_check(ids_a, d_a, ids_b, d_b, rtol=SPARSE_TIE_RTOL) -> dict:
    """Two exact answers side by side: the share of equal ids, the largest
    relative score difference slot by slot, and the slots whose ids differ
    where the first answer's score has no tie within rtol (a neighbour in
    its row, or the row's last filled slot, whose tie may lie past k)."""
    diff = ids_a != ids_b
    scale = np.maximum(np.abs(d_a), 1e-30)
    gap = np.abs(np.diff(d_a, axis=1))
    near = np.zeros_like(diff)
    near[:, 1:] |= gap <= rtol * scale[:, 1:]
    near[:, :-1] |= gap <= rtol * scale[:, :-1]
    last = (ids_a >= 0).sum(axis=1) - 1
    rows = np.nonzero(last >= 0)[0]
    near[rows, last[rows]] = True
    return {"ids_equal": float((~diff).mean()), "max_rel_score_diff": float((np.abs(d_b - d_a) / scale).max()),
            "untied_mismatches": int((diff & ~near).sum())}


def _tie_ok(check: dict) -> bool:
    return check["untied_mismatches"] == 0 and check["max_rel_score_diff"] <= SPARSE_TIE_RTOL


def _mb(t) -> float:
    return t.numel() * t.element_size() / 1e6


def _sparse_cc_leg(kt, xb, xq, ids0, d0) -> dict:
    """SPARSE_INVERTED_INDEX_CC built on SPARSE_CC_N0 rows; the rest added
    in SPARSE_CC_BATCHES batches while a reader searches SPARSE_CC_NQ
    queries in a loop; every read full, every acknowledged row read back by
    GetVectorByIds, and the final answer equal to the one-shot index's (the
    exact drop-0 answer, ids0 / d0) but ties."""
    import threading

    out = {}
    t0 = time.perf_counter()
    cc = kt.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX_CC", data_type="sparse").value()
    if cc.Build(kt.GenSparseDataSet(xb[:SPARSE_CC_N0], SPARSE_VOCAB), {"metric_type": "IP"}) != kt.Status.success:
        raise RuntimeError("sparse cc: Build failed")
    out["build_s"] = time.perf_counter() - t0
    qs, cfg = xq[:SPARSE_CC_NQ], {"metric_type": "IP", "k": SPARSE_K}
    stop, errors, reads = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            t = time.perf_counter()
            res = cc.Search(kt.GenSparseDataSet(qs, SPARSE_VOCAB), cfg, kt.BitsetView())
            if not res.has_value():
                errors.append(res.what())
                return
            if (res.value().ids < 0).any():
                errors.append("a reader's result has an empty slot")
                return
            reads.append((time.perf_counter() - t) * 1e3)

    th = threading.Thread(target=reader)
    th.start()
    rest = xb[SPARSE_CC_N0:]
    step = -(-len(rest) // SPARSE_CC_BATCHES)
    add_ms = []
    try:
        for s0 in range(0, len(rest), step):
            seen, t = len(reads), time.perf_counter()
            if cc.Add(kt.GenSparseDataSet(rest[s0 : s0 + step], SPARSE_VOCAB), {"metric_type": "IP"}) != kt.Status.success:
                raise RuntimeError("sparse cc: Add failed")
            add_ms.append((time.perf_counter() - t) * 1e3)
            while len(reads) == seen and th.is_alive():  # a read of each epoch before the next Add
                time.sleep(0.005)
    finally:
        stop.set()
        th.join(timeout=600)
    if th.is_alive():
        raise AssertionError("sparse cc: the reader did not stop")
    out.update(reads=len(reads), reader_ms_median=float(np.median(reads)) if reads else None,
               add_ms=add_ms, reader_errors=errors, count=cc.Count())
    got = cc.GetVectorByIds(kt.GenIdsDataSet(np.arange(SPARSE_CC_N0, len(xb)))).value().tensor
    out["acknowledged_rows"] = len(rest)
    out["read_back_equal"] = got == list(rest)
    ids, d = _sparse_search(cc, kt, qs, dict(cfg, drop_ratio_search=0.0))
    out["final_vs_one_shot"] = _tie_check(ids0[:SPARSE_CC_NQ], d0[:SPARSE_CC_NQ], ids, d)
    out["leg_s"] = time.perf_counter() - t0
    return out


def sparse_path(kt):
    """The sparse family through the public API at bench.py's sparse leg
    (the module docstring, step 11): for IP and then BM25, the truth from
    BruteForce.SearchSparse, SPARSE_INVERTED_INDEX built and searched over
    the drop ladder (the engine each rung took, the probe's seconds), warm
    QPS at the chosen rung (repeats bit-equal), the structures' device MB,
    the host rescore's ms, and the exact drop-0 answer; for IP also a 50%
    bitset, a Serialize / Deserialize round trip (the same ids, the engine
    choices kept), TAAT_NAIVE (the padded engine) and the windowed pruner
    (sindi_window_size 32768, 256 queries) against the drop-0 answer, the
    raw hybrid engine twice on 512 queries (bit-equal), the packed tail ids
    decoded on the device against the host decode, and the cc leg. Raises after the last leg if any check failed."""
    import torch

    from knowhere_tpu_torch import native
    from knowhere_tpu_torch.ops import bitpack, sparse_ops

    t_path = time.perf_counter()
    k = SPARSE_K
    # numpy's generators differ across its versions: the corpus is the
    # reference's only under the same numpy
    out = {"nb": SPARSE_NB, "nq": SPARSE_NQ, "vocab": SPARSE_VOCAB, "numpy": np.__version__,
           "native_available": native.available(),
           "floors": {"ip_recall_at_10": SPARSE_IP_FLOOR, "bm25_recall_at_10_drop0": SPARSE_BM25_FLOOR}}
    failed = [] if out["native_available"] else ["native library not built"]
    t0 = time.perf_counter()
    xb, xq = gen_sparse_corpus(SPARSE_NB, SPARSE_NQ, SPARSE_VOCAB)
    out["gen_s"] = time.perf_counter() - t0
    base, queries = kt.GenSparseDataSet(xb, SPARSE_VOCAB), kt.GenSparseDataSet(xq, SPARSE_VOCAB)
    for metric, mcfg in (("IP", {}), ("BM25", SPARSE_BM25)):
        m = out[metric] = {}
        t0 = time.perf_counter()
        bf = kt.BruteForce.SearchSparse(base, queries, {"metric_type": metric, "k": k, **mcfg})
        if not bf.has_value():
            raise RuntimeError(f"sparse BruteForce failed: {bf.what()}")
        gt = bf.value().ids.reshape(SPARSE_NQ, k)
        m["truth_s"] = time.perf_counter() - t0
        idx = kt.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX", data_type="sparse").value()
        st, m["build_s"] = _timed(lambda: idx.Build(base, {"metric_type": metric, **mcfg}))
        if st != kt.Status.success:
            raise RuntimeError(f"sparse {metric}: Build failed: {st}")
        node = idx.node

        def cfg_at(drop, **extra):
            return {"metric_type": metric, "k": k, "drop_ratio_search": drop, **mcfg,
                    **({"refine_factor": 4} if drop > 0 else {}), **extra}

        ladder, chosen = {}, None
        for drop in SPARSE_DROPS:
            node._last_probe = {}
            (ids, _), secs = _timed(lambda: _sparse_search(idx, kt, xq, cfg_at(drop)))
            ladder[str(drop)] = {"recall_at_10": recall_at(ids, gt), "s": secs,
                                 "engine": node._last_search_stats["engine"], "probe": dict(node._last_probe)}
            chosen = drop
            if ladder[str(drop)]["recall_at_10"] >= SPARSE_TARGET:
                break
        m["ladder"], m["chosen_drop"] = ladder, chosen
        runs = [_timed(lambda: _sparse_search(idx, kt, xq, cfg_at(chosen))) for _ in range(4)]  # a warm-up, 3 timed
        (ids_c, d_c), times = runs[0][0], [dt for _, dt in runs[1:]]
        m["warm_ms"] = [t * 1e3 for t in times]
        m["qps"] = SPARSE_NQ / float(np.median(times))
        m["recall_at_10"] = recall_at(ids_c, gt)
        m["repeats_bit_equal"] = all(np.array_equal(o[0], ids_c) and np.array_equal(o[1], d_c) for o, _ in runs)
        m["engine"] = node._last_search_stats["engine"]
        m["rescore_host_ms"] = node._last_search_stats.get("rescore_ms")
        h, tail_ids_dev = node._caches["hybrid"]
        slab_dev, tail_vals_dev = node._caches[("hvals", metric.lower())][-2:]
        m.update(nnz=h.total_nnz, F=h.F, head_share_of_nnz=h.head_nnz / h.total_nnz, tail_bits=h.tail_bits,
                 device_mb={"slab": _mb(slab_dev), "tail_ids_packed": _mb(tail_ids_dev), "tail_vals": _mb(tail_vals_dev)})
        if chosen == 0.0:
            ids0, d0 = ids_c, d_c
        else:
            (ids0, d0), m["drop0_s"] = _timed(lambda: _sparse_search(idx, kt, xq, cfg_at(0.0)))
        m["recall_at_10_drop0"] = recall_at(ids0, gt)
        print(f"sparse {metric}:", json.dumps(m), flush=True)
        if not m["repeats_bit_equal"]:
            failed.append(f"{metric}: repeated searches differ")
        if metric == "IP" and m["recall_at_10"] < SPARSE_IP_FLOOR:
            failed.append(f"IP recall {m['recall_at_10']} under {SPARSE_IP_FLOOR}")
        if metric == "BM25" and m["recall_at_10_drop0"] < SPARSE_BM25_FLOOR:
            failed.append(f"BM25 drop-0 recall {m['recall_at_10_drop0']} under {SPARSE_BM25_FLOOR}")
        if metric == "BM25":
            del idx, node, h, tail_ids_dev, slab_dev, tail_vals_dev
            torch.cuda.empty_cache()
            continue

        # --- IP only: bitset, round trip, padded, pruned, bitpack, cc -------
        legs = out["legs"] = {}
        filtered = np.arange(SPARSE_NB) % 2 == 0
        (ids_b, _), secs = _timed(lambda: _sparse_search(idx, kt, xq, cfg_at(chosen), kt.BitsetView.from_bool_array(filtered)))
        legs["bitset_50"] = {"s": secs, "filtered_ids_returned": int(filtered[ids_b[ids_b >= 0]].sum()),
                             "empty_slots": int((ids_b < 0).sum())}
        if legs["bitset_50"]["filtered_ids_returned"]:
            failed.append("bitset: a filtered id came back")

        t0 = time.perf_counter()
        bs = kt.BinarySet()
        if idx.Serialize(bs) != kt.Status.success:
            raise RuntimeError("sparse: Serialize failed")
        idx2 = kt.IndexFactory.Instance().Create("SPARSE_INVERTED_INDEX", data_type="sparse").value()
        if idx2.Deserialize(bs) != kt.Status.success:
            raise RuntimeError("sparse: Deserialize failed")
        load_s = time.perf_counter() - t0
        choices = {key: v for key, v in node._caches.items() if key[0] == "engine_choice"}
        choices2 = {key: v for key, v in idx2.node._caches.items() if key[0] == "engine_choice"}
        ids_r, _ = _sparse_search(idx2, kt, xq, cfg_at(chosen))
        legs["round_trip"] = {"s": load_s, "bytes": len(bs.GetByName("SPARSE_INVERTED_INDEX").tobytes()),
                              "ids_equal": bool(np.array_equal(ids_r, ids_c)), "engine_choices": {str(key): v for key, v in choices.items()},
                              "engine_choices_kept": choices2 == choices, "engine_after_load": idx2.node._last_search_stats["engine"],
                              "probed_after_load": bool(idx2.node._last_probe)}
        if not (legs["round_trip"]["ids_equal"] and legs["round_trip"]["engine_choices_kept"]) or legs["round_trip"]["probed_after_load"]:
            failed.append("round trip: ids or the engine choice changed")
        del idx2, bs

        (ids_p, d_p), secs = _timed(lambda: _sparse_search(idx, kt, xq, cfg_at(0.0, search_algo="TAAT_NAIVE")))
        legs["taat_naive"] = {"s": secs, "qps": SPARSE_NQ / secs, "engine": node._last_search_stats["engine"],
                              "vs_hybrid_drop0": _tie_check(ids0, d0, ids_p, d_p)}
        if not _tie_ok(legs["taat_naive"]["vs_hybrid_drop0"]) or legs["taat_naive"]["engine"] != "padded_exhaustive":
            failed.append("TAAT_NAIVE: ids differ from the hybrid engine's at drop 0")

        q256 = xq[:SPARSE_PRUNED_NQ]
        pruned = {}
        for tag, cfg_p in (("exact_drop0", cfg_at(0.0, sindi_window_size=SPARSE_WINDOW)),
                           ("bench_row", cfg_at(chosen, sindi_window_size=SPARSE_WINDOW))):
            _sparse_search(idx, kt, q256, cfg_p)  # warm: the window maxima
            (ids_w, d_w), secs = _timed(lambda: _sparse_search(idx, kt, q256, cfg_p))
            pruned[tag] = {"s": secs, "qps": SPARSE_PRUNED_NQ / secs, "stats": dict(node._last_search_stats)}
            if tag == "exact_drop0":
                pruned[tag]["vs_exact"] = _tie_check(ids0[:SPARSE_PRUNED_NQ], d0[:SPARSE_PRUNED_NQ], ids_w, d_w)
                if not _tie_ok(pruned[tag]["vs_exact"]) or pruned[tag]["stats"]["engine"] != "pruned":
                    failed.append("pruned: ids differ from the exact answer at dim_max_score_ratio 1.05")
            else:
                pruned[tag]["recall_at_10"] = recall_at(ids_w, gt[:SPARSE_PRUNED_NQ])
        legs["pruned_w32768"] = pruned

        # the raw engine twice, without the host rescore: the device scatter
        # (index_put_ with accumulate, sort-based on CUDA) repeats its bits
        q512 = xq[:512]
        raw = [sparse_ops.sparse_search_hybrid(h, slab_dev, tail_vals_dev, tail_ids_dev, q512, 2 * k,
                                               tail_bits=h.tail_bits) for _ in range(2)]
        legs["raw_engine_repeat_bit_equal"] = bool(np.array_equal(raw[0][0], raw[1][0]) and np.array_equal(raw[0][1], raw[1][1]))
        if not legs["raw_engine_repeat_bit_equal"]:
            failed.append("the hybrid engine's scores differ between two runs")

        n_tail = len(h.tail.doc_ids)
        dec, ms = _timed(lambda: bitpack.unpack_gather(tail_ids_dev, torch.arange(n_tail, device=tail_ids_dev.device), h.tail_bits).cpu().numpy())
        host = bitpack.unpack_all(tail_ids_dev.cpu().numpy().view(np.uint32), n_tail, h.tail_bits)
        legs["bitpack"] = {"entries": n_tail, "bits": h.tail_bits, "device_decode_s": ms,
                           "equal_to_unpack_all": bool(np.array_equal(dec, host.astype(np.int64))),
                           "equal_to_doc_ids": bool(np.array_equal(host, h.tail.doc_ids.astype(np.uint32)))}
        if not (legs["bitpack"]["equal_to_unpack_all"] and legs["bitpack"]["equal_to_doc_ids"]):
            failed.append("bitpack: the device decode differs")
        del idx, node, h, tail_ids_dev, slab_dev, tail_vals_dev
        torch.cuda.empty_cache()
        legs["cc"] = _sparse_cc_leg(kt, xb, xq, ids0, d0)
        cc = legs["cc"]
        if cc["reader_errors"] or not cc["read_back_equal"] or cc["count"] != SPARSE_NB or not cc["reads"] \
                or not _tie_ok(cc["final_vs_one_shot"]):
            failed.append("cc: a read failed or an acknowledged row did not come back")
        print("sparse IP legs:", json.dumps(legs), flush=True)
    out["path_s"] = time.perf_counter() - t_path
    if failed:
        raise AssertionError(f"sparse path: {failed}: {json.dumps(out)}")
    return out


# --- the api and emb_list path: SCANN_DVR, MINHASH_LSH, FAISS, compat, emb_list ---------

EMB_DOCS = 20_000  # ColBERT-style corpus: documents of 32-128 tokens
EMB_TOK = (32, 128)
EMB_DIM = 128  # ColBERTv2's token width
EMB_NQ = 1_000
EMB_QTOK = 32  # ColBERT's query length
EMB_CONCEPTS = 8192  # token-level concepts (a ColBERT centroid's worth each)
EMB_TOPICS = 200  # a document's tokens come from its topic's concepts
EMB_TOPIC_CONCEPTS = 48
EMB_NOISE = 0.35  # token = concept + EMB_NOISE * N(0, I)
EMB_DTW_NQ = 256
EMB_K = 10
EMB_HNSW = {"M": 16, "efConstruction": 200}
EMB_IVF = {"nlist": 1024}
EMB_MUVERA = {"emb_list_strategy": "muvera", "muvera_num_projections": 5, "muvera_num_repeats": 20}
MH_FAMILIES = 200_000  # 1,000,000 signatures in families of 5 near-duplicates
MH_FAMILY = 5
MH_ELEMS = 128  # 32-bit MinHash values: 4,096 bits a signature
MH_NQ = 1_000
MH_AGREE = (0.6, 0.95)  # element agreement of a near-duplicate with its source
MH_PLANTED = 0.8  # planted duplicates at or above this agreement must rank first
DVR_NQ = 1_000
DVR_SMALL = 100_000  # the quantized refine legs, FAISS and compat
DVR_SEARCH = {"metric_type": "L2", "k": 10, "nprobe": 12, "reorder_k": 256}  # SCANN_SEARCH's reorder
DVR_SMALL_SEARCH = dict(DVR_SEARCH, nprobe=32)  # nlist 256 at 100,000 rows: GIST_PQ_SEARCH's share of lists
# recall floors of the api and emb_list path, just under the first measured
# values (H100 80GB HBM3, 700 W, the path's first run): tokenann HNSW 0.9361, IVF_FLAT 0.9998,
# FLAT 0.9999, MUVERA 0.8646, LEMUR 0.3654; MinHash recall@1 1.0; SCANN_DVR
# over the view 0.9535
EMB_FLOORS = {"tokenann_hnsw": 0.93, "tokenann_ivf_flat": 0.99, "tokenann_flat": 0.99, "muvera_flat": 0.85,
              "lemur_flat": 0.3}
MH_RECALL1_FLOOR = 0.99
DVR_FLOOR = 0.95
FAISS_NPROBE = 16
FAISS_DESCS = (
    ("Flat", "FLAT", {}, {}),
    ("IVF256,Flat", "IVF_FLAT", {"nlist": 256}, {"nprobe": FAISS_NPROBE}),
    ("IVF256,PQ16", "IVF_PQ", {"nlist": 256, "m": 16}, {"nprobe": FAISS_NPROBE}),
    ("IVF256,SQ8", "IVF_SQ8", {"nlist": 256, "sq_type": "SQ8"}, {"nprobe": FAISS_NPROBE}),
    ("HNSW16", "HNSW", {"M": 16}, {"ef": 64}),
)
WRAP_THREADS = 4


def _dev_gb() -> float:
    """Device GB allocated, after the garbage of earlier legs is freed."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e9


def gen_emb_corpus(seed=11):
    """ColBERT-style late-interaction corpus on the device: EMB_CONCEPTS
    concept vectors, EMB_TOPICS topics of EMB_TOPIC_CONCEPTS concepts each;
    EMB_DOCS documents of EMB_TOK tokens (uniform), each on one topic, each
    token one of its topic's concepts plus noise; EMB_NQ queries of EMB_QTOK
    tokens, each drawn from the concepts of one document's tokens. Returns
    host (tokens, lims, q_tokens, q_lims, source documents)."""
    import torch

    from knowhere_tpu_torch.device import get_device

    dev = get_device()
    g = torch.Generator(device=dev).manual_seed(seed)

    def noisy(concept_ids):
        return concepts[concept_ids] + EMB_NOISE * torch.randn(concept_ids.numel(), EMB_DIM, generator=g, device=dev)

    concepts = torch.randn(EMB_CONCEPTS, EMB_DIM, generator=g, device=dev)
    topic_concepts = torch.randint(0, EMB_CONCEPTS, (EMB_TOPICS, EMB_TOPIC_CONCEPTS), generator=g, device=dev)
    lens = torch.randint(EMB_TOK[0], EMB_TOK[1] + 1, (EMB_DOCS,), generator=g, device=dev)
    topic = torch.randint(0, EMB_TOPICS, (EMB_DOCS,), generator=g, device=dev)
    doc = torch.repeat_interleave(torch.arange(EMB_DOCS, device=dev), lens)
    pick = torch.randint(0, EMB_TOPIC_CONCEPTS, (doc.numel(),), generator=g, device=dev)
    tok_concept = topic_concepts[topic[doc], pick]
    tokens = noisy(tok_concept)
    lims = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(lens, 0)])
    src = torch.randint(0, EMB_DOCS, (EMB_NQ,), generator=g, device=dev)
    # each query token: the concept of a random token of its source document
    offs = (torch.rand(EMB_NQ, EMB_QTOK, generator=g, device=dev) * lens[src][:, None]).long()
    q_tokens = noisy(tok_concept[(lims[src][:, None] + offs).reshape(-1)])
    q_lims = np.arange(0, (EMB_NQ + 1) * EMB_QTOK, EMB_QTOK, dtype=np.int64)
    return tokens.cpu().numpy(), lims.cpu().numpy(), q_tokens.cpu().numpy(), q_lims, src.cpu().numpy()


def maxsim_truth(tokens, lims, q_tokens, q_lims, k=EMB_K, q_block=32):
    """The exact MAX_SIM_COSINE top-k over every document, by the port's
    plain MaxSim on the device: a block of queries' normalized tokens against
    every normalized corpus token (one f32 product, TF32 off), each
    document's maximum by segment_reduce, summed over each query's tokens;
    ties to the lower document id."""
    import torch

    from knowhere_tpu_torch.device import to_device
    from knowhere_tpu_torch.ops.topk import topk_leftmost

    t = to_device(tokens)
    t = t / t.norm(dim=1, keepdim=True).clamp(min=1e-12)
    q = to_device(q_tokens)
    q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
    doc_lens = to_device(np.diff(lims))
    nq = len(q_lims) - 1
    out = np.empty((nq, k), np.int64)
    for s in range(0, nq, q_block):
        e = min(nq, s + q_block)
        sim_t = t @ q[q_lims[s] : q_lims[e]].T  # (tokens, block query tokens)
        best = torch.segment_reduce(sim_t, "max", lengths=doc_lens)  # (docs, block query tokens)
        seg = to_device(np.repeat(np.arange(e - s), np.diff(q_lims[s : e + 1])))
        score = torch.zeros(e - s, best.shape[0], device=t.device).index_add_(0, seg, best.T)
        out[s:e] = topk_leftmost(score, k)[1].cpu().numpy()
    del t, q
    torch.cuda.empty_cache()
    return out


def _emb_ds(kt, tokens, lims):
    return kt.DataSet(tensor=tokens, lims=lims, rows=tokens.shape[0], dim=tokens.shape[1])


def _emb_search(kt, idx, qds, cfg, bitset=None):
    res = idx.Search(qds, cfg, bitset or kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"emb_list Search failed: {res.error().name}: {res.what()}")
    k = cfg["k"]
    ids, d = res.value().ids.reshape(-1, k), res.value().distance.reshape(-1, k)
    if not np.isfinite(d[ids >= 0]).all():
        raise AssertionError("emb_list: non-finite score")
    return ids, d


def _emb_leg(kt, name, base, qds, gt, build, search):
    """Build ``name`` over the emb_list corpus, search all queries (warm QPS,
    the median of 3 after one untimed call), recall@10 against the truth,
    the device GB the index holds after its searches (the stage-2 tokens
    included). Returns (index, numbers, ids)."""
    gb0 = _dev_gb()
    idx = kt.IndexFactory.Instance().Create(name).value()
    st, build_s = _timed(lambda: idx.Build(base, build))
    if st != kt.Status.success:
        raise RuntimeError(f"emb_list {name} {build}: Build {st.name}")
    (ids, _), times, med = _warm(lambda: _emb_search(kt, idx, qds, search), reps=3)
    gb = _dev_gb() - gb0
    return idx, {"build_s": build_s, "recall_at_10": recall_at(ids, gt), "warm_ms": times,
                 "qps": (qds.lims.size - 1) / med * 1e3, "device_gb": gb}, ids


def emb_list_legs(kt):
    """The emb_list family at a ColBERT-style size (the module docstring):
    tokenann over HNSW (its kNN graph through the f32 scan, the first launch
    held), IVF_FLAT (FAST: the int8 scan, the first launch held) and FLAT,
    MUVERA and LEMUR over FLAT, DTW_COSINE on EMB_DTW_NQ queries, a 50%
    document bitset, a round trip and GetEmbListByIds."""
    import torch

    t0 = time.perf_counter()
    tokens, lims, q_tokens, q_lims, src = gen_emb_corpus()
    out = {"docs": EMB_DOCS, "tokens": int(lims[-1]), "dim": EMB_DIM, "queries": EMB_NQ, "query_tokens": EMB_QTOK,
           "gen_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    gt = maxsim_truth(tokens, lims, q_tokens, q_lims)
    out["truth_s"] = time.perf_counter() - t0
    out["truth_holds_source"] = float(np.mean(gt[:, 0] == src))
    base, qds = _emb_ds(kt, tokens, lims), _emb_ds(kt, q_tokens, q_lims)
    metric = {"metric_type": "MAX_SIM_COSINE"}
    search = dict(metric, k=EMB_K)
    held = {}
    (hnsw, leg, _), held_f32 = _hold_launches(
        lambda: _emb_leg(kt, "HNSW", base, qds, gt, dict(metric, **EMB_HNSW), search), ("ivf_f32_scan",), limit=1,
        tol=(F32_RTOL, F32_ATOL, F32_POS_AGREE))
    out["tokenann_hnsw"], held["ivf_f32_scan"] = leg, _held_summary(held_f32)["ivf_f32_scan"]
    del hnsw
    (ivf, leg, _), held_i8 = _hold_launches(
        lambda: _emb_leg(kt, "IVF_FLAT", base, qds, gt, dict(metric, **EMB_IVF), search), ("ivf_int8_scan",), limit=1)
    out["tokenann_ivf_flat"], held["ivf_int8_scan"] = leg, _held_summary(held_i8)["ivf_int8_scan"]
    del ivf
    flat, out["tokenann_flat"], ids_flat = _emb_leg(kt, "FLAT", base, qds, gt, metric, search)
    failed = []
    # a 50% document bitset, a round trip, GetEmbListByIds on the tokenann FLAT
    keep = np.zeros(EMB_DOCS, bool)
    keep[::2] = True
    (ids_b, _), secs = _timed(lambda: _emb_search(kt, flat, qds, search, kt.BitsetView.from_bool_array(~keep)))
    out["bitset_50"] = {"s": secs, "filtered_returned": int((~keep[ids_b[ids_b >= 0]]).sum())}
    if out["bitset_50"]["filtered_returned"]:
        failed.append("emb_list: a filtered document came back under the bitset")
    bs = kt.BinarySet()
    _, ser_s = _timed(lambda: flat.Serialize(bs))
    again = kt.IndexFactory.Instance().Create("FLAT").value()
    st, load_s = _timed(lambda: again.Deserialize(bs))
    same = st == kt.Status.success and np.array_equal(_emb_search(kt, again, qds, search)[0], ids_flat)
    out["round_trip"] = {"serialize_s": ser_s, "deserialize_s": load_s, "same_ids": bool(same)}
    if not same:
        failed.append("emb_list: the round trip changed the ids")
    del again, bs
    want = np.arange(0, EMB_DOCS, max(1, EMB_DOCS // 1000))
    got, secs = _timed(lambda: flat.GetEmbListByIds(kt.GenIdsDataSet(want)))
    ok = got.has_value() and np.array_equal(np.asarray(got.value().lims), np.concatenate(
        [[0], np.cumsum(np.diff(lims)[want])])) and np.array_equal(
        np.asarray(got.value().tensor), np.concatenate([tokens[lims[i] : lims[i + 1]] for i in want]))
    out["get_emb_list_by_ids"] = {"ids": int(want.size), "s": secs, "ok": bool(ok)}
    if not ok:
        failed.append("emb_list: GetEmbListByIds rows differ")
    del flat
    _, out["muvera_flat"], _ = _emb_leg(kt, "FLAT", base, qds, gt, dict(metric, **EMB_MUVERA), search)
    _, out["lemur_flat"], _ = _emb_leg(kt, "FLAT", base, qds, gt, dict(metric, emb_list_strategy="lemur"), search)
    # DTW_COSINE over tokenann FLAT on the first EMB_DTW_NQ queries (no
    # DTW truth: finite scores, a round of the same ids again)
    q_small = _emb_ds(kt, q_tokens[: q_lims[EMB_DTW_NQ]], q_lims[: EMB_DTW_NQ + 1])
    dtw = kt.IndexFactory.Instance().Create("FLAT").value()
    st, build_s = _timed(lambda: dtw.Build(base, {"metric_type": "DTW_COSINE"}))
    if st != kt.Status.success:
        raise RuntimeError(f"emb_list DTW_COSINE: Build {st.name}")
    dcfg = {"metric_type": "DTW_COSINE", "k": EMB_K}
    (ids_d, _), times, med = _warm(lambda: _emb_search(kt, dtw, q_small, dcfg), reps=3)
    out["dtw_flat"] = {"build_s": build_s, "warm_ms": times, "qps": EMB_DTW_NQ / med * 1e3,
                       "top1_is_source": float(np.mean(ids_d[:, 0] == src[:EMB_DTW_NQ])),
                       "repeat_same_ids": bool(np.array_equal(_emb_search(kt, dtw, q_small, dcfg)[0], ids_d))}
    if not out["dtw_flat"]["repeat_same_ids"]:
        failed.append("emb_list: DTW repeated search changed the ids")
    del dtw
    torch.cuda.empty_cache()
    for leg, floor in EMB_FLOORS.items():
        if out[leg]["recall_at_10"] < floor:
            failed.append(f"emb_list {leg}: recall {out[leg]['recall_at_10']} under {floor}")
    return out, held, failed


def gen_minhash_corpus(seed=13):
    """Near-duplicate signatures as an LLM-corpus dedup sees them, on the
    device: MH_FAMILIES random 128 x 32-bit MinHash signatures, each with
    MH_FAMILY members that keep an element of it with probability drawn from
    MH_AGREE (the rest fresh values); MH_NQ queries, each a fresh
    near-duplicate of a random row at an agreement drawn the same way.
    Returns host (rows uint8 (n, 512), queries, source rows, agreements)."""
    import torch

    from knowhere_tpu_torch.device import get_device

    dev = get_device()
    g = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = -(1 << 31), (1 << 31) - 1

    def fresh(n):
        return torch.randint(lo, hi, (n, MH_ELEMS), generator=g, device=dev, dtype=torch.int64).to(torch.int32)

    def near(src):
        agree = MH_AGREE[0] + (MH_AGREE[1] - MH_AGREE[0]) * torch.rand(src.shape[0], 1, generator=g, device=dev)
        kept = torch.rand(src.shape, generator=g, device=dev) < agree
        return torch.where(kept, src, fresh(src.shape[0])), agree[:, 0]

    base = fresh(MH_FAMILIES)
    rows, _ = near(base.repeat_interleave(MH_FAMILY, 0))
    src = torch.randint(0, rows.shape[0], (MH_NQ,), generator=g, device=dev)
    q, agree = near(rows[src])

    def host(x):
        return x.cpu().numpy().view(np.uint8).reshape(x.shape[0], -1)

    return host(rows), host(q), src.cpu().numpy(), agree.cpu().numpy()


def minhash_truth(rows, q, k=EMB_K, q_block=8):
    """Exact MHJACCARD by device brute force: every row's equal-element
    count against each query, a block of queries at a time. Returns the
    top-k counts and ids (ascending ids among ties)."""
    import torch

    from knowhere_tpu_torch.device import to_device
    from knowhere_tpu_torch.ops.topk import topk_leftmost

    r = to_device(rows).view(torch.int32)
    qq = to_device(q).view(torch.int32)
    top_c, top_i = [], []
    for s in range(0, qq.shape[0], q_block):
        c = (r[None, :, :] == qq[s : s + q_block, None, :]).sum(2).float()
        v, i = topk_leftmost(c, k)
        top_c.append(v)
        top_i.append(i)
    return torch.cat(top_c).cpu().numpy().astype(np.int64), torch.cat(top_i).cpu().numpy()


def _mh_recall(ids, sims, top_counts, k):
    """Tie-aware recall@k against the exact MHJACCARD: a returned row counts
    when its similarity reaches the k-th exact one; slots whose exact
    similarity is 0 (no element shared) are left out of both sides."""
    kth = top_counts[:, k - 1 : k] / MH_ELEMS
    pos = (top_counts[:, :k] > 0).sum(1)
    hit = ((ids[:, :k] >= 0) & (sims[:, :k] >= kth - 1e-7) & (sims[:, :k] > 0)).sum(1)
    return float(np.minimum(hit, pos).sum() / max(pos.sum(), 1))


def minhash_leg(kt):
    """MINHASH_LSH at a near-duplicate-detection size (the module docstring):
    per-band and shared Bloom filters, batch and one-by-one search (the same
    ids), recall@1 and @10 against the device brute force, every planted
    duplicate of agreement >= MH_PLANTED at rank 1, a round trip."""
    t0 = time.perf_counter()
    rows, q, src, agree = gen_minhash_corpus()
    out = {"rows": rows.shape[0], "elements": MH_ELEMS, "queries": MH_NQ, "gen_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    top_counts, top_ids = minhash_truth(rows, q)
    out["truth_s"] = time.perf_counter() - t0
    dim = MH_ELEMS * 32
    base, qds = kt.GenDataSet(rows.shape[0], dim, rows), kt.GenDataSet(MH_NQ, dim, q)
    src_sim = (rows[src].view(np.int32) == q.view(np.int32)).mean(1).astype(np.float32)
    failed = []
    for shared in (False, True):
        leg = out["shared_bloom" if shared else "per_band_bloom"] = {}
        idx = kt.IndexFactory.Instance().Create("MINHASH_LSH", data_type="bin1").value()
        gb0 = _dev_gb()
        st, leg["build_s"] = _timed(lambda: idx.Build(base, {"metric_type": "MHJACCARD",
                                                             "mh_lsh_shared_bloom_filter": shared}))
        if st != kt.Status.success:
            raise RuntimeError(f"MINHASH_LSH Build {st.name}")
        (_, leg["tables_s"]) = _timed(idx.node._ensure_tables)
        leg["device_gb"] = _dev_gb() - gb0
        res = {}
        for batch in (False, True):
            cfg = {"metric_type": "MHJACCARD", "k": EMB_K, "mh_lsh_batch_search": batch}
            (got, times, med) = _warm(lambda: _search_bin(kt, idx, qds, cfg), reps=3)
            res[batch] = got
            leg["batch" if batch else "one_by_one"] = {"warm_ms": times, "qps": MH_NQ / med * 1e3,
                                                      **idx.node._last_search_stats}
        (ids, sims), (ids_b, sims_b) = res[False], res[True]
        leg["batch_equals_one_by_one"] = bool(np.array_equal(ids, ids_b) and np.array_equal(sims, sims_b))
        leg["recall_at_1"] = _mh_recall(ids, sims, top_counts, 1)
        leg["recall_at_10"] = _mh_recall(ids, sims, top_counts, EMB_K)
        planted = agree >= MH_PLANTED
        first = (ids[:, 0] == src) | (sims[:, 0] >= src_sim)
        leg["planted"] = int(planted.sum())
        leg["planted_at_rank_1"] = int((first & planted).sum())
        if leg["recall_at_1"] < MH_RECALL1_FLOOR:
            failed.append(f"minhash shared={shared}: recall@1 {leg['recall_at_1']} under {MH_RECALL1_FLOOR}")
        if not leg["batch_equals_one_by_one"]:
            failed.append(f"minhash shared={shared}: batch ids differ from one-by-one")
        if leg["planted_at_rank_1"] != leg["planted"]:
            failed.append(f"minhash shared={shared}: a planted duplicate missed rank 1")
        if not shared:
            bs = kt.BinarySet()
            _, ser_s = _timed(lambda: idx.Serialize(bs))
            again = kt.IndexFactory.Instance().Create("MINHASH_LSH", data_type="bin1").value()
            st, load_s = _timed(lambda: again.Deserialize(bs))
            same = st == kt.Status.success and np.array_equal(_search_bin(kt, again, qds, cfg)[0], ids)
            leg["round_trip"] = {"serialize_s": ser_s, "deserialize_s": load_s, "same_ids": bool(same),
                                 "tables_rebuilt": bool(again.node._tables_dirty)}
            if not same or again.node._tables_dirty:
                failed.append("minhash: the round trip changed the ids or rebuilt the tables")
            del again, bs
        del idx
    return out, failed


def _search_bin(kt, idx, qds, cfg):
    res = idx.Search(qds, cfg, kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"Search failed: {res.error().name}: {res.what()}")
    return res.value().ids.reshape(-1, cfg["k"]), res.value().distance.reshape(-1, cfg["k"])


class _RowView:
    """A Milvus segment's view of its host rows, fetched by id."""

    def __init__(self, rows):
        self.rows = rows
        self.fetched = 0

    def view_data(self, ids):
        self.fetched += len(ids)
        return self.rows[ids]


def dvr_leg(kt, xb, xq, gt):
    """SCANN_DVR: DATA_VIEW refine over the 1M x 128 corpus through a view
    of the host rows (the coarse SCANN stage's ADC launch held), then UINT8,
    FP16 and BF16 refine copies at DVR_SMALL rows, recall@10 against FLAT's
    truth, and a 50% bitset with the materialized-view hint."""
    from knowhere_tpu_torch.utils.bf16 import bf16_bits

    q = xq[:DVR_NQ]
    out, failed = {}, []
    view = _RowView(xb)
    idx = kt.IndexFactory.Instance().Create("SCANN_DVR", object=view).value()
    gb0 = _dev_gb()
    st, build_s = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": 1024,
                                                                       "sub_dim": 2, "refine_type": 0}))
    if st != kt.Status.success:
        raise RuntimeError(f"SCANN_DVR Build {st.name}")
    gb = _dev_gb() - gb0
    (ids, _), held = _hold_launches(lambda: _search(idx, kt, q, DVR_SEARCH), ("ivf_adc_qtable", "ivf_adc_scan"),
                                   limit=1)
    fetched = view.fetched
    _, times, med = _warm(lambda: _search(idx, kt, q, DVR_SEARCH), reps=3)
    out["data_view_1m"] = {"build_s": build_s, "device_gb": gb, "recall_at_10": recall_at(ids, gt[:DVR_NQ]),
                           "warm_ms": times, "qps": DVR_NQ / med * 1e3, "rows_fetched_a_search": fetched}
    if out["data_view_1m"]["recall_at_10"] < DVR_FLOOR:
        failed.append(f"SCANN_DVR over the view: recall {out['data_view_1m']['recall_at_10']} under {DVR_FLOOR}")
    del idx
    xs, qs = xb[:DVR_SMALL], q
    flat = kt.IndexFactory.Instance().Create("FLAT").value()
    flat.Build(kt.GenDataSetFromArray(xs), {"metric_type": "L2"})
    gt_s = _search(flat, kt, qs, {"metric_type": "L2", "k": 10})[0]
    del flat
    for rt, name in ((1, "uint8"), (2, "fp16"), (3, "bf16")):
        for dt, rows, qrows in (("fp32", xs, qs),) + ((("bf16", bf16_bits(xs), bf16_bits(qs)),) if rt == 3 else ()):
            idx = kt.IndexFactory.Instance().Create("SCANN_DVR", data_type=dt).value()
            st, build_s = _timed(lambda: idx.Build(kt.GenDataSetFromArray(rows), {
                "metric_type": "L2", "nlist": 256, "sub_dim": 2, "refine_type": rt}))
            if st != kt.Status.success:
                raise RuntimeError(f"SCANN_DVR refine {name} {dt}: Build {st.name}")
            (ids, _), times, med = _warm(lambda: _search(idx, kt, qrows, DVR_SMALL_SEARCH), reps=3)
            out[f"{name}_refine_{dt}"] = {"build_s": build_s, "recall_at_10": recall_at(ids, gt_s),
                                          "warm_ms": times, "qps": DVR_NQ / med * 1e3,
                                          "refine_gb": idx.node._refine_store.data.numel()
                                          * idx.node._refine_store.data.element_size() / 1e9}
            if rt == 2:
                filtered = np.zeros(DVR_SMALL, bool)
                filtered[::2] = True
                mv = {"is_pure_and": True, "has_not": False, "field_id_to_touched_categories_cnt": {"101": 1}}
                ids_f, secs = _timed(lambda: _search(idx, kt, qrows, dict(
                    DVR_SMALL_SEARCH, materialized_view_search_info=mv), kt.BitsetView.from_bool_array(filtered))[0])
                out["bitset_50_mv"] = {"s": secs, "filtered_returned": int(filtered[ids_f[ids_f >= 0]].sum())}
                if out["bitset_50_mv"]["filtered_returned"]:
                    failed.append("SCANN_DVR: a filtered id came back under the bitset")
            del idx
    summary = _held_summary(held)
    return out, dict(summary["ivf_adc_scan"], qtable=summary["ivf_adc_qtable"]), failed


def faiss_leg(kt, xb, xq):
    """FAISS: each description at DVR_SMALL rows against the native node of
    the same parameters built on the same rows: the same ids."""
    xs, q = xb[:DVR_SMALL], xq[:DVR_NQ]
    out, failed = {}, []
    for desc, native, params, scfg in FAISS_DESCS:
        cfg = dict({"metric_type": "L2", "k": 10}, **scfg)
        fa = kt.IndexFactory.Instance().Create("FAISS").value()
        st, build_s = _timed(lambda: fa.Build(kt.GenDataSetFromArray(xs), {"metric_type": "L2",
                                                                          "index_description": desc}))
        nat = kt.IndexFactory.Instance().Create(native).value()
        st2, nat_s = _timed(lambda: nat.Build(kt.GenDataSetFromArray(xs), dict({"metric_type": "L2"}, **params)))
        if st != kt.Status.success or st2 != kt.Status.success:
            raise RuntimeError(f"FAISS {desc}: Build {st.name} / native {native} {st2.name}")
        (ids, _), times, med = _warm(lambda: _search(fa, kt, q, cfg), reps=3)
        same = bool(np.array_equal(ids, _search(nat, kt, q, cfg)[0]))
        out[desc] = {"build_s": build_s, "native_build_s": nat_s, "warm_ms": times, "qps": DVR_NQ / med * 1e3,
                     "ids_equal_native": same}
        if not same:
            failed.append(f"FAISS {desc}: ids differ from the native {native}")
        del fa, nat
    return out, failed


def compat_leg(kt, xb, xq):
    """The SWIG-style flow over IVF_FLAT at DVR_SMALL rows with fp32, fp16 and
    bf16 type objects, Dump / Load, BruteForceSearch, BitSet.SetBit after
    GetBitSetView; the mock wrapper over fp16 rows against an fp32 FLAT on
    the widened rows; WRAP_THREADS threads through the thread-pool wrapper
    against the serial ids."""
    import tempfile
    import threading

    import torch

    import knowhere_tpu_torch.compat as knowhere
    from knowhere_tpu_torch import wrappers
    from knowhere_tpu_torch.config import Config, Stage
    from knowhere_tpu_torch.models.flat import FlatIndexNode
    from knowhere_tpu_torch.models.ivf import IvfFlatNode
    from knowhere_tpu_torch.utils.bf16 import bf16_bits

    xs, q = xb[:DVR_SMALL], xq[:DVR_NQ]
    out, failed = {}, []
    build, search = json.dumps({"metric_type": "L2", "nlist": 256}), json.dumps({"metric_type": "L2", "k": 10,
                                                                                 "nprobe": 16})
    for tname, t, rows, qrows in (("fp32", np.float32, xs, q), ("fp16", np.float16, xs.astype(np.float16),
                                                                 q.astype(np.float16)),
                                  ("bf16", torch.bfloat16, bf16_bits(xs), bf16_bits(q))):
        idx = knowhere.CreateIndex("IVF_FLAT", knowhere.GetCurrentVersion(), t)
        st, build_s = _timed(lambda: idx.Build(knowhere.ArrayToDataSet(rows), build))
        res, st2 = idx.Search(knowhere.ArrayToDataSet(qrows), search)
        if st != knowhere.Status.success or st2 != knowhere.Status.success:
            raise RuntimeError(f"compat IVF_FLAT {tname}: {st.name} / {st2.name}")
        ids = knowhere.DataSetToArray(res)[1]
        leg = out[tname] = {"build_s": build_s, "type": idx.Type()}
        with tempfile.TemporaryDirectory() as tmp:
            bs = knowhere.GetBinarySet()
            idx.Serialize(bs)
            path = os.path.join(tmp, "dump.bin")
            _, leg["dump_s"] = _timed(lambda: knowhere.Dump(bs, path))
            bs2 = knowhere.GetBinarySet()
            knowhere.Load(bs2, path)
            again = knowhere.CreateIndex("IVF_FLAT", knowhere.GetCurrentVersion(), t)
            st = again.Deserialize(bs2)
            leg["dump_load_same_ids"] = bool(st == knowhere.Status.success and np.array_equal(
                knowhere.DataSetToArray(again.Search(knowhere.ArrayToDataSet(qrows), search)[0])[1], ids))
            del again, bs, bs2
        if not leg["dump_load_same_ids"]:
            failed.append(f"compat {tname}: Dump / Load changed the ids")
        if tname == "fp32":
            bitset = knowhere.BitSet(DVR_SMALL)
            view = bitset.GetBitSetView()
            for i in np.unique(ids[:, 0]):
                bitset.SetBit(int(i))
            res, _ = idx.Search(knowhere.ArrayToDataSet(qrows), search, view)
            left = knowhere.DataSetToArray(res)[1]
            leg["setbit_after_view_filtered_returned"] = int(np.isin(left, ids[:, 0]).sum())
            if leg["setbit_after_view_filtered_returned"]:
                failed.append("compat: a row set in the BitSet after its view came back")
            bf, secs = _timed(lambda: knowhere.BruteForceSearch(
                knowhere.ArrayToDataSet(xs), knowhere.ArrayToDataSet(q), json.dumps({"metric_type": "L2", "k": 10})))
            leg["brute_force_s"] = secs
            leg["brute_force_recall_of_ivf"] = recall_at(ids, knowhere.DataSetToArray(bf[0])[1])
        del idx
    # the mock wrapper over fp16 rows and an fp32 FLAT node on the widened rows
    x16 = xs.astype(np.float16)
    cfg, scfg = FlatIndexNode.CreateConfig(), FlatIndexNode.CreateConfig()
    Config.load(cfg, {"metric_type": "L2"}, Stage.TRAIN)
    Config.load(scfg, {"metric_type": "L2", "k": 10}, Stage.SEARCH)
    mock = wrappers.IndexNodeDataMockWrapper(FlatIndexNode(version=8))
    mock.Build(kt.GenDataSetFromArray(x16), cfg)
    plain = FlatIndexNode(version=8)
    plain.Build(kt.GenDataSetFromArray(x16.astype(np.float32)), cfg)
    a = mock.Search(kt.GenDataSetFromArray(q.astype(np.float16)), scfg, kt.BitsetView()).value().ids
    b = plain.Search(kt.GenDataSetFromArray(q.astype(np.float16).astype(np.float32)), scfg, kt.BitsetView()).value().ids
    out["mock_wrapper_fp16_equals_fp32"] = bool(np.array_equal(a, b))
    if not out["mock_wrapper_fp16_equals_fp32"]:
        failed.append("mock wrapper: fp16 rows gave other ids than the fp32 node")
    # WRAP_THREADS threads through one thread-pool wrapper over IVF_FLAT
    icfg, iscfg = IvfFlatNode.CreateConfig(), IvfFlatNode.CreateConfig()
    Config.load(icfg, {"metric_type": "L2", "nlist": 256}, Stage.TRAIN)
    Config.load(iscfg, {"metric_type": "L2", "k": 10, "nprobe": 16}, Stage.SEARCH)
    pool = wrappers.IndexNodeThreadPoolWrapper(IvfFlatNode(version=8))
    pool.Build(kt.GenDataSetFromArray(xs), icfg)
    parts = np.array_split(q, WRAP_THREADS)
    serial = [pool.Search(kt.GenDataSetFromArray(p), iscfg, kt.BitsetView()).value().ids for p in parts]
    got = [None] * WRAP_THREADS

    def run(i):
        got[i] = pool.Search(kt.GenDataSetFromArray(parts[i]), iscfg, kt.BitsetView()).value().ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(WRAP_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out["threads"] = {"n": WRAP_THREADS, "s": time.perf_counter() - t0,
                      "serial_ids": all(np.array_equal(a, b) for a, b in zip(got, serial))}
    if not out["threads"]["serial_ids"]:
        failed.append("thread-pool wrapper: threaded ids differ from the serial ones")
    return out, failed


def api_emb_list_path(kt, xb, xq, gt):
    """The last API modules through the public API (the module docstring): the
    emb_list family, MINHASH_LSH, SCANN_DVR, FAISS, compat and the wrappers.
    One launch each of ivf_f32_scan (the HNSW tokenann build), ivf_int8_scan
    (the IVF_FLAT tokenann search) and ivf_adc_scan (SCANN_DVR's coarse
    stage) is held against its plain version. Raises after the last leg if
    any check failed."""
    t_path = time.perf_counter()
    out, failed = {}, []
    t0 = time.perf_counter()
    out["emb_list"], held, bad = emb_list_legs(kt)
    out["emb_list"]["s"] = time.perf_counter() - t0
    print("api and emb_list path, emb_list:", json.dumps(out["emb_list"]), flush=True)
    failed += bad
    t0 = time.perf_counter()
    out["minhash"], bad = minhash_leg(kt)
    out["minhash"]["s"] = time.perf_counter() - t0
    print("api and emb_list path, minhash:", json.dumps(out["minhash"]), flush=True)
    failed += bad
    t0 = time.perf_counter()
    out["scann_dvr"], held["ivf_adc_scan"], bad = dvr_leg(kt, xb, xq, gt)
    out["scann_dvr"]["s"] = time.perf_counter() - t0
    failed += bad
    t0 = time.perf_counter()
    out["faiss"], bad = faiss_leg(kt, xb, xq)
    out["faiss"]["s"] = time.perf_counter() - t0
    failed += bad
    t0 = time.perf_counter()
    out["compat"], bad = compat_leg(kt, xb, xq)
    out["compat"]["s"] = time.perf_counter() - t0
    failed += bad
    out["held"] = held
    out["phase_s"] = time.perf_counter() - t_path
    if failed:
        print("api and emb_list path:", json.dumps(out), flush=True)
        raise AssertionError(f"api and emb_list path: {failed}")
    return out


def fused_knn_path(xb, xq, gt, flat_search_s, k=10):
    """fused_knn (the single-pass scan) over every query against the 1M base."""
    import torch

    from knowhere_tpu_torch.device import to_device
    from knowhere_tpu_torch.ops import fused_topk

    base = to_device(xb)
    fused_topk.fused_knn(xq, base, k, "L2")  # warm-up at the timed shape (the allocator's blocks)
    (dists, ids), wall = _timed(lambda: fused_topk.fused_knn(xq, base, k, "L2"))
    # the plain version on the same padded inputs (all queries: the scan ran
    # ten blocks of 1,024)
    base_p, norms_p = fused_topk.pad_base(base, (base * base).sum(1))
    q = torch.nn.functional.pad(to_device(xq), (0, base_p.shape[1] - base.shape[1]))
    s_p, i_p = fused_topk.fused_knn_scan_plain(q, base_p, norms_p, k=k, is_l2=True)
    dists_p, ids_p = fused_topk.host_result(s_p, i_p, xq, len(xb), True)
    del base, base_p, norms_p, q, s_p, i_p
    torch.cuda.empty_cache()
    out = {"fused_knn_s": wall, "flat_exact_search_s": flat_search_s, "fused_recall_at_10": recall_at(ids, gt),
           "plain_max_abs_err": float(np.abs(dists - dists_p).max()),
           "plain_id_agree": float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, ids_p)]))}
    if not np.allclose(dists, dists_p, rtol=FUSED_RTOL, atol=FUSED_ATOL) or out["plain_id_agree"] < FUSED_ID_AGREE:
        raise AssertionError(f"fused_knn over every query disagrees with the plain version: {out}")
    if ids.shape != (len(xq), k) or (ids < 0).any() or not np.isfinite(dists).all():
        raise AssertionError("fused_knn results not finite / wrong shape / short")
    if out["fused_recall_at_10"] < FUSED_RECALL_FLOOR:
        raise AssertionError(f"fused_knn recall@10 {out['fused_recall_at_10']} < {FUSED_RECALL_FLOOR}")
    return out


def _range(idx, kt, xq, cfg):
    """(ids, dists, lims) of a RangeSearch; raises on failure."""
    res = idx.RangeSearch(kt.GenDataSetFromArray(xq), cfg, kt.BitsetView())
    if not res.has_value():
        raise RuntimeError(f"RangeSearch failed: {res.error().name}: {res.what()}")
    v = res.value()
    return np.asarray(v.ids), np.asarray(v.distance), np.asarray(v.lims)


def _csr_sets(ids, lims):
    return [set(ids[lims[i] : lims[i + 1]].tolist()) for i in range(len(lims) - 1)]


def _range_recall(got, want) -> float:
    """The reference leg's recall: the mean over queries with exact hits of
    |found & exact| / |exact|."""
    per_q = [len(a & b) / len(b) for a, b in zip(got, want) if b]
    return float(np.mean(per_q)) if per_q else 1.0


def _with_rounds(idx, fn):
    """fn()'s output and the (k, nprobe) of each search round it ran (none
    for FLAT, which has no rounds)."""
    node, rounds = idx.node, []
    if not hasattr(node, "_search_batch"):
        return fn(), rounds
    orig = node._search_batch

    def record(xq, k, nprobe, *args, **kw):
        rounds.append((int(k), int(nprobe)))
        return orig(xq, k, nprobe, *args, **kw)

    node._search_batch = record
    try:
        return fn(), rounds
    finally:
        del node._search_batch


def _warm_range(idx, kt, xq, cfg, hold=()):
    """A warm-up with the launches of the kernels ``hold`` held against
    their plain versions (_hold_launches), then one timed RangeSearch with
    its rounds and the peak device memory of the timed call; the timed
    call must equal the warm-up."""
    import torch

    first, held = _hold_launches(lambda: _range(idx, kt, xq, cfg), hold)
    torch.cuda.reset_peak_memory_stats()
    (res, rounds), wall = _timed(lambda: _with_rounds(idx, lambda: _range(idx, kt, xq, cfg)))
    if not all(np.array_equal(a, b) for a, b in zip(first, res)):
        raise AssertionError("a RangeSearch differs from the same call before it")
    out = {"wall_s": wall, "rounds": rounds, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "hits_per_query": float(res[2][-1]) / len(xq)}
    if hold:
        out["held"] = _held_summary(held)
    return res, out


def _in_window(dists, radius, lims) -> bool:
    """Every distance finite and inside the radius, each query's run best first."""
    runs = (np.diff(dists[lims[i] : lims[i + 1]]) for i in range(len(lims) - 1))
    return bool(np.isfinite(dists).all() and (dists < radius).all() and all((r >= 0).all() for r in runs))


def range_path(kt, xb, xq, flat, ivf, pq):
    """RangeSearch, AnnIterator and the by-id reads on the SIFT-like corpus
    (the module docstring, step 6): FLAT against BruteForce and its own
    top-100, IVF_FLAT (the int8 scan's wide-k rounds) and IVF_PQ (the ADC
    scan's) against FLAT, IVF_FLAT's iterator, GetVectorByIds and
    CalcDistByIDs, and the covering exact pass on a 100,000-row IVF_FLAT."""
    from knowhere_tpu_torch.models import ivf as ivf_mod

    t_phase = time.perf_counter()
    q = xq[:RANGE_NQ]
    out = {}
    d10 = _search(flat, kt, xq[:200], {"metric_type": "L2", "k": 10})[1][:, 9]
    radius = float(np.median(d10))
    out["radius"] = radius
    cfg = {"metric_type": "L2", "radius": radius}

    # FLAT: identical to BruteForce.RangeSearch; the set of each query equals
    # its top-100 ids inside the radius wherever the 100th lies outside it
    (f_ids, f_d, f_lims), out["flat"] = _warm_range(flat, kt, q, cfg)
    bf = kt.BruteForce.RangeSearch(kt.GenDataSetFromArray(xb), kt.GenDataSetFromArray(q), cfg)
    if not bf.has_value():
        raise RuntimeError(f"BruteForce.RangeSearch failed: {bf.what()}")
    if not (np.array_equal(np.asarray(bf.value().lims), f_lims) and np.array_equal(np.asarray(bf.value().ids), f_ids)):
        raise AssertionError("FLAT RangeSearch differs from BruteForce.RangeSearch")
    if not _in_window(f_d, radius, f_lims):
        raise AssertionError("FLAT RangeSearch returned a distance outside the window or out of order")
    top_i, top_d = _search(flat, kt, q, {"metric_type": "L2", "k": 100})
    flat_sets = _csr_sets(f_ids, f_lims)
    checked = 0
    for i in range(len(q)):
        if top_d[i, -1] < radius:
            continue
        want = set(top_i[i][top_d[i] < radius].tolist())
        for r in flat_sets[i] ^ want:
            if abs(float(((q[i] - xb[r]) ** 2).sum()) - radius) > RANGE_TIE * radius:
                raise AssertionError(f"FLAT range set of query {i} differs from its top-100 at row {r}")
        checked += 1
    out["flat"]["queries_checked_vs_top100"] = checked

    # IVF_FLAT (FAST: the int8 scan's rounds) and IVF_PQ (the ADC scan's)
    icfg = dict(cfg, nprobe=RANGE_NPROBE)
    (i_ids, i_d, i_lims), out["ivf_flat"] = _warm_range(ivf, kt, q, icfg, ("ivf_int8_scan",))
    if not _in_window(i_d, radius, i_lims):
        raise AssertionError("IVF_FLAT RangeSearch returned a distance outside the window or out of order")
    out["ivf_flat"]["recall"] = _range_recall(_csr_sets(i_ids, i_lims), flat_sets)
    if out["ivf_flat"]["recall"] < RANGE_IVF_RECALL_FLOOR:
        raise AssertionError(f"IVF_FLAT range recall {out['ivf_flat']['recall']} < {RANGE_IVF_RECALL_FLOOR}")
    _profile_later("range_profile", lambda idx=ivf: _range(idx, kt, q, icfg))  # where its wall goes
    # the same call in the smallest query blocks (one rerank step each):
    # the blocks give the bits of the default's, and their launches are held
    budget, scans = ivf_mod.SCAN_BLOCK_BYTES, []
    real_scan = ivf_mod.ivf_scan_search
    ivf_mod.SCAN_BLOCK_BYTES = 1
    ivf_mod.ivf_scan_search = lambda *a, **kw: scans.append(int(a[0].shape[0])) or real_scan(*a, **kw)
    try:
        import torch

        torch.cuda.reset_peak_memory_stats()
        blocked, held = _hold_launches(lambda: _range(ivf, kt, q, icfg), ("ivf_int8_scan",))
        out["ivf_flat"]["small_blocks"] = {
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "scans": len(scans),
            "smallest_block": min(scans), "held": _held_summary(held),
        }
    finally:
        ivf_mod.SCAN_BLOCK_BYTES, ivf_mod.ivf_scan_search = budget, real_scan
    out["ivf_flat"]["blocks_bit_equal"] = all(
        a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
        for a, b in zip(blocked, (i_ids, i_d, i_lims))
    )
    if not out["ivf_flat"]["blocks_bit_equal"]:
        raise AssertionError("IVF_FLAT RangeSearch in small query blocks differs from the default blocks")
    if min(scans) >= len(q):
        raise AssertionError(f"IVF_FLAT RangeSearch at SCAN_BLOCK_BYTES=1 ran no query blocks: {scans}")
    (p_ids, p_d, p_lims), out["ivf_pq"] = _warm_range(pq, kt, q, icfg, ("ivf_adc_qtable", "ivf_adc_scan"))
    if not _in_window(p_d, radius, p_lims):
        raise AssertionError("IVF_PQ RangeSearch returned a distance outside the window or out of order")
    out["ivf_pq"]["recall"] = _range_recall(_csr_sets(p_ids, p_lims), flat_sets)
    if out["ivf_pq"]["recall"] < RANGE_PQ_RECALL_FLOOR:
        raise AssertionError(f"IVF_PQ range recall {out['ivf_pq']['recall']} < {RANGE_PQ_RECALL_FLOOR}")

    # IVF_FLAT AnnIterator: ITER_ITEMS items of ITER_NQ queries
    def drain():
        res = ivf.AnnIterator(kt.GenDataSetFromArray(q[:ITER_NQ]), {"metric_type": "L2", "nprobe": RANGE_NPROBE},
                              kt.BitsetView())
        if not res.has_value():
            raise RuntimeError(f"AnnIterator failed: {res.what()}")
        items = []
        for it in res.value():
            got = [it.Next() for _ in range(ITER_ITEMS) if it.HasNext()]
            items.append((np.array([i for i, _ in got]), np.array([d for _, d in got])))
        return items

    (items, rounds), held = _hold_launches(lambda: _with_rounds(ivf, drain), ("ivf_int8_scan",))
    items, wall = _timed(drain)
    for ids, d in items:
        if len(ids) != ITER_ITEMS or len(np.unique(ids)) != ITER_ITEMS or (np.diff(d) < 0).any():
            raise AssertionError("IVF_FLAT iterator: short, repeated ids or distances out of order")
    gt10 = _search(flat, kt, q[:ITER_NQ], {"metric_type": "L2", "k": 10})[0]
    out["iterator"] = {"wall_s": wall, "rounds": rounds, "held": _held_summary(held),
                       "recall_at_10": recall_at(np.stack([ids[:10] for ids, _ in items]), gt10)}
    if out["iterator"]["recall_at_10"] < ITER_RECALL_FLOOR:
        raise AssertionError(f"IVF_FLAT iterator recall@10 {out['iterator']['recall_at_10']} < {ITER_RECALL_FLOOR}")

    # by-id reads
    pick = np.random.default_rng(5).choice(len(xb), 1000, replace=False)
    res, wall = _timed(lambda: ivf.GetVectorByIds(kt.GenIdsDataSet(pick)))
    if not res.has_value() or not np.array_equal(np.asarray(res.value().tensor).reshape(len(pick), -1), xb[pick]):
        raise AssertionError("IVF_FLAT GetVectorByIds is not the corpus rows")
    dres, dwall = _timed(lambda: ivf.CalcDistByIDs(kt.GenDataSetFromArray(q[:100]), None, pick, len(pick)))
    want = ((q[:100, None, :].astype(np.float64) - xb[pick][None].astype(np.float64)) ** 2).sum(-1)
    err = float(np.abs(dres.value() - want).max() / np.abs(want).max()) if dres.has_value() else float("inf")
    out["by_id"] = {"get_vector_s": wall, "calc_dist_s": dwall, "calc_dist_max_rel_err": err}
    if err > 1e-3:
        raise AssertionError(f"IVF_FLAT CalcDistByIDs differs from numpy float64 by {err}")

    # a huge radius on a 100,000-row IVF_FLAT: the rounds stop at
    # DEVICE_K_MAX = 65,536 and the covering exact pass returns every row
    n_small = min(100_000, len(xb))
    small = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    if small.Build(kt.GenDataSetFromArray(xb[:n_small]), {"metric_type": "L2", "nlist": 256}) != kt.Status.success:
        raise RuntimeError("IVF_FLAT (100,000 rows) Build failed")
    (h_ids, h_d, h_lims), out["covering"] = _warm_range(
        small, kt, q[:8], {"metric_type": "L2", "radius": 1e12}, ("ivf_int8_scan",)
    )
    if not (np.diff(h_lims) == n_small).all() or not _in_window(h_d, 1e12, h_lims):
        raise AssertionError("the covering pass did not return every row, sorted")
    if any(len(np.unique(h_ids[h_lims[i] : h_lims[i + 1]])) != n_small for i in range(8)):
        raise AssertionError("the covering pass returned a row twice")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# The sharded path: the SHARDED_* names over four shards of the one card
# ---------------------------------------------------------------------------

SHARDS = 4  # each sharded leg spreads over [cuda:0] * SHARDS
DEEP_NB, DEEP_NQ, DEEP_DIM = 10_000_000, 500, 96  # bench.py's leg_deep (bench.py:1572-1638)
DEEP_GEN = {"n_clusters": 2000, "seed": 11, "intrinsic_dim": 32, "center_scale": 2.0}
DEEP_BUILD = {"metric_type": "L2", "nlist": 4096, "m": 16, "nbits": 8, "refine": True, "refine_type": "FP16"}
DEEP_SEARCH = {"metric_type": "L2", "k": 10, "refine_k": 8}
DEEP_LADDER = (8, 16, 32, 64, 128, 256, 512, 1024)  # bench.py's ladder
DEEP_TARGET = 0.95
DEEP_EXACT_BLOCK = 125  # queries a full-f32 check of the truth: 5 GB of scores over the 10M rows
DEEP_DIST_TOL = (1e-5, 1e-4)  # rtol, atol: the one-shard load's distances against the four shards'
ROUND_TRIP_AGREE = 0.95  # and its slots holding the four shards' ids
SHARDED_IVF = {  # (build, search, recall@10 floor)
    "SHARDED_IVF_FLAT": ({"metric_type": "L2", "nlist": 1024}, {"metric_type": "L2", "k": 10, "nprobe": 12}, 0.95),
    "SHARDED_IVF_SQ8": ({"metric_type": "L2", "nlist": 1024}, {"metric_type": "L2", "k": 10, "nprobe": 16}, 0.93),
}
# the reference's per-shard walk: 64 routing centroids a shard, ef 48 over
# 250,000 rows; first measured 0.8413 on an H100 (the JAX package walks the same
# graphs to the same ids, tests/test_torch_sharding.py). sharded_hnsw_walk.py
# shows the gap is that routing: 512 centroids a shard give 0.96786, 1,024
# give 0.98425; twice the steps 0.85158
SHARDED_HNSW_FLOOR = 0.84
SHARDED_HNSW_EFS = (96, 192)  # the ef ladder past GRAPH_SEARCH's 48
SHARDED_KMEANS_K = 1024
SHARDED_KMEANS_ITERS = 12
# sharded k-means against the single-device Lloyd from the same init: the
# shards add their row-order sums in shard order, the single device all rows
# in row order, so one step's centroids differ in their last bits (and a
# near-tie row may take the other cluster); over 12 steps the two runs then
# drift apart (on the H100: 0.995 of the rows in the same cluster,
# centroids up to 0.78 apart), so one step is held by its centroids and the
# 12-step runs by the mean squared distance to the nearest centroid
KMEANS_STEP_TOL = 1e-4  # rtol and atol of one step's centroids
KMEANS_STEP_SHARE = 0.99  # the share of one step's centroids within it
KMEANS_INERTIA_RTOL = 1e-4


def _shards():
    import torch

    return [torch.device("cuda", 0)] * SHARDS


def _sharded_gb(idx) -> dict:
    """Device GB of a sharded index's store tensors (every shard, by key) and
    host GB of its engine's arrays."""
    import torch

    eng = idx.node._engine
    dev = {}
    for sh in eng._shards:
        for key, t in sh["store"].items():
            dev[key] = dev.get(key, 0.0) + t.numel() * t.element_size() / 1e9
    host = sum(a.nbytes for a in (getattr(eng, n, None) for n in ("_payload", "_refine_payload", "_assign", "_xb"))
               if a is not None)
    return {"store_device_gb": dev, "host_gb": host / 1e9}


def _same_but_ties(xb, xq, ids_a, ids_b, tol=FLAT_EXACT_TIE) -> dict:
    """Two top-k id lists of the same queries: a row may differ only where
    its exact (f64) distance lists agree within tol slot for slot (another
    order, or another id among equal distances)."""
    rows = np.nonzero((ids_a != ids_b).any(1))[0]
    bad = []
    for r in rows:
        q = xq[r].astype(np.float64)
        da = ((xb[ids_a[r]].astype(np.float64) - q) ** 2).sum(1)
        db = ((xb[ids_b[r]].astype(np.float64) - q) ** 2).sum(1)
        if (ids_a[r] < 0).any() or (ids_b[r] < 0).any() or np.abs(np.sort(da) - np.sort(db)).max() > tol:
            bad.append(int(r))
    return {"rows_differing": int(len(rows)), "rows_not_near_tie": len(bad), "bad_rows": bad[:10]}


def _reload(kt, idx, name, devices=None):
    """Serialize, then Deserialize into a new node over ``devices`` (the
    default list when None): (the node, serialize s, deserialize s)."""
    bs = kt.BinarySet()
    st, ser_s = _timed(lambda: idx.Serialize(bs))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Serialize {st.name}")
    again = kt.IndexFactory.Instance().Create(name, object=devices).value()
    st, des_s = _timed(lambda: again.Deserialize(bs))
    if st != kt.Status.success:
        raise RuntimeError(f"{name} Deserialize {st.name}")
    return again, ser_s, des_s


def _filtered(kt, idx, xq, search, n, seed, keep=0.5):
    """A search under a bitset that keeps about ``keep`` of n rows: (ids,
    dists, s, the filtered or empty ids that came back, the filtered mask)."""
    drop = np.random.default_rng(seed).random(n) >= keep
    (ids, dists), secs = _timed(lambda: _search(idx, kt, xq, search, kt.BitsetView.from_bool_array(drop)))
    return ids, dists, secs, int(drop[ids[ids >= 0]].sum() + (ids < 0).sum()), drop


def deep_leg(kt):
    """bench.py's leg_deep, not cut: SHARDED_IVF_PQ over a Deep10M-like
    10M x 96 corpus on four shards; the nprobe ladder to recall@10 >= 0.95
    against FLAT's truth over the 10M rows, warm QPS, a 50% bitset, and a
    round trip onto the default device list (one shard)."""
    import torch

    out, failed = {}, []
    t0 = time.perf_counter()
    xb, _ = gen_corpus(DEEP_NB, 1, DEEP_DIM, **DEEP_GEN)
    _, xq = gen_corpus(2, DEEP_NQ, DEEP_DIM, **DEEP_GEN)  # bench's second generator call
    out["gen_s"] = time.perf_counter() - t0
    (flat, gt), out["truth_s"] = _timed(lambda: _flat_truth(kt, xb, xq))
    del flat
    torch.cuda.empty_cache()
    # the truth's flat_group_scan launch, the path's only one, held by its
    # answer: every query's ids against the full-f32 answer over the 10M rows
    exact = [flat_vs_exact(xb, xq[s : s + DEEP_EXACT_BLOCK], gt[s : s + DEEP_EXACT_BLOCK], 10)
             for s in range(0, DEEP_NQ, DEEP_EXACT_BLOCK)]
    out["truth_vs_exact"] = {key: sum(e[key] for e in exact) for key in exact[0]}
    torch.cuda.empty_cache()
    gb0 = _dev_gb()
    torch.cuda.reset_peak_memory_stats()
    idx = kt.IndexFactory.Instance().Create("SHARDED_IVF_PQ", object=_shards()).value()
    st, out["build_s"] = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), DEEP_BUILD))
    if st != kt.Status.success:
        raise RuntimeError(f"SHARDED_IVF_PQ Build {st.name}")
    out.update(_sharded_gb(idx), index_device_gb=_dev_gb() - gb0)
    ladder, cfg = [], None
    for nprobe in DEEP_LADDER:
        (ids, _), secs = _timed(lambda: _search(idx, kt, xq, dict(DEEP_SEARCH, nprobe=nprobe)))
        ladder.append({"nprobe": nprobe, "recall_at_10": recall_at(ids, gt), "first_s": secs})
        if ladder[-1]["recall_at_10"] >= DEEP_TARGET:
            cfg = dict(DEEP_SEARCH, nprobe=nprobe)
            break
    out["ladder"] = ladder
    if cfg is None:
        raise AssertionError(f"SHARDED_IVF_PQ: no nprobe of {DEEP_LADDER} reached recall {DEEP_TARGET}: {ladder}")
    (ids, dists), times, med = _warm(lambda: _search(idx, kt, xq, cfg))
    out.update(nprobe=cfg["nprobe"], recall_at_10=recall_at(ids, gt), warm_ms=times, qps=DEEP_NQ / med * 1e3,
               peak_gb=_peak_gb())
    if not np.isfinite(dists).all() or (ids < 0).any():
        failed.append("SHARDED_IVF_PQ: a result not finite or short")
    *_, out["bitset_50_s"], bad, _ = _filtered(kt, idx, xq, cfg, DEEP_NB, seed=2)
    if bad:
        failed.append(f"SHARDED_IVF_PQ: {bad} filtered or empty ids under a 50% bitset")
    # the default list is one shard here: the refine pool is then one
    # shard's 80 candidates instead of four shards' 80 each, a subset, so
    # the loaded index's distances are no better slot for slot
    one, out["serialize_s"], out["deserialize_s"] = _reload(kt, idx, "SHARDED_IVF_PQ")
    del idx
    torch.cuda.empty_cache()
    if len(one.node._engine.devices) != 1:
        raise AssertionError(f"the default device list holds {one.node._engine.devices}")
    ids1, d1 = _search(one, kt, xq, cfg)
    rtol, atol = DEEP_DIST_TOL
    out["round_trip"] = {"shards": 1, "slots_agree": float((ids1 == ids).mean()), "recall_at_10": recall_at(ids1, gt),
                         "slots_better_than_four": int((d1 < dists - (atol + rtol * np.abs(dists))).sum())}
    if out["round_trip"]["slots_better_than_four"] or out["round_trip"]["slots_agree"] < ROUND_TRIP_AGREE:
        failed.append(f"SHARDED_IVF_PQ round trip onto one shard: {out['round_trip']}")
    del one
    torch.cuda.empty_cache()
    return out, failed


def sharded_1m_legs(kt, xb, xq, gt):
    """SHARDED_FLAT, SHARDED_IVF_FLAT, SHARDED_IVF_SQ8 and SHARDED_HNSW over
    the 1M x 128 corpus on four shards, and sharded k-means. Returns (the
    numbers, the HNSW build's first f32-scan launch held, failures)."""
    import torch

    from knowhere_tpu_torch.ops import kmeans as K
    from knowhere_tpu_torch.parallel import sharding as S

    nq, out, failed = len(xq), {}, []
    flat_cfg = {"metric_type": "L2", "k": 10}
    sflat = kt.IndexFactory.Instance().Create("SHARDED_FLAT", object=_shards()).value()
    st, build_s = _timed(lambda: sflat.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2"}))
    if st != kt.Status.success:
        raise RuntimeError(f"SHARDED_FLAT Build {st.name}")
    (ids, _), times, med = _warm(lambda: _search(sflat, kt, xq, flat_cfg), reps=3)
    exact = [flat_vs_exact(xb, xq[s : s + 1000], ids[s : s + 1000], 10) for s in range(0, nq, 1000)]
    out["sharded_flat"] = {"build_s": build_s, "warm_ms": times, "qps": nq / med * 1e3,
                           "vs_flat": _same_but_ties(xb, xq, ids, gt),
                           "vs_exact_rows_differing": sum(e["rows_differing"] for e in exact)}
    if out["sharded_flat"]["vs_flat"]["rows_not_near_tie"]:
        failed.append(f"SHARDED_FLAT ids differ from FLAT's beyond near-ties: {out['sharded_flat']['vs_flat']}")

    for name, (build, search, floor) in SHARDED_IVF.items():
        idx = kt.IndexFactory.Instance().Create(name, object=_shards()).value()
        st, build_s = _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), build))
        if st != kt.Status.success:
            raise RuntimeError(f"{name} Build {st.name}")
        (ids, dists), times, med = _warm(lambda: _search(idx, kt, xq, search))
        leg = {"build_s": build_s, "recall_at_10": recall_at(ids, gt), "warm_ms": times, "qps": nq / med * 1e3,
               **_sharded_gb(idx)}
        *_, leg["bitset_50_s"], bad, _ = _filtered(kt, idx, xq, search, len(xb), seed=3)
        again, leg["serialize_s"], leg["deserialize_s"] = _reload(kt, idx, name, _shards())
        leg["round_trip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
        out[name.lower()] = leg
        if leg["recall_at_10"] < floor or bad or not leg["round_trip_ids_identical"] or (ids < 0).any():
            failed.append(f"{name}: recall {leg['recall_at_10']} (floor {floor}), {bad} filtered or empty ids "
                          f"under a 50% bitset, round trip identical {leg['round_trip_ids_identical']}")
        del idx, again
        torch.cuda.empty_cache()

    search = dict(GRAPH_SEARCH)
    idx = kt.IndexFactory.Instance().Create("SHARDED_HNSW", object=_shards()).value()
    (st, build_s), held = _hold_launches(
        lambda: _timed(lambda: idx.Build(kt.GenDataSetFromArray(xb), HNSW_BUILD)), ("ivf_f32_scan",),
        limit=1, tol=(F32_RTOL, F32_ATOL, F32_POS_AGREE))
    if st != kt.Status.success:
        raise RuntimeError(f"SHARDED_HNSW Build {st.name}")
    shards = idx.node._engine._shards
    if len(shards) != SHARDS or any(sh.get("inline") is None or sh["inline"].bits != 8 for sh in shards):
        raise AssertionError("SHARDED_HNSW: every 250,000-row shard must walk its 8-bit inline table")
    (ids, _), times, med = _warm(lambda: _search(idx, kt, xq, search))
    leg = {"build_s": build_s, "recall_at_10": recall_at(ids, gt), "warm_ms": times, "qps": nq / med * 1e3,
           **_sharded_gb(idx)}
    leg["ef_ladder"] = []
    for ef in SHARDED_HNSW_EFS:
        (ids_e, _), times_e, med_e = _warm(lambda: _search(idx, kt, xq, dict(search, ef=ef)), reps=3)
        leg["ef_ladder"].append({"ef": ef, "recall_at_10": recall_at(ids_e, gt), "qps": nq / med_e * 1e3})
    again, leg["serialize_s"], leg["deserialize_s"] = _reload(kt, idx, "SHARDED_HNSW", _shards())
    leg["round_trip_ids_identical"] = bool(np.array_equal(_search(again, kt, xq, search)[0], ids))
    del again
    # a 5% keep bitset goes to the exact scan: SHARDED_FLAT's filtered ids
    ids_f, _, leg["bitset_95_s"], bad, drop = _filtered(kt, idx, xq, search, len(xb), seed=4, keep=0.05)
    want = _search(sflat, kt, xq, flat_cfg, kt.BitsetView.from_bool_array(drop))[0]
    leg["bitset_95_vs_exact"] = _same_but_ties(xb, xq, ids_f, want)
    out["sharded_hnsw"] = leg
    if (leg["recall_at_10"] < SHARDED_HNSW_FLOOR or not leg["round_trip_ids_identical"] or bad
            or leg["bitset_95_vs_exact"]["rows_not_near_tie"]):
        failed.append(f"SHARDED_HNSW: recall {leg['recall_at_10']} (floor {SHARDED_HNSW_FLOOR}), round trip "
                      f"{leg['round_trip_ids_identical']}, 95% bitset {bad} bad ids, {leg['bitset_95_vs_exact']}")
    del idx, sflat
    torch.cuda.empty_cache()

    # sharded k-means against the single-device Lloyd from the same init
    inits, real_init = [], S._kmeanspp_init
    S._kmeanspp_init = lambda *a: inits.append(real_init(*a)) or inits[-1]  # keep the init it draws
    try:
        cents, sharded_s = _timed(lambda: S.sharded_kmeans(_shards(), xb, SHARDED_KMEANS_K, SHARDED_KMEANS_ITERS))
    finally:
        S._kmeanspp_init = real_init
    x_dev = torch.from_numpy(xb).cuda()
    init = torch.from_numpy(inits[0]).cuda()
    step_sh = S.sharded_kmeans_step(_shards(), S.shard_rows(_shards(), xb), init).cpu().numpy()
    single, _ = K._lloyd_step(x_dev, init, k=SHARDED_KMEANS_K)
    step_one = single.cpu().numpy()
    for _ in range(SHARDED_KMEANS_ITERS - 1):
        single, _ = K._lloyd_step(x_dev, single, k=SHARDED_KMEANS_K)
    single = single.cpu().numpy()

    def nearest(c):
        """(each row's nearest centroid, the mean squared distance to it)"""
        c_dev = torch.from_numpy(c).cuda()
        a = K.assign_device(x_dev, c_dev)
        return a, float(((x_dev - c_dev[a.long()]) ** 2).sum(1).double().mean())

    (a_sh, inertia), (a_one, inertia_one) = nearest(cents), nearest(single)
    km = {"k": SHARDED_KMEANS_K, "iters": SHARDED_KMEANS_ITERS, "s": sharded_s,
          "step_max_abs_diff": float(np.abs(step_sh - step_one).max()),
          "step_share_close": float(np.isclose(step_sh, step_one, rtol=KMEANS_STEP_TOL,
                                               atol=KMEANS_STEP_TOL).all(1).mean()),
          "inertia": inertia, "single_inertia": inertia_one, "assign_agree": float((a_sh == a_one).double().mean()),
          "centroids_within_1e-4": float(np.isclose(cents, single, rtol=1e-4, atol=1e-4).all(1).mean()),
          "max_abs_diff": float(np.abs(cents - single).max())}
    out["sharded_kmeans"] = km
    if km["step_share_close"] < KMEANS_STEP_SHARE or abs(inertia - inertia_one) > KMEANS_INERTIA_RTOL * inertia_one:
        failed.append(f"sharded k-means against the single-device Lloyd: {km}")
    del x_dev
    torch.cuda.empty_cache()
    return out, _held_summary(held)["ivf_f32_scan"], failed


def sharded_path(kt, xb, xq, gt):
    """The SHARDED_* names through the public API (the module docstring):
    every leg over [cuda:0] * 4, the Deep leg's round trip onto the default
    device list. Raises after the last leg if any check failed."""
    t_path = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["deep_sharded_ivf_pq"], failed = deep_leg(kt)
    out["deep_sharded_ivf_pq"]["s"] = time.perf_counter() - t0
    print("sharded path, deep:", json.dumps(out["deep_sharded_ivf_pq"]), flush=True)
    t0 = time.perf_counter()
    legs, out["held"], bad = sharded_1m_legs(kt, xb, xq, gt)
    out.update(legs, legs_1m_s=time.perf_counter() - t0)
    failed += bad
    out["phase_s"] = time.perf_counter() - t_path
    if failed:
        print("sharded path:", json.dumps(out), flush=True)
        raise AssertionError(f"sharded path: {failed}")
    return out


def _run_path(name, wrappers, must_launch, fn):
    """Drive one path with every launch counter zeroed just before it; the
    counts are read just after it, and each kernel of the path must have
    launched. Returns (fn's output, counts)."""
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    print(f"{name} launches:", json.dumps(counts), f"(wall {wall:.2f} s)")
    missing = [n for n in must_launch if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name}: {missing}")
    return out, counts


def _no_jax() -> None:
    bad = [m for m in ("jax", "ml_dtypes", "optax") if m in sys.modules]
    if bad:
        raise AssertionError(f"the port imported {bad}")


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "knowhere_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: knowhere_tpu_torch/ not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import knowhere_tpu_torch as kt
    from knowhere_tpu_torch.ops import adc_cuda, cuda_build, cuda_flat, fused_topk, graph, ivf_cuda

    _no_jax()
    kt.set_device("cuda")
    dev = torch.device("cuda")
    card = card_line()
    print("card:", card)

    t0 = time.perf_counter()
    cuda_build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc: {cuda_build.build_seconds})")

    ivf_checks = check_ivf_kernels(dev)
    adc_checks, adc_tables = check_adc_kernel(dev)
    fresh_check = check_graph_fresh_kernel(dev)
    # the general walk's widest step: DISKANN's unrouted entry ceiling of
    # 1,024 rows (W 8, degree 56, ef 128), its ring and beam staged in two
    # chunks, which the held path searches do not reach
    if check_graph_fresh_kernel(dev, W=8, deg=56, ef=128, n_seed=1024, reps=3)["staging_chunks"] < 2:
        raise AssertionError("graph_fresh: the wide case fits one staging chunk")
    t0 = time.perf_counter()
    xb, xq = gen_corpus(1_000_000, 10_000, 128, seed=0)
    print(f"corpus 1000000 x 128, 10000 queries, made in {time.perf_counter() - t0:.2f} s")
    flat_checks = check_flat_kernel(dev, xb, xq)
    fused_checks = check_fused_kernel(dev, xb, xq)

    kt.KnowhereConfig.SetSimdType("AUTO")  # FAST: the kernels' serving scans
    wrappers = {
        "ivf_int8_scan": ivf_cuda.int8_scan_tasks,
        "ivf_f32_scan": ivf_cuda.f32_scan_tasks,
        "flat_group_scan": cuda_flat.flat_group_scan,
        "ivf_adc_scan": adc_cuda.adc_scan_tasks,
        "ivf_adc_qtable": adc_cuda.adc_qtable,
        "ivf_sq_scan": ivf_cuda.sq_scan_tasks,
        "ivf_rbq_scan": ivf_cuda.rbq_scan_tasks,
        "fused_knn_scan": fused_topk.fused_knn_scan,
        "graph_fresh": graph.fresh_step,
    }
    # each kernel's launches are reported from the path that introduced it
    (e2e, flat, gt), counts = _run_path(
        "main path", wrappers, ("ivf_int8_scan", "ivf_f32_scan", "flat_group_scan"),
        lambda: main_path(kt, xb, xq),
    )
    print("main path:", json.dumps({k: v for k, v in e2e.items() if k != "_index"}))
    launches = {n: counts[n] for n in ("ivf_int8_scan", "ivf_f32_scan", "flat_group_scan")}
    adc = ("ivf_adc_qtable", "ivf_adc_scan")
    pq_out, counts = _run_path("ivf_pq path", wrappers, adc, lambda: pq_path(kt, xb, xq, gt, flat))
    print("ivf_pq path:", json.dumps({k: v for k, v in pq_out.items() if k != "_index"}))
    launches.update({n: counts[n] for n in adc})
    range_out, _ = _run_path(
        "range path", wrappers, ("ivf_int8_scan", *adc),
        lambda: range_path(kt, xb, xq, flat, e2e.pop("_index"), pq_out.pop("_index")),
    )
    print("range path:", json.dumps(range_out))
    sq_out, counts = _run_path(
        "ivf_sq8 path", wrappers, ("ivf_int8_scan", "ivf_sq_scan"), lambda: sq8_path(kt, xb, xq, gt, flat)
    )
    print("ivf_sq8 path:", json.dumps(sq_out))
    launches["ivf_sq_scan"] = counts["ivf_sq_scan"]
    rbq_out, counts = _run_path(
        "ivf_rabitq path", wrappers, ("ivf_rbq_scan",), lambda: rabitq_path(kt, xb, xq, gt, flat)
    )
    print("ivf_rabitq path:", json.dumps(rbq_out))
    launches["ivf_rbq_scan"] = counts["ivf_rbq_scan"]
    # HNSW before FLAT is dropped: its filtered truths need it
    hnsw_out, counts = _run_path(
        "hnsw path", wrappers, ("ivf_f32_scan", "graph_fresh"), lambda: hnsw_path(kt, xb, xq, gt, flat)
    )
    print("hnsw path:", json.dumps(hnsw_out))
    launches["graph_fresh"] = counts["graph_fresh"]
    scann_out, _ = _run_path("scann path", wrappers, adc, lambda: scann_path(kt, xb, xq, gt, flat))
    print("scann path:", json.dumps(scann_out))
    del flat
    torch.cuda.empty_cache()
    # the fused scan's three launches are counted apart too: each
    # fused_knn_scan call must launch each of them once a query block
    parts = {"fused_group_max": cuda_flat.fused_group_max, "flat_select": cuda_flat.flat_select,
             "fused_rescore": cuda_flat.fused_rescore}
    fused_out, counts = _run_path(
        "fused knn path", dict(wrappers, **parts), ("fused_knn_scan", *parts),
        lambda: fused_knn_path(xb, xq, gt, e2e["flat_search_s"]),
    )
    calls = counts["fused_knn_scan"]
    fused_out["launches_per_call"] = {n: counts[n] / calls for n in parts}
    print("fused knn path:", json.dumps(fused_out))
    blocks = -(-len(xq) // fused_topk.query_block(-(-len(xb) // fused_topk.ROW_TILE) * fused_topk.ROW_TILE))
    if any(counts[n] != calls * blocks for n in parts):
        raise AssertionError(f"fused knn path: {calls} scans of {blocks} query blocks each, launches {counts}")
    launches["fused_knn_scan"] = calls
    gist_out, _ = _run_path("gist ivf_pq path", wrappers, (*adc, "flat_group_scan"), lambda: gist_pq_path(kt))
    print("gist ivf_pq path:", json.dumps(gist_out))
    bin_out, _ = _run_path("binary path", wrappers, ("ivf_f32_scan",), lambda: binary_path(kt, xb, xq))
    print("binary path:", json.dumps(bin_out))
    typed_out, _ = _run_path("typed path", wrappers, (), lambda: typed_path(kt, xb, xq, wrappers))
    print("typed path:", json.dumps(typed_out))
    cc_out, _ = _run_path(
        "cc path", wrappers, ("ivf_int8_scan",), lambda: cc_path(kt, xb, xq, gt, e2e["recall_at_10"])
    )
    print("cc path:", json.dumps(cc_out))
    graph_out, _ = _run_path(
        "graph families path", wrappers, ("ivf_f32_scan", "graph_fresh"),
        lambda: graph_families_path(kt, xb, xq, hnsw_out["hnsw_recall_at_10"]),
    )
    print("graph families path:", json.dumps(graph_out))
    disk_out, _ = _run_path(
        "diskann path", wrappers, ("ivf_f32_scan", "graph_fresh"), lambda: diskann_path(kt, xb, xq, gt)
    )
    print("diskann path:", json.dumps(disk_out))
    # the sparse engines are torch ops: the path launches none of the kernels
    sparse_out, _ = _run_path("sparse path", wrappers, (), lambda: sparse_path(kt))
    print("sparse path:", json.dumps(sparse_out))
    api_out, _ = _run_path(
        "api and emb_list path", wrappers, ("flat_group_scan", "ivf_int8_scan", "ivf_f32_scan", *adc),
        lambda: api_emb_list_path(kt, xb, xq, gt),
    )
    print("api and emb_list path:", json.dumps(api_out))
    # the sharded IVF stores take the plain scan (unaligned per-shard lists,
    # no kernel sidecars), as in the reference: only the FLAT truths, the
    # SHARDED_HNSW build's kNN graphs and its shards' walks launch kernels
    sharded_kernels = ("ivf_f32_scan", "flat_group_scan", "graph_fresh")
    sharded_out, counts = _run_path(
        "sharded path", wrappers, sharded_kernels, lambda: sharded_path(kt, xb, xq, gt),
    )
    print("sharded path:", json.dumps(sharded_out))
    stray = {n: c for n, c in counts.items() if c and n not in sharded_kernels}
    if stray:
        raise AssertionError(f"the sharded path launched {stray}: its IVF scans must take the plain scan")
    _no_jax()
    profiles = late_profiles()
    print("late profiles:", json.dumps(profiles))
    # after every timed search: its steps' large blocks do not share a
    # process with them
    lloyd = check_lloyd_repro(dev, xb)
    # what a second process on the same seeds must reproduce: the device
    # build is deterministic, so these equal from run to run
    print("reproducibility:", json.dumps({
        "ivf_flat_recall_at_10": e2e["recall_at_10"], "ivf_pq_recall_at_10": pq_out["pq_recall_at_10"],
        "adc_tasks": profiles["pq_profile"]["adc_tasks"], "gist_pq_recall_at_10": gist_out["gist_pq_recall_at_10"],
        "lloyd_bit_equal": all(v["bit_equal"] for v in lloyd.values()),
    }))
    torch.cuda.synchronize()

    first = {name: lines[0] for name, lines in (
        ("ivf_int8_scan", ivf_checks["ivf_int8_scan"]),
        ("ivf_f32_scan", ivf_checks["ivf_f32_scan"]),
        ("flat_group_scan", flat_checks),
        ("ivf_adc_scan", adc_checks),
        ("ivf_adc_qtable", adc_tables),
        ("ivf_sq_scan", ivf_checks["ivf_sq_scan"]),
        ("ivf_rbq_scan", ivf_checks["ivf_rbq_scan"]),
        ("fused_knn_scan", fused_checks),
        ("graph_fresh", [fresh_check]),
    )}
    meta = {
        "ivf_int8_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:400"),
        "ivf_f32_scan": ("knowhere_tpu_torch/csrc/ivf_scan.cu", "knowhere_tpu/ops/ivf_pallas.py:113"),
        "flat_group_scan": ("knowhere_tpu_torch/csrc/flat_scan.cu", "knowhere_tpu/ops/pallas_flat.py:62"),
        "ivf_adc_scan": (
            "knowhere_tpu_torch/csrc/ivf_adc.cu",
            "knowhere_tpu/ops/ivf_pallas.py:556 and knowhere_tpu/ops/ivf_pallas.py:732",
        ),
        # the query products those two kernels form inside each task
        "ivf_adc_qtable": (
            "knowhere_tpu_torch/csrc/ivf_adc.cu",
            "knowhere_tpu/ops/ivf_pallas.py:556 and knowhere_tpu/ops/ivf_pallas.py:732",
        ),
        "ivf_sq_scan": ("knowhere_tpu_torch/csrc/ivf_sq.cu", "knowhere_tpu/ops/ivf_pallas.py:236"),
        "ivf_rbq_scan": ("knowhere_tpu_torch/csrc/ivf_rbq.cu", "knowhere_tpu/ops/ivf_pallas.py:966"),
        "fused_knn_scan": ("knowhere_tpu_torch/csrc/flat_scan.cu", "knowhere_tpu/ops/pallas_topk.py:73"),
        # the JAX walks' membership test is XLA ops (knowhere_tpu/ops/graph.py, graph_inline.py)
        "graph_fresh": ("knowhere_tpu_torch/csrc/graph_walk.cu", None),
    }
    # library_ms is null for every kernel: no single PyTorch call computes a
    # per-task masked top-kk over gathered list blocks, FLAT's top-k of
    # 16-row group maxima, a bf16 top-k scan (a product without the top-k
    # is another function; the fused scan's two-call yardstick is printed in
    # its kernel lines), a walk step's row-wise membership test or the ADC
    # table's products summed in ascending feature
    kernels = [
        {
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": launches[name], "max_abs_err": first[name]["max_abs_err"],
            "ms": first[name]["ms"], "plain_ms": first[name]["plain_ms"],
            "bound_ms": first[name]["bound_ms"], "bound_by": first[name]["bound_by"], "library_ms": None,
        }
        for name in wrappers
    ]
    # measured times only beside bound_ms (the other bounds, and the fused
    # design's byte floor, stay on the kernels' case lines): FLAT's two
    # launches apart and its f32 yardstick (several calls); the fused scan's
    # three launches apart and its two-call yardstick
    for entry in kernels:
        extra = ("group_max_ms", "select_ms", "yardstick_ms", "rescore_ms", "two_call_topk_ms")
        entry.update({key: first[entry["name"]][key] for key in extra if key in first[entry["name"]]})
    print(f"script wall s: {time.perf_counter() - t_script:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
