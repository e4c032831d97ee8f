"""cuVS / CAGRA names on the port's engines, with the full cuVS config
surface and its knob translation (counterpart of knowhere_tpu/models/cagra.py).

Reference parity targets:
  - GPU_CUVS_CAGRA / GPU_CAGRA / TPU_CAGRA
    (src/index/gpu_cuvs/gpu_cuvs_cagra_config.h, index_param.h:169-186):
    graph_degree -> the final degree (the graph's level-0 degree is 2*M, so
    M = gd/2), intermediate_graph_degree -> the candidate pool (the build's
    pool is efConstruction/4, so efConstruction = 4*igd), itopk_size -> ef,
    refine_ratio -> refine_k (search refine_ratio*k, then rerank exactly),
    cache_dataset_on_device -> an FP32 refine store. The CUDA-scheduling
    knobs (team_size, thread_block_size, hashmap_*, search_width,
    *_iterations, max_queries, build_algo / search_algo,
    num_random_samplings, nn_descent_niter, adapt_for_cpu, persistent) are
    declared with the reference's defaults and ranges so configs validate
    alike; the batched graph walk has no such scheduler, so they change
    nothing.
  - GPU_CUVS_IVF_FLAT / GPU_CUVS_IVF_PQ (gpu_cuvs_ivf_flat_config.h,
    gpu_cuvs_ivf_pq_config.h): kmeans_n_iters / kmeans_trainset_fraction
    feed the Lloyd trainer, cache_dataset_on_device -> a raw refine store,
    refine_ratio -> refine_k, m=0 -> the largest divisor of dim that is at
    most dim/2, nbits in [4, 8] as in cuVS.
"""

import math

from ..config import Config, Entry, Stage
from ..feature import feature
from ..factory import register_index
from ..index_param import IndexEnum
from .hnsw import BaseHnswConfig, HnswFlatNode
from .ivf import IvfFlatConfig, IvfFlatNode, IvfPqConfig, IvfPqNode

_DENSE = ("fp32", "fp16", "bf16", "int8")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


class GpuCuvsCagraConfig(BaseHnswConfig):
    """gpu_cuvs_cagra_config.h:33-131 — full field list, same defaults."""

    # re-declared WITHOUT defaults: unset means "derive from the CAGRA knobs"
    # (graph_degree / intermediate_graph_degree) in CagraNode.Train
    M = Entry(int, range=(2, 2048), stages=[Stage.TRAIN], allow_empty=True)
    efConstruction = Entry(int, range=(1, None), stages=[Stage.TRAIN], allow_empty=True)
    cache_dataset_on_device = Entry(bool, default=False, stages=[Stage.TRAIN])
    refine_ratio = Entry(float, default=1.0, range=(1.0, None), stages=[Stage.SEARCH])
    intermediate_graph_degree = Entry(int, default=128, range=(1, None), stages=[Stage.TRAIN])
    graph_degree = Entry(int, default=64, range=(1, None), stages=[Stage.TRAIN])
    itopk_size = Entry(int, range=(1, None), stages=[Stage.SEARCH], allow_empty=True)
    max_queries = Entry(int, default=0, stages=[Stage.SEARCH])
    build_algo = Entry(str, default="NN_DESCENT", stages=[Stage.TRAIN])
    search_algo = Entry(str, default="AUTO", stages=[Stage.SEARCH])
    team_size = Entry(int, default=0, range=(0, 32), stages=[Stage.SEARCH])
    search_width = Entry(int, range=(1, None), stages=[Stage.SEARCH], allow_empty=True)
    num_random_samplings = Entry(int, default=1, range=(1, None), stages=[Stage.SEARCH])
    min_iterations = Entry(int, default=0, stages=[Stage.SEARCH])
    max_iterations = Entry(int, default=0, stages=[Stage.SEARCH])
    thread_block_size = Entry(int, default=0, stages=[Stage.SEARCH])
    hashmap_mode = Entry(str, default="AUTO", stages=[Stage.SEARCH])
    hashmap_min_bitlen = Entry(int, default=0, stages=[Stage.SEARCH])
    hashmap_max_fill_rate = Entry(float, default=0.5, range=(0.1, 0.9), stages=[Stage.SEARCH])
    nn_descent_niter = Entry(int, default=20, stages=[Stage.TRAIN])
    adapt_for_cpu = Entry(bool, default=False, stages=[Stage.TRAIN])
    persistent = Entry(bool, default=False, stages=[Stage.SEARCH])


class _CuvsIvfCommon(Config):
    cache_dataset_on_device = Entry(bool, default=False, stages=[Stage.TRAIN])
    refine_ratio = Entry(float, default=1.0, range=(1.0, None), stages=[Stage.SEARCH])
    kmeans_n_iters = Entry(int, default=20, range=(1, None), stages=[Stage.TRAIN])
    kmeans_trainset_fraction = Entry(float, default=0.5, range=(0.0, 1.0), stages=[Stage.TRAIN])


class GpuCuvsIvfFlatConfig(IvfFlatConfig, _CuvsIvfCommon):
    """gpu_cuvs_ivf_flat_config.h:28-58."""

    adaptive_centers = Entry(bool, default=False, stages=[Stage.TRAIN])


class GpuCuvsIvfPqConfig(IvfPqConfig, _CuvsIvfCommon):
    """gpu_cuvs_ivf_pq_config.h:28-93 (m=0 means auto; nbits in [4, 8])."""

    m = Entry(int, default=0, range=(0, 65536), stages=[Stage.TRAIN])
    nbits = Entry(int, default=8, range=(4, 8), stages=[Stage.TRAIN])
    codebook_kind = Entry(str, default="PER_SUBSPACE", stages=[Stage.TRAIN])
    force_random_rotation = Entry(bool, default=False, stages=[Stage.TRAIN])
    conservative_memory_allocation = Entry(bool, default=False, stages=[Stage.TRAIN])
    lut_dtype = Entry(str, default="CUDA_R_32F", stages=[Stage.SEARCH])
    internal_distance_dtype = Entry(str, default="CUDA_R_32F", stages=[Stage.SEARCH])
    preferred_shmem_carveout = Entry(float, default=1.0, range=(0.0, 1.0), stages=[Stage.SEARCH])


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


def _apply_refine_ratio(cfg: Config) -> None:
    """refine_ratio -> refine_k: cuVS retrieves refine_ratio*k candidates,
    then reranks them exactly; the engines take the multiplier directly."""
    rr = float(cfg.get("refine_ratio", 1.0) or 1.0)
    if rr > 1.0 and cfg.get("refine_k") is None:
        cfg.refine_k = max(1, math.ceil(rr))


class CagraNode(HnswFlatNode):
    """CAGRA on the flat graph engine (models/hnsw.py's build and walks).

    CAGRA's search is a beam traversal of a fixed-degree kNN graph with an
    itopk-sized result queue, the computation the batched graph walk runs;
    the translation maps its graph shape and queue size onto the walk's.
    """

    @classmethod
    def CreateConfig(cls) -> Config:
        return GpuCuvsCagraConfig()

    def Train(self, dataset, cfg):
        # graph_degree is CAGRA's final degree; the level-0 degree is 2*M
        if cfg.get("M") is None:
            cfg.M = max(2, int(cfg.get("graph_degree", 64) or 64) // 2)
        if cfg.get("efConstruction") is None:
            # the build's candidate pool is efConstruction//4 (hnsw._build_all)
            cfg.efConstruction = 4 * int(cfg.get("intermediate_graph_degree", 128) or 128)
        if cfg.get("cache_dataset_on_device") and cfg.get("refine") is None:
            cfg.refine = True
            cfg.refine_type = "FP32"
        return super().Train(dataset, cfg)

    def Search(self, dataset, cfg, bitset):
        if cfg.get("ef") is None and cfg.get("itopk_size") is not None:
            cfg.ef = int(cfg.itopk_size)
        _apply_refine_ratio(cfg)
        return super().Search(dataset, cfg, bitset)

    def RangeSearch(self, dataset, cfg, bitset):
        if cfg.get("ef") is None and cfg.get("itopk_size") is not None:
            cfg.ef = int(cfg.itopk_size)
        return super().RangeSearch(dataset, cfg, bitset)


class CuvsIvfFlatNode(IvfFlatNode):
    @classmethod
    def CreateConfig(cls) -> Config:
        return GpuCuvsIvfFlatConfig()

    def Search(self, dataset, cfg, bitset):
        _apply_refine_ratio(cfg)
        return super().Search(dataset, cfg, bitset)


class CuvsIvfPqNode(IvfPqNode):
    @classmethod
    def CreateConfig(cls) -> Config:
        return GpuCuvsIvfPqConfig()

    def Train(self, dataset, cfg):
        if not int(cfg.get("m", 0) or 0):
            # cuVS pq_dim=0 -> auto: the largest m <= dim/2 that divides dim
            # (cuVS rounds pq_dim to a multiple of 8 internally)
            dim = int(dataset.dim)
            m = max(1, dim // 2)
            while m > 1 and dim % m != 0:
                m -= 1
            cfg.m = m
        if cfg.get("cache_dataset_on_device") and cfg.get("refine") is None:
            cfg.refine = True
            cfg.refine_type = "FP32"
        return super().Train(dataset, cfg)

    def Search(self, dataset, cfg, bitset):
        _apply_refine_ratio(cfg)
        return super().Search(dataset, cfg, bitset)


# the cuVS names get the cuVS config surface: these registrations come after
# models/hnsw.py's and models/ivf.py's (imported above), and the factory keeps
# the last registration of a name
_F = feature
for _name in (
    IndexEnum.INDEX_CUVS_CAGRA,
    IndexEnum.INDEX_GPU_CAGRA,
    IndexEnum.INDEX_TPU_CAGRA,
):
    register_index(_name, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.GPU)(CagraNode)
for _name in (
    IndexEnum.INDEX_CUVS_IVFFLAT,
    IndexEnum.INDEX_GPU_IVFFLAT,
    IndexEnum.INDEX_TPU_IVFFLAT,
):
    register_index(_name, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.GPU)(CuvsIvfFlatNode)
for _name in (
    IndexEnum.INDEX_CUVS_IVFPQ,
    IndexEnum.INDEX_GPU_IVFPQ,
    IndexEnum.INDEX_TPU_IVFPQ,
):
    register_index(_name, _DENSE, _F.ALL_DENSE_TYPE | _F.KNN | _F.GPU)(CuvsIvfPqNode)
