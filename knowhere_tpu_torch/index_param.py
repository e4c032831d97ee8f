"""Index-type names, metric names, and JSON parameter keys.

API-surface parity with the reference constant tables
(reference: include/knowhere/comp/index_param.h:25-294). The JSON contract —
same keys, same index/metric spellings — is what lets a Knowhere user switch
to this framework unchanged.
"""

from __future__ import annotations


class IndexEnum:
    INVALID = ""

    INDEX_FAISS_BIN_IDMAP = "BIN_FLAT"
    INDEX_FAISS = "FAISS"
    INDEX_FAISS_BIN_IVFFLAT = "BIN_IVF_FLAT"

    INDEX_FAISS_IDMAP = "FLAT"
    INDEX_FAISS_IVFFLAT = "IVF_FLAT"
    INDEX_FAISS_IVFFLAT_CC = "IVF_FLAT_CC"
    INDEX_FAISS_IVFPQ = "IVF_PQ"
    INDEX_FAISS_SCANN = "SCANN"
    INDEX_FAISS_SCANN_DVR = "SCANN_DVR"
    INDEX_FAISS_IVFSQ8 = "IVF_SQ8"
    INDEX_FAISS_IVFSQ_CC = "IVF_SQ_CC"
    INDEX_FAISS_IVFRABITQ = "IVF_RABITQ"
    INDEX_FAISS_IVFRABITQ_FASTSCAN = "IVF_RABITQ_FASTSCAN"

    INDEX_HNSW = "HNSW"
    INDEX_HNSW_SQ = "HNSW_SQ"
    INDEX_HNSW_PQ = "HNSW_PQ"
    INDEX_HNSW_PRQ = "HNSW_PRQ"

    INDEX_DISKANN = "DISKANN"
    INDEX_AISAQ = "AISAQ"
    # closed-source Cardinal tiered index (reference registers it only under
    # WITH_CARDINAL; name constant kept for config/check parity)
    INDEX_CARDINAL_TIERED = "CARDINAL_TIERED"
    INDEX_MINHASH_LSH = "MINHASH_LSH"

    INDEX_SVS_FLAT = "SVS_FLAT"
    INDEX_SVS_VAMANA = "SVS_VAMANA"
    INDEX_SVS_VAMANA_LVQ = "SVS_VAMANA_LVQ"
    INDEX_SVS_VAMANA_LEANVEC = "SVS_VAMANA_LEANVEC"
    INDEX_HNSW_DEPRECATED = "HNSWLIB_DEPRECATED"

    INDEX_SPARSE_INVERTED_INDEX = "SPARSE_INVERTED_INDEX"
    INDEX_SPARSE_WAND = "SPARSE_WAND"
    INDEX_SPARSE_INVERTED_INDEX_CC = "SPARSE_INVERTED_INDEX_CC"
    INDEX_SPARSE_WAND_CC = "SPARSE_WAND_CC"

    # TPU-accelerated aliases: the reference exposes GPU_* families
    # (index_param.h:42-56); on this framework every index is device-resident,
    # and the TPU_* names are registered as aliases of the native families.
    INDEX_TPU_BRUTEFORCE = "TPU_BRUTE_FORCE"
    INDEX_TPU_IVFFLAT = "TPU_IVF_FLAT"
    INDEX_TPU_IVFPQ = "TPU_IVF_PQ"
    INDEX_TPU_CAGRA = "TPU_CAGRA"

    # Multi-chip sharded indexes (SURVEY.md §5.8): one LOGICAL index sharded
    # across every visible device; replaces the reference's Milvus-side
    # per-segment factory creation + CPU top-k merge (index_factory.cc:48).
    INDEX_SHARDED_FLAT = "SHARDED_FLAT"
    INDEX_SHARDED_IVFFLAT = "SHARDED_IVF_FLAT"
    INDEX_SHARDED_IVFSQ8 = "SHARDED_IVF_SQ8"
    INDEX_SHARDED_IVFPQ = "SHARDED_IVF_PQ"
    INDEX_SHARDED_HNSW = "SHARDED_HNSW"

    # GPU_CUVS_* names from the reference are accepted as aliases as well so
    # Milvus-style callers keep working (served by the TPU equivalents).
    INDEX_CUVS_BRUTEFORCE = "GPU_CUVS_BRUTE_FORCE"
    INDEX_CUVS_IVFFLAT = "GPU_CUVS_IVF_FLAT"
    INDEX_CUVS_IVFPQ = "GPU_CUVS_IVF_PQ"
    INDEX_CUVS_CAGRA = "GPU_CUVS_CAGRA"
    INDEX_GPU_BRUTEFORCE = "GPU_BRUTE_FORCE"
    INDEX_GPU_IVFFLAT = "GPU_IVF_FLAT"
    INDEX_GPU_IVFPQ = "GPU_IVF_PQ"
    INDEX_GPU_CAGRA = "GPU_CAGRA"

    # legacy faiss-GPU names (reference index_param.h:42-45, src/index/gpu/)
    INDEX_FAISS_GPU_IDMAP = "GPU_FAISS_FLAT"
    INDEX_FAISS_GPU_IVFFLAT = "GPU_FAISS_IVF_FLAT"
    INDEX_FAISS_GPU_IVFPQ = "GPU_FAISS_IVF_PQ"
    INDEX_FAISS_GPU_IVFSQ8 = "GPU_FAISS_IVF_SQ8"


class ClusterEnum:
    CLUSTER_KMEANS = "KMEANS"


class meta:
    INDEX_TYPE = "index_type"
    METRIC_TYPE = "metric_type"
    DATA_PATH = "data_path"
    INDEX_PREFIX = "index_prefix"
    INDEX_ENGINE_VERSION = "index_engine_version"
    RETRIEVE_FRIENDLY = "retrieve_friendly"
    DIM = "dim"
    TENSOR = "tensor"
    ROWS = "rows"
    NQ = "nq"
    IDS = "ids"
    DISTANCE = "distance"
    LIMS = "lims"
    TOPK = "k"
    RANGE_SEARCH_K = "range_search_k"
    RETAIN_ITERATOR_ORDER = "retain_iterator_order"
    RADIUS = "radius"
    RANGE_FILTER = "range_filter"
    INPUT_IDS = "input_ids"
    INPUT_BEG_ID = "input_begin_id"
    OUTPUT_TENSOR = "output_tensor"
    DEVICE_ID = "gpu_id"
    NUM_BUILD_THREAD = "num_build_thread"
    TRACE_VISIT = "trace_visit"
    JSON_INFO = "json_info"
    JSON_ID_SET = "json_id_set"
    TRACE_ID = "trace_id"
    SPAN_ID = "span_id"
    TRACE_FLAGS = "trace_flags"
    SCALAR_INFO = "scalar_info"
    MATERIALIZED_VIEW_SEARCH_INFO = "materialized_view_search_info"
    MATERIALIZED_VIEW_OPT_FIELDS_PATH = "opt_fields_path"
    MAX_EMPTY_RESULT_BUCKETS = "max_empty_result_buckets"
    BM25_K1 = "bm25_k1"
    BM25_B = "bm25_b"
    BM25_AVGDL = "bm25_avgdl"
    DIM_MAX_SCORE_RATIO = "dim_max_score_ratio"

    EMB_LIST_META = "EMB_LIST_META"
    EMB_LIST_OFFSET = "EMB_LIST_OFFSET"
    EMB_LIST_RAW_INDEX = "EMB_LIST_RAW_INDEX"

    EMB_LIST_STRATEGY = "emb_list_strategy"
    EMB_LIST_STRATEGY_TOKENANN = "tokenann"
    EMB_LIST_STRATEGY_MUVERA = "muvera"
    EMB_LIST_STRATEGY_LEMUR = "lemur"


class indexparam:
    # IVF
    NPROBE = "nprobe"
    NLIST = "nlist"
    USE_ELKAN = "use_elkan"
    NBITS = "nbits"
    M = "m"
    IVF_SQ_TYPE = "sq_type"
    SSIZE = "ssize"
    REORDER_K = "reorder_k"
    WITH_RAW_DATA = "with_raw_data"
    ENSURE_TOPK_FULL = "ensure_topk_full"
    CODE_SIZE = "code_size"
    RAW_DATA_STORE_PREFIX = "raw_data_store_prefix"
    SUB_DIM = "sub_dim"
    REFINE = "refine"
    REFINE_TYPE = "refine_type"
    REFINE_K = "refine_k"
    REFINE_WITH_QUANT = "refine_with_quant"

    # TPU-accelerated family knobs (reference cuVS keys, index_param.h:157-199)
    REFINE_RATIO = "refine_ratio"
    CACHE_DATASET_ON_DEVICE = "cache_dataset_on_device"
    KMEANS_N_ITERS = "kmeans_n_iters"
    KMEANS_TRAINSET_FRACTION = "kmeans_trainset_fraction"

    # CAGRA-style graph index
    INTERMEDIATE_GRAPH_DEGREE = "intermediate_graph_degree"
    GRAPH_DEGREE = "graph_degree"
    ITOPK_SIZE = "itopk_size"
    SEARCH_WIDTH = "search_width"
    MAX_ITERATIONS = "max_iterations"
    MIN_ITERATIONS = "min_iterations"
    NN_DESCENT_NITER = "nn_descent_niter"
    BUILD_ALGO = "build_algo"
    SEARCH_ALGO = "search_algo"
    # cuVS tuning knobs (reference index_param.h:157-199; accepted for
    # config-parity — the TPU engines have no CUDA-block analogs to tune)
    ADAPTIVE_CENTERS = "adaptive_centers"
    CODEBOOK_KIND = "codebook_kind"
    FORCE_RANDOM_ROTATION = "force_random_rotation"
    CONSERVATIVE_MEMORY_ALLOCATION = "conservative_memory_allocation"
    LUT_DTYPE = "lut_dtype"
    INTERNAL_DISTANCE_DTYPE = "internal_distance_dtype"
    PREFERRED_SHMEM_CARVEOUT = "preferred_shmem_carveout"
    MAX_QUERIES = "max_queries"
    TEAM_SIZE = "team_size"
    NUM_RANDOM_SAMPLINGS = "num_random_samplings"
    THREAD_BLOCK_SIZE = "thread_block_size"
    HASHMAP_MODE = "hashmap_mode"
    HASHMAP_MIN_BITLEN = "hashmap_min_bitlen"
    HASHMAP_MAX_FILL_RATE = "hashmap_max_fill_rate"
    ADAPT_FOR_CPU = "adapt_for_cpu"

    # HNSW
    EFCONSTRUCTION = "efConstruction"
    HNSW_M = "M"
    EF = "ef"
    SEED_EF = "seed_ef"
    OVERVIEW_LEVELS = "overview_levels"

    # DISKANN
    MAX_DEGREE = "max_degree"
    PQ_CODE_BUDGET_GB = "pq_code_budget_gb"
    # DISKANN AISAQ variant (reference diskann_aisaq.cc)
    REARRANGE = "rearrange"
    NUM_ENTRY_POINTS = "num_entry_points"
    INLINE_PQ = "inline_pq"
    PQ_CACHE_SIZE = "pq_cache_size"
    PQ_READ_PAGE_CACHE_SIZE = "pq_read_page_cache_size"
    VECTORS_BEAMWIDTH = "vectors_beamwidth"
    # SVS (reference index_param.h:211-219)
    SVS_GRAPH_MAX_DEGREE = "svs_graph_max_degree"
    SVS_CONSTRUCTION_WINDOW_SIZE = "svs_construction_window_size"
    SVS_SEARCH_WINDOW_SIZE = "svs_search_window_size"
    SVS_SEARCH_BUFFER_CAPACITY = "svs_search_buffer_capacity"
    SVS_ALPHA = "svs_alpha"
    SVS_STORAGE_KIND = "svs_storage_kind"
    SVS_LEANVEC_DIM = "svs_leanvec_dim"
    BUILD_DRAM_BUDGET_GB = "build_dram_budget_gb"
    BEAMWIDTH = "beamwidth"
    SEARCH_CACHE_BUDGET_GB = "search_cache_budget_gb"
    SEARCH_LIST_SIZE = "search_list_size"
    DISK_PQ_DIMS = "disk_pq_dims"

    # SQ / PRQ
    SQ_TYPE = "sq_type"
    PRQ_NUM = "nrq"

    # Sparse
    INVERTED_INDEX_ALGO = "inverted_index_algo"
    DROP_RATIO_BUILD = "drop_ratio_build"
    DROP_RATIO_SEARCH = "drop_ratio_search"

    # RaBitQ
    RABITQ_BITS = "rbq_bits"
    RABITQ_QUERY_BITS = "rbq_bits_query"

    # MinHash
    MH_ELEMENT_BIT_WIDTH = "mh_element_bit_width"
    MH_LSH_SEARCH_WITH_JACCARD = "mh_search_with_jaccard"
    MH_LSH_ALIGNED_BLOCK_SIZE = "mh_lsh_aligned_block_size"
    MH_LSH_BAND = "mh_lsh_band"
    MH_LSH_SHARED_BLOOM_FILTER = "mh_lsh_shared_bloom_filter"
    MH_LSH_BLOOM_FALSE_POSITIVE_RPOB = "mh_lsh_bloom_false_positive_prob"
    MH_LSH_HASH_CODE_IN_MEM = "mh_lsh_code_in_mem"
    MH_LSH_REFINE_K = "refine_k"
    MH_LSH_BATCH_SEARCH = "mh_lsh_batch_search"

    # emb_list
    RETRIEVAL_ANN_RATIO = "retrieval_ann_ratio"


class metric:
    IP = "IP"
    L2 = "L2"
    COSINE = "COSINE"
    HAMMING = "HAMMING"
    JACCARD = "JACCARD"
    MHJACCARD = "MHJACCARD"
    SUBSTRUCTURE = "SUBSTRUCTURE"
    SUPERSTRUCTURE = "SUPERSTRUCTURE"
    BM25 = "BM25"
    MAX_SIM = "MAX_SIM"
    MAX_SIM_COSINE = "MAX_SIM_COSINE"
    MAX_SIM_IP = "MAX_SIM_IP"
    MAX_SIM_L2 = "MAX_SIM_L2"
    MAX_SIM_HAMMING = "MAX_SIM_HAMMING"
    MAX_SIM_JACCARD = "MAX_SIM_JACCARD"
    DTW = "DTW"
    DTW_COSINE = "DTW_COSINE"
    DTW_IP = "DTW_IP"
    DTW_L2 = "DTW_L2"
    DTW_HAMMING = "DTW_HAMMING"
    DTW_JACCARD = "DTW_JACCARD"


# Milvus proto-compatible data-type tags (reference index_param.h:282-289).
class VecType:
    VECTOR_BINARY = 100
    VECTOR_FLOAT = 101
    VECTOR_FLOAT16 = 102
    VECTOR_BFLOAT16 = 103
    VECTOR_SPARSE_FLOAT = 104
    VECTOR_INT8 = 105


class RefineType:
    DATA_VIEW = 0
    UINT8_QUANT = 1
    FLOAT16_QUANT = 2
    BFLOAT16_QUANT = 3


# --- metric classification helpers -------------------------------------------------

# Metrics where LARGER is better (similarity); others are distances.
SIMILARITY_METRICS = frozenset({metric.IP, metric.COSINE, metric.BM25, metric.MHJACCARD})

BINARY_METRICS = frozenset(
    {metric.HAMMING, metric.JACCARD, metric.SUBSTRUCTURE, metric.SUPERSTRUCTURE}
)

DENSE_FLOAT_METRICS = frozenset({metric.L2, metric.IP, metric.COSINE})

SPARSE_METRICS = frozenset({metric.IP, metric.BM25})

MAX_SIM_METRICS = frozenset(
    {
        metric.MAX_SIM,
        metric.MAX_SIM_COSINE,
        metric.MAX_SIM_IP,
        metric.MAX_SIM_L2,
        metric.MAX_SIM_HAMMING,
        metric.MAX_SIM_JACCARD,
    }
)

DTW_METRICS = frozenset(
    {
        metric.DTW,
        metric.DTW_COSINE,
        metric.DTW_IP,
        metric.DTW_L2,
        metric.DTW_HAMMING,
        metric.DTW_JACCARD,
    }
)

EMB_LIST_METRICS = MAX_SIM_METRICS | DTW_METRICS


def is_similarity_metric(m: str) -> bool:
    return m.upper() in SIMILARITY_METRICS


def normalize_metric(m: str) -> str:
    """Metric strings are case-insensitive in the reference config loader."""
    return str(m).upper()
