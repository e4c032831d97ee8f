"""Index families of the port. Importing this package registers them with
the factory: FLAT and BIN_FLAT, the IVF family, the HNSW family, the SVS
names (SVS_FLAT, SVS_VAMANA with its LVQ and LeanVec stores,
HNSW_DEPRECATED), the CAGRA / cuVS names, whose registrations come after
HNSW's and IVF's (models/cagra.py imports both first), DISKANN,
DISKANN_DEPRECATED and AISAQ, the sparse family (SPARSE_INVERTED_INDEX,
SPARSE_WAND and their _CC names), SCANN_DVR, MINHASH_LSH, FAISS and the
SHARDED_* names over a device list (models/sharded.py). The emb_list
strategies (models/emb_list.py) are no index of their own: the
facade wraps FLAT, HNSW or IVF_FLAT in them for MAX_SIM_* and DTW_*."""

from . import (  # noqa: F401
    cagra,
    data_view,
    diskann,
    emb_list,
    faiss_generic,
    flat,
    hnsw,
    ivf,
    minhash,
    sharded,
    sparse,
    svs,
)
