"""Index families of the port. Importing this package registers them with
the factory: FLAT and BIN_FLAT, the IVF family, the HNSW family, the SVS
names (SVS_FLAT, SVS_VAMANA with its LVQ and LeanVec stores,
HNSW_DEPRECATED), the CAGRA / cuVS names, whose registrations come after
HNSW's and IVF's (models/cagra.py imports both first), DISKANN,
DISKANN_DEPRECATED and AISAQ, and the sparse family (SPARSE_INVERTED_INDEX,
SPARSE_WAND and their _CC names)."""

from . import cagra, diskann, flat, hnsw, ivf, sparse, svs  # noqa: F401
