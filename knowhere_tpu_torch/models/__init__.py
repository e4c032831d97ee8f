"""Index families of the port. Importing this package registers them with
the factory: FLAT, the IVF family (IVF_FLAT, IVF_PQ, IVF_SQ8, IVF_RABITQ) and
the HNSW family (HNSW, HNSW_SQ, HNSW_PQ, HNSW_PRQ)."""

from . import flat, hnsw, ivf  # noqa: F401
