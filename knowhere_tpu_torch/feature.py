"""Version gate, feature bitmask, and static index legality tables.

Parity with the reference:
- Version: include/knowhere/version.h:22-27 (min 0, current 8, max 11).
- feature bitmask: include/knowhere/feature.h:23-52.
- (index, datatype) legality + mmap/emb_list capability tables:
  include/knowhere/index/index_table.h:20,141,167 and
  comp/knowhere_check.h:43.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from .index_param import IndexEnum


class Version:
    MIN_VERSION = 0
    CURRENT_VERSION = 8
    MAX_VERSION = 11

    def __init__(self, version_code: int):
        self.version_code = int(version_code)

    @classmethod
    def GetMinimalVersion(cls) -> "Version":
        return cls(cls.MIN_VERSION)

    @classmethod
    def GetCurrentVersion(cls) -> "Version":
        return cls(cls.CURRENT_VERSION)

    @classmethod
    def GetMaximumVersion(cls) -> "Version":
        return cls(cls.MAX_VERSION)

    @classmethod
    def VersionSupport(cls, v: "Version") -> bool:
        return cls.MIN_VERSION <= v.version_code <= cls.MAX_VERSION

    def VersionCode(self) -> int:
        return self.version_code

    def __eq__(self, other) -> bool:
        return isinstance(other, Version) and self.version_code == other.version_code

    def __le__(self, other) -> bool:
        return self.version_code <= other.version_code

    def __repr__(self) -> str:
        return f"Version({self.version_code})"


class feature:
    """Feature bitmask (reference feature.h:23-52)."""

    BINARY = 1 << 0
    FLOAT32 = 1 << 1
    FP16 = 1 << 2
    BF16 = 1 << 3
    SPARSE_FLOAT32 = 1 << 4
    SPARSE_U32_F32 = SPARSE_FLOAT32  # reference alias (feature.h:31)
    INT8 = 1 << 5
    EMB_LIST = 1 << 6

    NO_TRAIN = 1 << 16
    KNN = 1 << 17
    GPU = 1 << 18  # kept for API parity
    MMAP = 1 << 19
    MV = 1 << 20
    DISK = 1 << 21
    LAZY_LOAD = 1 << 22
    GPU_KNN = GPU | KNN

    # reference composite aliases (feature.h:54-62)
    NONE = 0
    NO_TRAIN_INDEX = NO_TRAIN
    GPU_KNN_FLOAT_INDEX = FLOAT32 | GPU | KNN
    GPU_ANN_FLOAT_INDEX = FLOAT32 | GPU

    ALL_TYPE = BINARY | FLOAT32 | FP16 | BF16 | SPARSE_FLOAT32 | INT8
    ALL_DENSE_TYPE = BINARY | FLOAT32 | FP16 | BF16 | INT8
    ALL_DENSE_FLOAT_TYPE = FLOAT32 | FP16 | BF16


# Data-type tags used in factory keys. The reference templates on
# fp32/fp16/bf16/int8/bin1/sparse (operands.h; feature.h:23-35); we key the
# registry on these strings and map them to numpy/torch dtypes at the edges.
DATA_TYPES = ("fp32", "fp16", "bf16", "int8", "bin1", "sparse")

_DENSE_FLOAT = ("fp32", "fp16", "bf16")
_DENSE_FLOAT_INT8 = ("fp32", "fp16", "bf16", "int8")


def _pairs(name: str, types) -> Set[Tuple[str, str]]:
    return {(name, t) for t in types}


# Static (index_type, data_type) legality table (index_table.h:20+).
LEGAL_INDEX_DATATYPE: Set[Tuple[str, str]] = set()
for _n in (
    IndexEnum.INDEX_FAISS_IDMAP,
    IndexEnum.INDEX_FAISS_IVFFLAT,
    IndexEnum.INDEX_FAISS_IVFFLAT_CC,
    IndexEnum.INDEX_FAISS_IVFPQ,
    IndexEnum.INDEX_FAISS_SCANN,
    IndexEnum.INDEX_FAISS_SCANN_DVR,
    IndexEnum.INDEX_FAISS_IVFSQ8,
    IndexEnum.INDEX_FAISS_IVFSQ_CC,
    IndexEnum.INDEX_FAISS_IVFRABITQ,
    IndexEnum.INDEX_FAISS_IVFRABITQ_FASTSCAN,
    IndexEnum.INDEX_HNSW,
    IndexEnum.INDEX_HNSW_SQ,
    IndexEnum.INDEX_HNSW_PQ,
    IndexEnum.INDEX_HNSW_PRQ,
    IndexEnum.INDEX_DISKANN,
    IndexEnum.INDEX_TPU_BRUTEFORCE,
    IndexEnum.INDEX_TPU_IVFFLAT,
    IndexEnum.INDEX_TPU_IVFPQ,
    IndexEnum.INDEX_TPU_CAGRA,
):
    LEGAL_INDEX_DATATYPE |= _pairs(_n, _DENSE_FLOAT_INT8)

for _n in (
    IndexEnum.INDEX_SHARDED_FLAT,
    IndexEnum.INDEX_SHARDED_IVFFLAT,
    IndexEnum.INDEX_SHARDED_IVFSQ8,
    IndexEnum.INDEX_SHARDED_IVFPQ,
    IndexEnum.INDEX_SHARDED_HNSW,
):
    LEGAL_INDEX_DATATYPE |= _pairs(_n, ("fp32",))

LEGAL_INDEX_DATATYPE |= _pairs(IndexEnum.INDEX_FAISS_BIN_IDMAP, ("bin1",))
LEGAL_INDEX_DATATYPE |= _pairs(IndexEnum.INDEX_FAISS_BIN_IVFFLAT, ("bin1",))
LEGAL_INDEX_DATATYPE |= _pairs(IndexEnum.INDEX_HNSW, ("bin1",))
LEGAL_INDEX_DATATYPE |= _pairs(IndexEnum.INDEX_MINHASH_LSH, ("bin1",))
for _n in (
    IndexEnum.INDEX_SPARSE_INVERTED_INDEX,
    IndexEnum.INDEX_SPARSE_WAND,
    IndexEnum.INDEX_SPARSE_INVERTED_INDEX_CC,
    IndexEnum.INDEX_SPARSE_WAND_CC,
):
    LEGAL_INDEX_DATATYPE |= _pairs(_n, ("sparse",))

# Indexes that support mmap-style zero-copy load (index_table.h:141+).
MMAP_CAPABLE: Set[str] = {
    IndexEnum.INDEX_FAISS_IDMAP,
    IndexEnum.INDEX_FAISS_BIN_IDMAP,
    IndexEnum.INDEX_FAISS_IVFFLAT,
    IndexEnum.INDEX_FAISS_BIN_IVFFLAT,
    IndexEnum.INDEX_FAISS_IVFPQ,
    IndexEnum.INDEX_FAISS_IVFSQ8,
    IndexEnum.INDEX_FAISS_SCANN,
    IndexEnum.INDEX_FAISS_IVFRABITQ,
    IndexEnum.INDEX_HNSW,
    IndexEnum.INDEX_HNSW_SQ,
    IndexEnum.INDEX_HNSW_PQ,
    IndexEnum.INDEX_HNSW_PRQ,
    IndexEnum.INDEX_SPARSE_INVERTED_INDEX,
    IndexEnum.INDEX_SPARSE_WAND,
}

# Indexes that can host emb_list (multi-vector) data (index_table.h:167+).
EMB_LIST_CAPABLE: Set[str] = {
    IndexEnum.INDEX_FAISS_IDMAP,
    IndexEnum.INDEX_HNSW,
    IndexEnum.INDEX_FAISS_IVFFLAT,
}


class KnowhereCheck:
    @staticmethod
    def IndexTypeAndDataTypeCheck(index_name: str, data_type: str) -> bool:
        return (index_name, data_type) in LEGAL_INDEX_DATATYPE

    @staticmethod
    def SupportMmapIndexTypeCheck(index_name: str) -> bool:
        return index_name in MMAP_CAPABLE

    @staticmethod
    def SupportEmbListIndexTypeCheck(index_name: str) -> bool:
        return index_name in EMB_LIST_CAPABLE


def UseDiskLoad(index_type: str, version: int = 0) -> bool:
    """Whether Milvus should load this index via the disk path
    (reference src/common/utils.cc:133-146, open build without
    KNOWHERE_WITH_CARDINAL: DISKANN, MINHASH_LSH, AISAQ)."""
    return index_type in (
        IndexEnum.INDEX_DISKANN,
        IndexEnum.INDEX_MINHASH_LSH,
        IndexEnum.INDEX_AISAQ,
    )


def feature_for_datatype(data_type: str) -> int:
    return {
        "fp32": feature.FLOAT32,
        "fp16": feature.FP16,
        "bf16": feature.BF16,
        "int8": feature.INT8,
        "bin1": feature.BINARY,
        "sparse": feature.SPARSE_FLOAT32,
    }[data_type]
