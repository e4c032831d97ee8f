"""knowhere_tpu_torch — the PyTorch/CUDA port of knowhere_tpu for one NVIDIA
H100.

The same public API as the JAX package (factory / Index / DataSet /
BitsetView / BinarySet, Status codes, the KWTPU section format), with the
TPU's Pallas kernels replaced by CUDA kernels written for Hopper
(``csrc/``). It serves FLAT and BIN_FLAT, the IVF family, the HNSW family
over every dense type and bin1, the SVS, CAGRA and cuVS names, DISKANN,
DISKANN_DEPRECATED and AISAQ, the sparse family (SPARSE_INVERTED_INDEX,
SPARSE_WAND and their _CC names, IP and BM25), BruteForce (dense, binary
and sparse), feder's GetIndexMeta / GetFederVisit and the k-means Cluster
API:

    import knowhere_tpu_torch as kt
    kt.set_device("cuda")          # the default; "cpu" runs the plain versions
    idx = kt.IndexFactory.Instance().Create("IVF_FLAT").value()
    idx.Build(kt.GenDataSetFromArray(xb), {"metric_type": "L2", "nlist": 1024})
    res = idx.Search(kt.GenDataSetFromArray(xq), {"k": 10, "nprobe": 12})

The package imports torch and numpy, never JAX.
"""

from .binaryset import Binary, BinarySet  # noqa: F401
from .bitset import BitsetView  # noqa: F401
from .comp import OpContext  # noqa: F401
from .config import BaseConfig, Config, Entry, Stage, load_config  # noqa: F401
from .dataset import (  # noqa: F401
    DataSet,
    GenDataSet,
    GenDataSetFromArray,
    GenIdsDataSet,
    GenRangeResultDataSet,
    GenResultDataSet,
    GenSparseDataSet,
)
from .device import get_device, set_device  # noqa: F401
from .factory import IndexFactory, IndexStaticFaced, register_index  # noqa: F401
from .feature import KnowhereCheck, UseDiskLoad, Version, feature  # noqa: F401
from .index import Index, Interrupt  # noqa: F401
from .index_node import (  # noqa: F401
    BatchedDistanceIterator,
    IndexIterator,
    IndexNode,
    PrecomputedDistanceIterator,
)
from .index_param import (  # noqa: F401
    ClusterEnum,
    IndexEnum,
    RefineType,
    VecType,
    indexparam,
    meta,
    metric,
)
from .knowhere_config import KnowhereConfig  # noqa: F401
from .status import KnowhereException, Status, StatusCategory, expected, status_category_of  # noqa: F401

# Importing models registers the index families with the factory.
from . import models  # noqa: F401  isort: skip
from .brute_force import BruteForce  # noqa: F401  isort: skip
from .cluster import Cluster, ClusterFactory  # noqa: F401  isort: skip

__version__ = "0.1.0"
