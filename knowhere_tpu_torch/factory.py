"""IndexFactory — registry keyed by (index name, data type).

Parity with the reference factory + registration macros + static-method facade
(reference: include/knowhere/index/index_factory.h:29-165,
src/index/index_factory.cc:29-384, include/knowhere/index/index_static.h:53-92).

Registration is a decorator:

    @register_index(IndexEnum.INDEX_FAISS_IDMAP, ("fp32","fp16","bf16","int8"),
                    feature.ALL_DENSE_TYPE | feature.MMAP | feature.KNN)
    class FlatIndexNode(IndexNode): ...

The reference's KNOWHERE_MOCK_REGISTER (fp16/bf16 via fp32 conversion wrapper,
index_node_data_mock_wrapper.h) is unnecessary here: low-precision
registrations bind the same node class with a dtype tag.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple, Type

from .feature import Version, feature
from .index_node import IndexNode
from .status import KnowhereException, Status, expected


class IndexFactory:
    _instance: Optional["IndexFactory"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        # (name, data_type) -> (node_cls_or_fn, feature_mask)
        self._registry: Dict[Tuple[str, str], Tuple[Callable[..., IndexNode], int]] = {}
        self._features: Dict[str, int] = {}

    @classmethod
    def Instance(cls) -> "IndexFactory":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    def Register(
        self,
        name: str,
        data_type: str,
        ctor: Callable[..., IndexNode],
        features: int = 0,
    ) -> None:
        self._registry[(name, data_type)] = (ctor, features)
        self._features[name] = self._features.get(name, 0) | features

    def HasIndex(self, name: str, data_type: str = "fp32") -> bool:
        return (name, data_type) in self._registry

    def GetIndexFeatures(self) -> Dict[str, int]:
        return dict(self._features)

    def FeatureCheck(self, name: str, flag: int) -> bool:
        return bool(self._features.get(name, 0) & flag)

    def Create(
        self,
        name: str,
        version: Optional[int] = None,
        object: Any = None,  # noqa: A002  (DI pack, e.g. FileManager for DISKANN)
        data_type: str = "fp32",
    ) -> "expected":
        from .index import Index

        if version is None:
            version = Version.GetCurrentVersion().VersionCode()
        if not Version.VersionSupport(Version(version)):
            return expected.Err(
                Status.invalid_args, f"unsupported index version {version}"
            )
        key = (name, data_type)
        if key not in self._registry:
            return expected.Err(
                Status.invalid_index_error,
                f"index type '{name}' not registered for data type '{data_type}'",
            )
        ctor, _feat = self._registry[key]
        try:
            node = ctor(version=version, object=object)
            node.data_type = data_type
        except KnowhereException as e:
            return expected.Err(e.status, e.message)
        return expected.Ok(Index(node))


def register_index(name: str, data_types, features: int = 0, ctor=None):
    """Class decorator: register an IndexNode class for the given data types
    (reference KNOWHERE_SIMPLE_REGISTER_GLOBAL, index_factory.h:87-103)."""

    def deco(cls: Type[IndexNode]):
        factory = IndexFactory.Instance()

        def make(version: int, object: Any = None, _cls=cls, _name=name):  # noqa: A002
            node = _cls(version=version, object=object)
            node.index_type = _name
            return node

        for dt in data_types:
            factory.Register(name, dt, ctor or make, features)
        return cls

    return deco


# ---------------------------------------------------------------------------
# IndexStaticFaced (reference index_static.h:53-92): per-index-type statics
# usable without building an instance.
# ---------------------------------------------------------------------------


class IndexStaticFaced:
    """Static per-index-type functions: ConfigCheck / EstimateLoadResource /
    HasRawData. Dispatches on the registered node class's statics."""

    @staticmethod
    def ConfigCheck(name: str, data_type: str, json_cfg: dict) -> Status:
        from .config import Config, Stage

        factory = IndexFactory.Instance()
        key = (name, data_type)
        if key not in factory._registry:
            return Status.invalid_index_error
        ctor, _ = factory._registry[key]
        node = ctor(version=Version.GetCurrentVersion().VersionCode())
        cfg = node.CreateConfig()
        st, _msg = Config.load(cfg, json_cfg, Stage.STATIC)
        return st

    @staticmethod
    def EstimateLoadResource(
        name: str, data_type: str, file_size_gb: float, json_cfg: dict
    ) -> "expected[dict]":
        """Predict {memory_gb, disk_gb} needed to load (index_static.h:79-90).

        Default model: memory-resident indexes need ~file size in device/host RAM;
        mmap-enabled loads keep most of it on disk; DISKANN keeps PQ+cache in
        memory and the rest on disk.
        """
        enable_mmap = bool(json_cfg.get("enable_mmap", False))
        from .index_param import IndexEnum

        if name == IndexEnum.INDEX_DISKANN:
            mem = file_size_gb * 0.25
            disk = file_size_gb
        elif enable_mmap:
            mem = file_size_gb * 0.1
            disk = file_size_gb
        else:
            mem = file_size_gb
            disk = 0.0
        return expected.Ok({"memory_gb": mem, "disk_gb": disk})

    @staticmethod
    def CreateConfig(name: str, data_type: str = "fp32", version: Optional[int] = None):
        """Instance-free config construction (reference index_static.h
        StaticCreateConfig); returns None for unknown index names."""
        factory = IndexFactory.Instance()
        key = (name, data_type)
        if key not in factory._registry:
            return None
        ctor, _ = factory._registry[key]
        node = ctor(version=version or Version.GetCurrentVersion().VersionCode())
        return node.CreateConfig()

    @staticmethod
    def HasRawData(name: str, data_type: str, version: int, json_cfg: dict) -> bool:
        """Instance-free raw-data predicate (reference index_static.h:53-92
        StaticHasRawData): answers from the index TYPE + build config without
        constructing/loading the index."""
        factory = IndexFactory.Instance()
        key = (name, data_type)
        if key not in factory._registry:
            return False
        ctor, _ = factory._registry[key]
        node = ctor(version=version)
        cfg = json_cfg or {}
        metric = cfg.get("metric_type", "L2")
        try:
            if hasattr(node, "StaticHasRawData"):
                return bool(node.StaticHasRawData(cfg))
            # reference SCANN static check consults with_raw_data from the config
            if hasattr(node, "_refine_cfg") and cfg.get("with_raw_data") is not None:
                node._refine_cfg = "raw" if cfg.get("with_raw_data") else None
            return bool(node.HasRawData(metric))
        except Exception:
            return False

