"""Cluster API: standalone k-means Train / Assign / GetCentroids
(counterpart of knowhere_tpu/cluster.py).

Parity with the reference Cluster<ClusterNode> / ClusterFactory
(reference: include/knowhere/cluster/cluster_node.h:29-34,
src/cluster/cluster.cc, src/cluster/cluster_factory.cc,
src/cluster/kmeans/faiss_kmeans.cc; config keys num_clusters / num_iter from
src/cluster/kmeans/kmeans_config.h). Lloyd runs on the port's device
(ops/kmeans.py: the reference's seeded host sampling, each cluster's rows
summed in row order, so a Train repeats its bits).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from .config import BaseConfig, Config, Entry, Stage
from .dataset import DataSet, GenDataSetFromArray, GenIdsDataSet, GenTensorDataSet
from .index_param import ClusterEnum
from .ops.kmeans import assign_rows, kmeans
from .status import Status, expected, guarded_expected


class KmeansConfig(BaseConfig):
    num_clusters = Entry(int, default=48, range=(1, 1024 * 1024), stages=[Stage.CLUSTER])
    num_iter = Entry(int, default=12, range=(1, 50), stages=[Stage.CLUSTER])


class ClusterNode:
    def Train(self, dataset: DataSet, cfg: Config) -> "expected[DataSet]":
        raise NotImplementedError

    def Assign(self, dataset: DataSet) -> "expected[DataSet]":
        raise NotImplementedError

    def Type(self) -> str:
        raise NotImplementedError

    @staticmethod
    def CreateConfig() -> Config:
        return KmeansConfig()


class KmeansClusterNode(ClusterNode):
    """Lloyd k-means on the device (faiss_kmeans.cc behaviour: Train returns
    the centroid dataset, Assign maps rows to centroid ids, training again
    with another (k, dim) is rejected)."""

    def __init__(self) -> None:
        self._centroids: Optional[np.ndarray] = None

    def Train(self, dataset: DataSet, cfg: Config) -> "expected[DataSet]":
        if cfg.get("num_clusters") is None:
            return expected.Err(Status.invalid_param_in_json, "kmeans num_clusters is empty")
        k = int(cfg.num_clusters)
        x = np.asarray(dataset.tensor, dtype=np.float32)
        if self._centroids is not None and (
            self._centroids.shape[0] != k or self._centroids.shape[1] != x.shape[1]
        ):
            return expected.Err(
                Status.cluster_inner_error,
                "train called again with different params",
            )
        centroids, _assign = kmeans(x, k, n_iters=int(cfg.num_iter))
        self._centroids = centroids
        return expected.Ok(GenDataSetFromArray(centroids))

    def Assign(self, dataset: DataSet) -> "expected[DataSet]":
        if self._centroids is None:
            return expected.Err(Status.empty_index, "kmeans not trained")
        x = np.asarray(dataset.tensor, dtype=np.float32)
        ids = assign_rows(x, self._centroids).astype(np.int64)
        return expected.Ok(GenIdsDataSet(ids))

    def Type(self) -> str:
        return ClusterEnum.CLUSTER_KMEANS


class Cluster:
    """Facade (reference include/knowhere/cluster/cluster.h)."""

    def __init__(self, node: ClusterNode):
        self._node = node

    def Train(self, dataset: DataSet, json_cfg: Optional[Dict[str, Any]] = None) -> "expected[DataSet]":
        def impl():
            cfg = self._node.CreateConfig()
            st, msg = Config.load(cfg, json_cfg or {}, Stage.CLUSTER)
            if st != Status.success:
                return expected.Err(st, msg)
            return self._node.Train(dataset, cfg)

        return guarded_expected(impl)

    def Assign(self, dataset: DataSet) -> "expected[DataSet]":
        return guarded_expected(lambda: self._node.Assign(dataset))

    def GetCentroids(self) -> "expected[DataSet]":
        """Trained centroids without re-running Train (reference
        cluster.h GetCentroids)."""

        def impl():
            c = getattr(self._node, "_centroids", None)
            if c is None:
                return expected.Err(Status.empty_index, "cluster not trained")
            c = np.asarray(c)
            return expected.Ok(GenTensorDataSet(c, c.shape[0], c.shape[1]))

        return guarded_expected(impl)

    def Type(self) -> str:
        return self._node.Type()


class ClusterFactory:
    _instance = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._registry = {ClusterEnum.CLUSTER_KMEANS: KmeansClusterNode}

    @classmethod
    def Instance(cls) -> "ClusterFactory":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    def Create(self, name: str = ClusterEnum.CLUSTER_KMEANS) -> "expected[Cluster]":
        node_cls = self._registry.get(name)
        if node_cls is None:
            return expected.Err(Status.invalid_cluster_error, f"unknown cluster type {name}")
        return expected.Ok(Cluster(node_cls()))
