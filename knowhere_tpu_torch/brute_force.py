"""BruteForce — index-free exact search, the recall oracle (counterpart of
knowhere_tpu/brute_force.py).

The reference's static API (include/knowhere/comp/brute_force.h:29-66):
Search / SearchWithBuf / RangeSearch / AnnIterator and the multi-chunk
SearchOnChunkWithBuf / AnnIteratorOnChunk, over dense float data with
L2/IP/COSINE and over binary data (uint8 rows, eight bits a byte, LSB
first) with HAMMING/JACCARD/SUBSTRUCTURE/SUPERSTRUCTURE. The base goes to
the device once a call (binary rows and queries unpacked to {0,1} planes)
and is streamed through the tiled kNN scan (ops/topk.py) or the tiled range
scan (ops/range.py); the iterators score full distance rows on the device.

Sparse bases (IP and BM25) go to models/sparse.py, through SearchSparse or
Search / RangeSearch / AnnIterator on a sparse dataset: host scipy
products, as in the reference. The multi-chunk calls take dense chunks only
and answer not_implemented for a sparse one (the reference raises a
TypeError there, an internal_error).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .bitset import BitsetView
from .config import BruteForceConfig, Config, Stage
from .dataset import DataSet, GenResultDataSet
from .device import to_device
from .index_node import PrecomputedDistanceIterator
from .index_param import BINARY_METRICS, DENSE_FLOAT_METRICS, normalize_metric
from .models.flat import precomputed_iterators, range_result
from .models.sparse import (
    brute_force_ann_iterator_sparse,
    brute_force_range_search_sparse,
    brute_force_search_sparse,
)
from .ops import distances as D
from .ops import topk as T
from .status import KnowhereException, Status, expected, guarded_call, guarded_expected

_NO_SPARSE = "the multi-chunk BruteForce calls take dense chunks, not sparse ones"


def _check(base_ds: DataSet, metric: str) -> Optional[KnowhereException]:
    """The error a call over ``base_ds`` with ``metric`` answers, or None."""
    if base_ds.is_sparse:
        return KnowhereException(_NO_SPARSE, Status.not_implemented)
    is_bin_data = np.asarray(base_ds.tensor).dtype == np.uint8
    if metric in BINARY_METRICS:
        if not is_bin_data:
            return KnowhereException(f"binary metric {metric} requires packed uint8 data", Status.invalid_metric_type)
        return None
    if metric not in DENSE_FLOAT_METRICS:
        return KnowhereException(f"metric {metric} not supported by BruteForce", Status.invalid_metric_type)
    if is_bin_data:
        return KnowhereException(f"metric {metric} not valid for binary data", Status.invalid_metric_type)
    return None


def _load(json_cfg, stage: Stage, base_ds: DataSet):
    """(cfg, metric) or raises the call's error."""
    cfg = BruteForceConfig()
    st, msg = Config.load(cfg, json_cfg or {}, stage)
    if st != Status.success:
        raise KnowhereException(msg, st)
    metric = normalize_metric(cfg.metric_type)
    err = _check(base_ds, metric)
    if err is not None:
        raise err
    return cfg, metric


def _prep(base_ds: DataSet, query_ds: DataSet, metric: str):
    """(queries on the host, the base's rows on the device): f32 rows, or
    for a binary metric both unpacked to {0,1} planes of base_ds.dim bits."""
    xb, xq = np.asarray(base_ds.tensor), np.asarray(query_ds.tensor)
    if metric in BINARY_METRICS:
        bits = base_ds.dim
        return D.unpack_bits_host(xq.view(np.uint8), bits), to_device(D.unpack_bits_host(xb.view(np.uint8), bits))
    return np.asarray(xq, dtype=np.float32), to_device(np.asarray(xb, dtype=np.float32))


class BruteForce:
    @staticmethod
    def Search(
        base_dataset: DataSet,
        query_dataset: DataSet,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[DataSet]":
        def impl():
            if base_dataset.is_sparse:
                return brute_force_search_sparse(base_dataset, query_dataset, json_cfg or {}, bitset)
            cfg, metric = _load(json_cfg, Stage.SEARCH, base_dataset)
            xq, b_dev = _prep(base_dataset, query_dataset, metric)
            mask = bitset.device_mask(base_dataset.rows) if bitset and not bitset.empty_view() else None
            ids, dists = T.knn_search(xq, b_dev, cfg.k, metric, bitset_mask=mask, aux=D.base_aux(metric, b_dev))
            return expected.Ok(GenResultDataSet(query_dataset.rows, cfg.k, ids, dists))

        return guarded_expected(impl)

    @staticmethod
    def SearchWithBuf(
        base_dataset: DataSet,
        query_dataset: DataSet,
        ids_buf: np.ndarray,
        dist_buf: np.ndarray,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> Status:
        res = BruteForce.Search(base_dataset, query_dataset, json_cfg, bitset)
        if not res.has_value():
            return res.error()
        np.copyto(np.asarray(ids_buf).reshape(-1), res.value().ids)
        np.copyto(np.asarray(dist_buf).reshape(-1), res.value().distance)
        return Status.success

    @staticmethod
    def RangeSearch(
        base_dataset: DataSet,
        query_dataset: DataSet,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[DataSet]":
        def impl():
            if base_dataset.is_sparse:
                return brute_force_range_search_sparse(base_dataset, query_dataset, json_cfg or {}, bitset)
            cfg, metric = _load(json_cfg, Stage.RANGE_SEARCH, base_dataset)
            xq, b_dev = _prep(base_dataset, query_dataset, metric)
            mask = bitset.device_mask(base_dataset.rows) if bitset and not bitset.empty_view() else None
            return expected.Ok(range_result(xq, b_dev, cfg, metric, mask))

        return guarded_expected(impl)

    @staticmethod
    def AnnIterator(
        base_dataset: DataSet,
        query_dataset: DataSet,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[list]":
        """Per-query exact-distance iterators (PrecomputedDistanceIterator);
        each holds its query's nb-float distance row on the host."""

        def impl():
            if base_dataset.is_sparse:
                return brute_force_ann_iterator_sparse(base_dataset, query_dataset, json_cfg or {}, bitset)
            _, metric = _load(json_cfg, Stage.ITERATOR, base_dataset)
            keep = bitset.host_mask(base_dataset.rows) if bitset and not bitset.empty_view() else None
            return expected.Ok(precomputed_iterators(*_prep(base_dataset, query_dataset, metric), metric, keep))

        return guarded_expected(impl)

    @staticmethod
    def SearchSparse(
        base_dataset: DataSet,
        query_dataset: DataSet,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[DataSet]":
        """The named sparse entry point (reference brute_force.h:50-57);
        Search routes a sparse base to the same implementation."""

        def impl():
            if not base_dataset.is_sparse:
                return expected.Err(Status.invalid_args, "SearchSparse requires a sparse dataset")
            return brute_force_search_sparse(base_dataset, query_dataset, json_cfg or {}, bitset)

        return guarded_expected(impl)

    @staticmethod
    def SearchSparseWithBuf(
        base_dataset: DataSet,
        query_dataset: DataSet,
        ids_buf: np.ndarray,
        dist_buf: np.ndarray,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> Status:
        res = BruteForce.SearchSparse(base_dataset, query_dataset, json_cfg, bitset)
        if not res.has_value():
            return res.error()
        np.copyto(np.asarray(ids_buf).reshape(-1), res.value().ids)
        np.copyto(np.asarray(dist_buf).reshape(-1), res.value().distance)
        return Status.success

    @staticmethod
    def SearchOnChunkWithBuf(
        chunk_datasets: list,
        query_dataset: DataSet,
        ids_buf: np.ndarray,
        dist_buf: np.ndarray,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> Status:
        """Exact top-k over a multi-chunk base, written into the caller's
        buffers (reference brute_force.h:38-42). Ids are global over the
        concatenated chunk rows; the bitset indexes that space. Each chunk
        gives its own top-k, merged on the host: the (nq, total rows)
        distance matrix is never built."""

        def impl() -> Status:
            cfg = BruteForceConfig()
            st, _ = Config.load(cfg, json_cfg or {}, Stage.SEARCH)
            if st != Status.success:
                return st
            metric = normalize_metric(cfg.metric_type)
            for ds in chunk_datasets:
                err = _check(ds, metric)
                if err is not None:
                    raise err
            k, nq = int(cfg.k), query_dataset.rows
            total = sum(ds.rows for ds in chunk_datasets)
            keep = bitset.host_mask(total) if bitset and not bitset.empty_view() else None
            larger = D.larger_is_better(metric)
            part_ids, part_d = [], []
            row0 = 0
            for ds in chunk_datasets:
                xq, b_dev = _prep(ds, query_dataset, metric)
                mask = to_device(keep[row0 : row0 + ds.rows]) if keep is not None else None
                ids_c, d_c = T.knn_search(
                    xq, b_dev, min(k, ds.rows), metric, bitset_mask=mask, aux=D.base_aux(metric, b_dev)
                )
                part_ids.append(np.where(ids_c >= 0, ids_c + row0, -1))
                part_d.append(d_c)
                row0 += ds.rows
            cat_i = np.concatenate(part_ids, axis=1)
            key = np.where(cat_i < 0, -np.inf if larger else np.inf, np.concatenate(part_d, axis=1))
            order = np.argsort(-key if larger else key, axis=1, kind="stable")[:, :k]
            d_top = np.take_along_axis(key, order, axis=1)
            ids = np.where(np.isfinite(d_top), np.take_along_axis(cat_i, order, axis=1), -1)
            kk = min(k, cat_i.shape[1])
            out_i = np.full((nq, k), -1, np.int64)
            out_d = np.full((nq, k), -np.inf if larger else np.inf, np.float32)
            out_i[:, :kk] = ids[:, :kk]
            out_d[:, :kk] = d_top[:, :kk]
            np.copyto(np.asarray(ids_buf).reshape(nq, k), out_i)
            np.copyto(np.asarray(dist_buf).reshape(nq, k), out_d)
            return Status.success

        return guarded_call(impl)

    @staticmethod
    def AnnIteratorOnChunk(
        chunk_datasets: list,
        query_dataset: DataSet,
        json_cfg: Optional[dict] = None,
        bitset: Optional[BitsetView] = None,
    ) -> "expected[list]":
        """Iterators over a multi-chunk base: each query's distance row is
        the concatenation of its rows to every chunk, ids global over the
        concatenated rows, the bitset indexing that space."""

        def impl():
            cfg = BruteForceConfig()
            st, msg = Config.load(cfg, json_cfg or {}, Stage.ITERATOR)
            if st != Status.success:
                return expected.Err(st, msg)
            metric = normalize_metric(cfg.metric_type)
            for ds in chunk_datasets:
                err = _check(ds, metric)
                if err is not None:
                    raise err
            total = sum(ds.rows for ds in chunk_datasets)
            keep = bitset.host_mask(total) if bitset and not bitset.empty_view() else None
            dmats = []
            for ds in chunk_datasets:
                xq, b_dev = _prep(ds, query_dataset, metric)
                dmats.append(D.pairwise_distance(metric, to_device(xq), b_dev, D.base_aux(metric, b_dev)).cpu().numpy())
            dmat = np.concatenate(dmats, axis=1)
            larger = D.larger_is_better(metric)
            return expected.Ok([PrecomputedDistanceIterator(row, keep, larger) for row in dmat])

        return guarded_expected(impl)
