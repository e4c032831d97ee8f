"""Prometheus-style metrics (reference: include/knowhere/prometheus_client.h,
src/common/prometheus_client.cc; per-index latency histograms cached per node,
index_node.h:328-360; observed at the facade, index.cc:91-95,179-185).

Uses prometheus_client when available; otherwise falls back to an in-process
registry with the same observation API so the facade never branches.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

try:
    import prometheus_client as _prom

    _HAS_PROM = True
except Exception:  # pragma: no cover - baked-in envs may lack it
    _prom = None
    _HAS_PROM = False

_lock = threading.Lock()

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30, 60, 300, 600)


class _FallbackHistogram:
    """Counts and sums per bucket (upper bounds ``_BUCKETS``, then +Inf), as
    a Prometheus histogram keeps them: its size does not grow with the
    observations."""

    def __init__(self) -> None:
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.sums = [0.0] * (len(_BUCKETS) + 1)

    def observe(self, v: float) -> None:
        b = bisect.bisect_left(_BUCKETS, v)
        self.counts[b] += 1
        self.sums[b] += v


class _Registry:
    def __init__(self) -> None:
        self._hists: Dict[str, object] = {}

    def histogram(self, name: str, desc: str, labels=()):
        with _lock:
            if name not in self._hists:
                if _HAS_PROM:
                    self._hists[name] = _prom.Histogram(
                        name, desc, labelnames=labels, buckets=_BUCKETS
                    )
                else:
                    self._hists[name] = defaultdict(_FallbackHistogram)
            return self._hists[name]


_registry = _Registry()


def _observe(metric_name: str, desc: str, index_type: str, value: float) -> None:
    h = _registry.histogram(metric_name, desc, labels=("index_type",) if index_type else ())
    if _HAS_PROM:
        (h.labels(index_type=index_type) if index_type else h).observe(value)
    else:
        h[index_type].observe(value)


def observe_build_latency(index_type: str, seconds: float) -> None:
    _observe("knowhere_torch_build_latency_seconds", "index build latency", index_type, seconds)


def observe_load_latency(index_type: str, seconds: float) -> None:
    _observe("knowhere_torch_load_latency_seconds", "index load latency", index_type, seconds)


def observe_search_latency(index_type: str, seconds: float) -> None:
    _observe("knowhere_torch_search_latency_seconds", "knn search latency", index_type, seconds)


def observe_range_search_latency(index_type: str, seconds: float) -> None:
    _observe("knowhere_torch_range_search_latency_seconds", "range search latency", index_type, seconds)


def observe_topk(k: int) -> None:
    _observe("knowhere_torch_search_topk", "requested topk", "", float(k))


def get_fallback_buckets(metric_name: str, index_type: str) -> Tuple[List[int], List[float]]:
    """Test hook: (counts, sums) per bucket when prometheus_client is absent."""
    h = _registry._hists.get(metric_name)
    if h is None or _HAS_PROM:
        return [], []
    return list(h[index_type].counts), list(h[index_type].sums)


def get_observation_count(metric_name: str, index_type: str) -> int:
    """Observation count for a histogram, in either backend (test hook)."""
    h = _registry._hists.get(metric_name)
    if h is None:
        return 0
    if not _HAS_PROM:
        return sum(h[index_type].counts)
    for s in h.collect()[0].samples:
        if s.name.endswith("_count") and s.labels.get("index_type", index_type) == index_type:
            return int(s.value)
    return 0
