"""Tracing (reference: include/knowhere/tracer.h, src/common/tracer.cc).

Span-per-API with config-carried trace context (trace_id/span_id/trace_flags
fields on BaseConfig, tracer.h:62-67). Uses opentelemetry-sdk when installed;
otherwise a no-op context manager with the same surface, plus an in-process
span log for tests.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

try:  # optional dependency; not baked into all images
    from opentelemetry import trace as _otel_trace

    _HAS_OTEL = True
except Exception:  # pragma: no cover
    _otel_trace = None
    _HAS_OTEL = False


@dataclass
class TraceConfig:
    """reference tracer.h:36-55."""

    exporter: str = "noop"  # "stdout" | "otlp" | "noop"
    sample_fraction: float = 1.0
    otlp_endpoint: str = ""
    secure: bool = False
    node_id: int = 0


_trace_cfg = TraceConfig()
_span_log: List[Dict[str, Any]] = []
_span_log_lock = threading.Lock()
_SPAN_LOG_LIMIT = 1024


def init_telemetry(cfg: TraceConfig) -> bool:
    global _trace_cfg
    _trace_cfg = cfg
    return True


@contextlib.contextmanager
def span(name: str, cfg=None, **attributes):
    """Open a span carrying search attributes (reference index.cc:163-177)."""
    attrs = {k: v for k, v in attributes.items() if v is not None}
    if cfg is not None:
        for key in ("trace_id", "span_id", "trace_flags"):
            v = cfg.get(key) if hasattr(cfg, "get") else None
            if v is not None:
                attrs[key] = v
    t0 = time.perf_counter()
    if _HAS_OTEL and _trace_cfg.exporter != "noop":
        tracer = _otel_trace.get_tracer("knowhere_tpu_torch")
        with tracer.start_as_current_span(name) as sp:
            for k, v in attrs.items():
                try:
                    sp.set_attribute(k, v)
                except Exception:
                    pass
            yield sp
    else:
        yield None
    with _span_log_lock:
        _span_log.append({"name": name, "elapsed": time.perf_counter() - t0, **attrs})
        if len(_span_log) > _SPAN_LOG_LIMIT:
            del _span_log[: len(_span_log) - _SPAN_LOG_LIMIT]


def get_span_log() -> List[Dict[str, Any]]:
    with _span_log_lock:
        return list(_span_log)


class TimeRecorder:
    """RAII-style elapsed timer (reference comp/time_recorder.h:19)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.start = time.perf_counter()
        self.last = self.start

    def record(self, msg: str = "") -> float:
        now = time.perf_counter()
        span_s = now - self.last
        self.last = now
        return span_s

    def elapsed(self) -> float:
        return time.perf_counter() - self.start


# --- reference-cased helpers (tracer.h:36-80) ---------------------------------

_root_span = None


def initTelemetry(cfg: TraceConfig) -> bool:  # noqa: N802 (reference casing)
    return init_telemetry(cfg)


def SetRootSpan(span_obj) -> None:  # noqa: N802
    """Install a process-root span context (reference tracer.h SetRootSpan —
    Milvus sets one span per request and knowhere parents API spans on it)."""
    global _root_span
    _root_span = span_obj


def CloseRootSpan() -> None:  # noqa: N802
    global _root_span
    if _root_span is not None and hasattr(_root_span, "end"):
        try:
            _root_span.end()
        except Exception:
            pass
    _root_span = None


def AddEvent(event_info: str) -> None:  # noqa: N802
    """Attach an event to the root span (reference tracer.h AddEvent)."""
    if _root_span is not None and hasattr(_root_span, "add_event"):
        try:
            _root_span.add_event(event_info)
            return
        except Exception:
            pass
    with _span_log_lock:
        _span_log.append({"event": event_info, "ts": time.time()})
        del _span_log[:-_SPAN_LOG_LIMIT]


EMPTY_TRACE_ID = bytes(16)
EMPTY_SPAN_ID = bytes(8)


def EmptyTraceID(ctx) -> bool:  # noqa: N802
    tid = getattr(ctx, "traceID", None) or (ctx.get("trace_id") if isinstance(ctx, dict) else None)
    return not tid or bytes(tid) == EMPTY_TRACE_ID


def EmptySpanID(ctx) -> bool:  # noqa: N802
    sid = getattr(ctx, "spanID", None) or (ctx.get("span_id") if isinstance(ctx, dict) else None)
    return not sid or bytes(sid) == EMPTY_SPAN_ID


def BytesToHexStr(data: bytes) -> str:  # noqa: N802
    return bytes(data).hex()


def GetIDFromHexStr(hex_str: str) -> bytes:  # noqa: N802
    return bytes.fromhex(hex_str)
