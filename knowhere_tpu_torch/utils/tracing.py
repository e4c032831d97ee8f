"""Tracing (reference: include/knowhere/tracer.h, src/common/tracer.cc).

The port's one span primitive, its counters and its store.

- `span(name, wait=False, **attrs)` is on while a torch profiler runs (the
  process-wide flag the profiler sets, so on every thread) or while
  `init_telemetry` has set an exporter other than "noop". Off, it returns
  one shared no-op context after that one check: no clock read, no dict, no
  lock. On, it opens a profiler range of its name, as `record_function`
  does (a host event of the device trace, on its clock: the trace's idle
  gaps and device operations are named by it), and when it closes appends
  itself to the store, read as a record: name, span id, parent id, root id
  (the id of the outermost span open on its thread, which every span of
  one request shares), thread, `time.perf_counter_ns()` start and end,
  `wait` (the host blocks on the device there), attributes, counters and
  events. With opentelemetry installed and an exporter set, each span is
  also an OpenTelemetry span, the operator's exporter.
- `request(name, **attrs)` is the facade's root: always timed (`stop()`
  gives the seconds the latency histograms observe), a span when tracing
  is on.
- `count(name, value)` adds a host int or a device tensor to the innermost
  open span's counters when on. Device values stay on the device until the
  store is read (`get_span_log`), so the hot path never syncs. A caller
  that must compute a device value to count checks `enabled()` first.
- The store keeps the newest `STORE_LIMIT` records and counts what it drops
  (`spans_dropped`).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.autograd.profiler as _torch_profiler

try:  # optional dependency; not baked into all images
    from opentelemetry import trace as _otel_trace

    _HAS_OTEL = True
except Exception:  # pragma: no cover
    _otel_trace = None
    _HAS_OTEL = False

# The profiler range of a span: record_function's user-scope range, without
# its Python object and dispatcher calls (under half its cost under the
# profiler; torch.profiler opens its own step ranges so).
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit

STORE_LIMIT = 1 << 15  # span records kept; the oldest go first


@dataclass
class TraceConfig:
    """reference tracer.h:36-55."""

    exporter: str = "noop"  # "stdout" | "otlp" | "noop"
    sample_fraction: float = 1.0
    otlp_endpoint: str = ""
    secure: bool = False
    node_id: int = 0


_exporting = False  # init_telemetry set an exporter other than "noop"
_store: "collections.deque[_Span]" = collections.deque(maxlen=STORE_LIMIT)
_store_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def init_telemetry(cfg: TraceConfig) -> bool:
    global _exporting
    _exporting = cfg.exporter != "noop"
    return True


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _torch_profiler._is_profiler_enabled or _exporting


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open or closed span; the store holds it as it is, and
    `get_span_log` turns it into a record."""

    __slots__ = ("name", "wait", "attrs", "id", "parent", "root", "thread", "start_ns", "end_ns", "counters",
                 "events", "_range", "_otel_cm", "_otel")

    def __init__(self, name: str, wait: bool, attrs: Dict[str, Any]):
        self.name, self.wait, self.attrs = name, wait, attrs
        self.counters = self.events = self._otel = self.end_ns = None

    def __enter__(self):
        # the range opens first and closes last, so the trace names the
        # span's own bookkeeping by it
        self._range = _range_enter(self.name)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = sid = next(_ids)
        if stack:
            parent = stack[-1]
            self.parent, self.root = parent.id, parent.root
        else:
            self.parent, self.root = None, sid
        self.thread = threading.get_ident()
        stack.append(self)
        if _HAS_OTEL and _exporting:
            self._otel_cm = _otel_trace.get_tracer("knowhere_tpu_torch").start_as_current_span(self.name)
            self._otel = self._otel_cm.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.end_ns is None:  # else request.stop() ended it
            self.end_ns = time.perf_counter_ns()
        if self._otel is not None:
            _export_otel(self._otel, self)
            self._otel_cm.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        global _dropped
        with _store_lock:
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append(self)
        _range_exit(self._range)
        return False


def _export_otel(sp, span_: _Span) -> None:
    items = list(span_.attrs.items())
    items += [(f"counter.{k}", v[0]) for k, v in (span_.counters or {}).items() if not v[1]]  # host counts only
    for k, v in items:
        try:
            sp.set_attribute(k, v)
        except Exception:
            pass


def span(name: str, wait: bool = False, **attrs):
    """A span named ``name``; ``wait`` marks where the host blocks on the
    device. The shared no-op context while tracing is off."""
    if not (_torch_profiler._is_profiler_enabled or _exporting):
        return _OFF
    return _Span(name, wait, attrs)


class request:  # noqa: N801 (a context manager, named as span is)
    """The root span of one API call (reference index.cc:163-177), timed on
    the store's clock whether tracing is on or off. ``stop()`` ends the
    call's clock (the root record's end) and returns its seconds; the
    root's range stays open to the end of the with-block, so a trace names
    what the call does with them (its latency histograms) by the root."""

    __slots__ = ("_span", "_t0")

    def __init__(self, name: str, **attrs):
        self._span = span(name, **attrs)

    def set(self, cfg=None, **attrs) -> None:
        """Attributes known once the call's config is loaded; ``cfg``
        carries the caller's trace context (trace_id / span_id /
        trace_flags, tracer.h:62-67)."""
        if self._span is _OFF:
            return
        if cfg is not None and hasattr(cfg, "get"):
            for key in ("trace_id", "span_id", "trace_flags"):
                if cfg.get(key) is not None:
                    attrs[key] = cfg.get(key)
        self._span.attrs.update((k, v) for k, v in attrs.items() if v is not None)

    def __enter__(self):
        if self._span is _OFF:
            self._t0 = time.perf_counter_ns()
        else:
            self._span.__enter__()
        return self

    def stop(self) -> float:
        now = time.perf_counter_ns()
        if self._span is _OFF:
            return (now - self._t0) / 1e9
        self._span.end_ns = now
        return (now - self._span.start_ns) / 1e9

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


def count(name: str, value) -> None:
    """Add ``value`` (a host int or a device tensor) to the innermost open
    span's counter ``name``; nothing while tracing is off or no span is
    open."""
    if not (_torch_profiler._is_profiler_enabled or _exporting):
        return
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    sp = stack[-1]
    if sp.counters is None:
        sp.counters = {}
    acc = sp.counters.setdefault(name, [0, []])  # [host sum, device values]
    if isinstance(value, torch.Tensor):
        acc[1].append(value)
    else:
        acc[0] += int(value)


def _resolve(spans: List[_Span]) -> None:
    """Sum each span's device counter values on their device, one read a
    device, and fold them into the host sums (under the store's lock)."""
    by_dev: Dict[torch.device, List[tuple]] = collections.defaultdict(list)
    for sp in spans:
        for acc in (sp.counters or {}).values():
            for t in acc[1]:
                by_dev[t.device].append((acc, t))
    for pairs in by_dev.values():
        vals = torch.stack([t.reshape(()).to(torch.int64) for _, t in pairs]).tolist()
        for (acc, _), v in zip(pairs, vals):
            acc[0] += int(v)
            acc[1].clear()


def get_span_log() -> List[Dict[str, Any]]:
    """A copy of the store, oldest first: one dict a closed span (name, id,
    parent, root, thread, start_ns, end_ns, wait, attrs, counters as ints,
    events)."""
    with _store_lock:
        spans = list(_store)
        _resolve(spans)
        return [{"name": sp.name, "id": sp.id, "parent": sp.parent, "root": sp.root, "thread": sp.thread,
                 "start_ns": sp.start_ns, "end_ns": sp.end_ns, "wait": sp.wait, "attrs": dict(sp.attrs),
                 "counters": {k: v[0] for k, v in (sp.counters or {}).items()}, "events": list(sp.events or ())}
                for sp in spans]


def spans_dropped() -> int:
    """Records the store has dropped for its bound."""
    return _dropped


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
    """Attach an event to the installed root span (reference tracer.h
    AddEvent) and, while tracing is on, to this thread's innermost open
    span at `time.perf_counter_ns()`."""
    if _root_span is not None and hasattr(_root_span, "add_event"):
        try:
            _root_span.add_event(event_info)
        except Exception:
            pass
    stack = getattr(_local, "stack", None)
    if stack:
        sp = stack[-1]
        if sp.events is None:
            sp.events = []
        sp.events.append((event_info, time.perf_counter_ns()))


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
