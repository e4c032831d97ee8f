"""Misc runtime components.

Parity targets:
- OpContext + cooperative cancellation (reference include/knowhere/context.h:
  33-41 — checkCancellation raises inside per-query tasks; here the check
  points sit between device dispatches of batched searches).
- BloomFilter (comp/bloomfilter.h:23), FairRWLock (comp/rw_lock.h:20),
  BlockingQueue (comp/blocking_queue.h), TimeRecorder (comp/time_recorder.h,
  re-exported from utils.tracing).
- Thread-pool exec helpers (comp/task.h ExecOverSearchThreadPool /
  WaitAllSuccess): on the device the per-query fan-out is the batch axis, so
  the pools here exist for host-side concurrency (async builds, IO overlap).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import queue
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np

from .status import KnowhereException, Status
from .utils.tracing import TimeRecorder  # noqa: F401  (re-export)


class CancellationToken:
    def __init__(self) -> None:
        self._evt = threading.Event()

    def cancel(self) -> None:
        self._evt.set()

    def is_cancellation_requested(self) -> bool:
        return self._evt.is_set()


class OpContext:
    """Per-operation context carrying a cancellation token (context.h:33-41)."""

    def __init__(self) -> None:
        self.cancellation_token = CancellationToken()

    def cancel(self) -> None:
        self.cancellation_token.cancel()


def check_cancellation(op_context: Optional[OpContext]) -> None:
    """Raise (-> Status.timeout at the facade) if the op was cancelled."""
    if op_context is not None and op_context.cancellation_token.is_cancellation_requested():
        raise KnowhereException("operation cancelled", Status.timeout)


# --- mid-operation cancellation ---------------------------------------------
# The reference checks the token INSIDE every per-query task (ivf.cc:962).
# Searches here are batched device dispatches, so the equivalent check points
# sit between chunk dispatches / expansion rounds. The facade installs the
# op's context in a thread-local scope; hot loops call
# check_current_cancellation() at their chunk boundaries.
_op_ctx_tls = threading.local()


class op_context_scope:
    """Install `ctx` as the current thread's operation context."""

    def __init__(self, ctx: Optional[OpContext]):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_op_ctx_tls, "ctx", None)
        _op_ctx_tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _op_ctx_tls.ctx = self._prev
        return False


def check_current_cancellation() -> None:
    """Cancellation check for hot-loop chunk boundaries (ivf.cc:962 analog)."""
    check_cancellation(getattr(_op_ctx_tls, "ctx", None))


class BloomFilter:
    """Double-hashed Bloom filter (reference comp/bloomfilter.h)."""

    def __init__(self, capacity: int, false_positive_prob: float = 0.01):
        import math

        capacity = max(capacity, 1)
        p = min(max(false_positive_prob, 1e-9), 0.999)
        m = int(-capacity * math.log(p) / (math.log(2) ** 2)) + 1
        self.n_bits = max(64, m)
        self.n_hashes = max(1, int(round(m / capacity * math.log(2))))
        self._bits = np.zeros((self.n_bits + 7) // 8, dtype=np.uint8)

    def _hashes(self, key: bytes) -> List[int]:
        h = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(h[:8], "little")
        h2 = int.from_bytes(h[8:], "little") | 1
        return [(h1 + i * h2) % self.n_bits for i in range(self.n_hashes)]

    def add(self, key) -> None:
        kb = key if isinstance(key, bytes) else str(key).encode()
        for pos in self._hashes(kb):
            self._bits[pos >> 3] |= 1 << (pos & 7)

    def __contains__(self, key) -> bool:
        kb = key if isinstance(key, bytes) else str(key).encode()
        return all(self._bits[p >> 3] & (1 << (p & 7)) for p in self._hashes(kb))


class FairRWLock:
    """Writer-preference RW lock (reference comp/rw_lock.h:20)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._readers_ok = threading.Condition(self._lock)
        self._writers_ok = threading.Condition(self._lock)
        self._readers = 0
        self._writers = 0
        self._waiting_writers = 0

    def acquire_read(self) -> None:
        with self._lock:
            while self._writers or self._waiting_writers:
                self._readers_ok.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._lock:
            self._readers -= 1
            if self._readers == 0:
                self._writers_ok.notify()

    def acquire_write(self) -> None:
        with self._lock:
            self._waiting_writers += 1
            while self._readers or self._writers:
                self._writers_ok.wait()
            self._waiting_writers -= 1
            self._writers = 1

    def release_write(self) -> None:
        with self._lock:
            self._writers = 0
            self._writers_ok.notify()
            self._readers_ok.notify_all()


class BlockingQueue(queue.Queue):
    """reference comp/blocking_queue.h — stdlib queue already blocks; kept as
    a named type for API parity."""


# --- thread-pool exec helpers (comp/task.h analogs) -------------------------

_search_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_build_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _get_pool(which: str) -> concurrent.futures.ThreadPoolExecutor:
    global _search_pool, _build_pool
    with _pool_lock:
        if which == "search":
            if _search_pool is None:
                _search_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="kw-search"
                )
            return _search_pool
        if _build_pool is None:
            _build_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="kw-build"
            )
        return _build_pool


def exec_over_search_pool(fns: Iterable[Callable]) -> List[concurrent.futures.Future]:
    pool = _get_pool("search")
    return [pool.submit(fn) for fn in fns]


def exec_over_build_pool(fns: Iterable[Callable]) -> List[concurrent.futures.Future]:
    pool = _get_pool("build")
    return [pool.submit(fn) for fn in fns]


def wait_all_success(futures: List[concurrent.futures.Future]) -> Status:
    """reference WaitAllSuccess (comp/task.h:40-57): first failure wins."""
    worst = Status.success
    for f in futures:
        try:
            res = f.result()
            if isinstance(res, Status) and res != Status.success and worst == Status.success:
                worst = res
        except KnowhereException as e:
            if worst == Status.success:
                worst = e.status
        except Exception:  # pylint: disable=broad-except
            if worst == Status.success:
                worst = Status.internal_error
    return worst
