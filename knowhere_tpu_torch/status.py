"""Status codes, categories, and `expected`-style results.

Reimplementation of the reference error-handling contract
(reference: include/knowhere/expected.h:34-120 for the Status enum and the
3-way StatusCategory; expected.h:398-425 for expected<T>/GuardedCall).

Every public API converts exceptions into a Status (never raises across the
API boundary), and every Status is classified into a closed 3-value category
(input / permanent / transient) that callers use for retry decisions. The
exhaustiveness the reference enforces with -Wswitch is enforced here by a
module-level assertion plus a unit test.
"""

from __future__ import annotations

import enum
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class Status(enum.IntEnum):
    success = 0
    invalid_args = 1
    invalid_param_in_json = 2
    out_of_range_in_json = 3
    type_conflict_in_json = 4
    invalid_metric_type = 5
    empty_index = 6
    not_implemented = 7
    index_not_trained = 8
    index_already_trained = 9
    faiss_inner_error = 10
    hnsw_inner_error = 12
    malloc_error = 13
    diskann_inner_error = 14
    disk_file_error = 15
    invalid_value_in_json = 16
    arithmetic_overflow = 17
    cuvs_inner_error = 18
    invalid_binary_set = 19
    invalid_instruction_set = 20
    cardinal_inner_error = 21
    cuda_runtime_error = 22
    invalid_index_error = 23
    invalid_cluster_error = 24
    cluster_inner_error = 25
    timeout = 26
    internal_error = 27
    invalid_serialized_index_type = 28
    sparse_inner_error = 29
    brute_force_inner_error = 30
    emb_list_inner_error = 31
    aisaq_error = 32
    knowhere_inner_error = 33


class StatusCategory(enum.IntEnum):
    success = 0
    # the request itself is at fault (caller must fix it; retry is useless)
    input_error = 1
    # server-side and permanent: retrying cannot help
    permanent_error = 2
    # server-side and transient: a retry may succeed
    transient_error = 3


_INPUT_ERRORS = frozenset(
    {
        Status.invalid_args,
        Status.invalid_param_in_json,
        Status.out_of_range_in_json,
        Status.type_conflict_in_json,
        Status.invalid_metric_type,
        Status.empty_index,
        Status.index_not_trained,
        Status.index_already_trained,
        Status.invalid_value_in_json,
        Status.arithmetic_overflow,
        Status.invalid_binary_set,
        Status.invalid_index_error,
        Status.invalid_cluster_error,
    }
)

_TRANSIENT_ERRORS = frozenset(
    {
        Status.malloc_error,
        Status.disk_file_error,
        Status.timeout,
        Status.cuda_runtime_error,
    }
)


def status_category_of(status: Status) -> StatusCategory:
    """Closed, total classification of every Status (reference expected.h:95+)."""
    if status == Status.success:
        return StatusCategory.success
    if status in _INPUT_ERRORS:
        return StatusCategory.input_error
    if status in _TRANSIENT_ERRORS:
        return StatusCategory.transient_error
    return StatusCategory.permanent_error


# Exhaustiveness guard: importing this module verifies every Status is covered.
for _s in Status:
    assert status_category_of(_s) in StatusCategory, _s


class KnowhereException(Exception):
    """Exception carrying a Status; converted to Status at API boundaries."""

    def __init__(self, message: str, status: Status = Status.knowhere_inner_error):
        super().__init__(message)
        self.status = Status(status)
        self.message = message


class expected(Generic[T]):
    """Result-or-status, mirroring the reference `expected<T>`.

    Use `expected.Ok(value)` / `expected.Err(status, msg)`. `value()` raises if
    there is no value (like the reference's assert-on-access).
    """

    __slots__ = ("_value", "_status", "_what")

    def __init__(self, value: Optional[T], status: Status, what: str = ""):
        self._value = value
        self._status = Status(status)
        self._what = what

    @classmethod
    def Ok(cls, value: T) -> "expected[T]":
        return cls(value, Status.success)

    @classmethod
    def Err(cls, status: Status, what: str = "") -> "expected[T]":
        if status == Status.success:
            status = Status.knowhere_inner_error
        return cls(None, status, what)

    def has_value(self) -> bool:
        return self._status == Status.success

    def value(self) -> T:
        if not self.has_value():
            raise KnowhereException(
                f"expected has no value: {self._status.name}: {self._what}",
                self._status,
            )
        return self._value  # type: ignore[return-value]

    def error(self) -> Status:
        return self._status

    def what(self) -> str:
        return self._what

    def __bool__(self) -> bool:
        return self.has_value()

    def __repr__(self) -> str:
        if self.has_value():
            return f"expected.Ok({self._value!r})"
        return f"expected.Err({self._status.name}, {self._what!r})"


def guarded_call(fn: Callable[[], Status]) -> Status:
    """Run `fn`, converting any exception to a Status (reference GuardedCall,
    expected.h:398-420). Public Index methods never raise."""
    try:
        return fn()
    except KnowhereException as e:  # noqa: PERF203
        from .utils.logging import log_error

        log_error(f"KnowhereException: {e.message}")
        return e.status
    except MemoryError:
        return Status.malloc_error
    except NotImplementedError:
        return Status.not_implemented
    except Exception as e:  # pylint: disable=broad-except
        from .utils.logging import log_error

        log_error(f"Unexpected exception: {type(e).__name__}: {e}")
        return Status.internal_error


def guarded_expected(fn: Callable[[], "expected[T]"]) -> "expected[T]":
    """Like guarded_call but for value-returning APIs."""
    try:
        return fn()
    except KnowhereException as e:
        from .utils.logging import log_error

        log_error(f"KnowhereException: {e.message}")
        return expected.Err(e.status, e.message)
    except MemoryError as e:
        return expected.Err(Status.malloc_error, str(e))
    except NotImplementedError as e:
        return expected.Err(Status.not_implemented, str(e))
    except Exception as e:  # pylint: disable=broad-except
        from .utils.logging import log_error

        log_error(f"Unexpected exception: {type(e).__name__}: {e}")
        return expected.Err(Status.internal_error, f"{type(e).__name__}: {e}")
