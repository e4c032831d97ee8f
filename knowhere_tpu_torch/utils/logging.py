"""Logging shim (reference: include/knowhere/log.h glog macros).

Thin wrapper over the stdlib logger with the reference's module-prefix style.
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("knowhere_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s][KNOWHERE]%(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.WARNING)


def set_log_level(level: str) -> None:
    _logger.setLevel(getattr(logging, level.upper()))


def log_trace(msg: str) -> None:
    _logger.debug(msg)


def log_debug(msg: str) -> None:
    _logger.debug(msg)


def log_info(msg: str) -> None:
    _logger.info(msg)


def log_warning(msg: str) -> None:
    _logger.warning(msg)


def log_error(msg: str) -> None:
    _logger.error(msg)
