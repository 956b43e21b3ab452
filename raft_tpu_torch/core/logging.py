"""Logging — leveled singleton logger with callback sink (a copy of
``raft_tpu.core.logging``, after the reference's spdlog-backed logger:
core/logger-inl.hpp:103 ``logger::set_level``, core/logger-macros.hpp
``RAFT_LOG_*``, core/detail/callback_sink.hpp). Built on :mod:`logging`,
under the logger name ``raft_tpu_torch``; the callback sink is a plain
handler hook.
"""

from __future__ import annotations

import logging as _pylogging
from typing import Callable, Optional

TRACE = 5
_pylogging.addLevelName(TRACE, "TRACE")

_logger = _pylogging.getLogger("raft_tpu_torch")
_logger.addHandler(_pylogging.NullHandler())


def get_logger() -> _pylogging.Logger:
    return _logger


def set_level(level: int) -> None:
    """Set the global log level (reference: logger::set_level)."""
    _logger.setLevel(level)


class _CallbackHandler(_pylogging.Handler):
    def __init__(self, fn: Callable[[int, str], None]):
        super().__init__()
        self._fn = fn

    def emit(self, record: _pylogging.LogRecord) -> None:
        self._fn(record.levelno, self.format(record))


_callback_handler: Optional[_CallbackHandler] = None


def set_callback(fn: Optional[Callable[[int, str], None]]) -> None:
    """Install a callback sink (reference: core/detail/callback_sink.hpp)."""
    global _callback_handler
    if _callback_handler is not None:
        _logger.removeHandler(_callback_handler)
        _callback_handler = None
    if fn is not None:
        _callback_handler = _CallbackHandler(fn)
        _logger.addHandler(_callback_handler)


def trace(msg, *a):
    _logger.log(TRACE, msg, *a)


def debug(msg, *a):
    _logger.debug(msg, *a)


def info(msg, *a):
    _logger.info(msg, *a)


def warn(msg, *a):
    _logger.warning(msg, *a)


def error(msg, *a):
    _logger.error(msg, *a)
