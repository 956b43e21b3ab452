"""Error handling — exception hierarchy + validation helpers.

Counterpart of ``raft_tpu.core.errors`` (itself after the reference's
``RAFT_EXPECTS``, core/error.hpp). A copy, not an import:
the port never imports the JAX package.
"""

from __future__ import annotations


class RaftError(RuntimeError):
    """Base exception (reference: ``raft::exception``)."""


class LogicError(RaftError):
    """Invalid argument / precondition violation (``raft::logic_error``)."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a path of the JAX package that the port does not carry
    yet raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to raft_tpu_torch yet (ROADMAP {item})")


def fail(msg: str, *args) -> None:
    """Raise :class:`LogicError` unconditionally (``RAFT_FAIL``)."""
    raise LogicError(msg % args if args else msg)


def expects(cond: bool, msg: str, *args) -> None:
    """Validate a host-side precondition; raises :class:`LogicError`."""
    if not cond:
        raise LogicError(msg % args if args else msg)
