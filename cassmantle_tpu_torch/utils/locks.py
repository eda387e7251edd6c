"""OrderedLock: a ``threading.Lock`` that checks the lock hierarchy.

A copy of ``cassmantle_tpu/utils/locks.py`` (``:30-190``). Each lock
carries an optional ``rank``; with the sentinel on, a thread may only
acquire a lock of rank strictly greater than any ranked lock it holds,
never re-acquire one it holds, and never invert an acquisition order
observed before. The ranks the seam uses, outermost first: pipeline
dispatch locks 10-13, the dispatch worker 20, the supervisor 30,
breakers 40, the admission limiters 54, the chaos plan 60.

The sentinel is off unless ``CASSMANTLE_LOCK_SENTINEL`` is set or
:func:`enable_sentinel` is called (acquisitions then cost one list
append); a violation raises :class:`LockOrderViolation` in raising mode
and is logged otherwise.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("locks")


class LockOrderViolation(RuntimeError):
    """An acquisition that breaks the lock hierarchy (would deadlock)."""


_tls = threading.local()
_graph_lock = threading.Lock()
# (first_name, then_name) -> where that order was first observed
_edges: Dict[Tuple[str, str], str] = {}

_enabled = os.environ.get("CASSMANTLE_LOCK_SENTINEL", "") not in ("", "0")
_raise_on_violation = False


def enable_sentinel(raise_on_violation: bool = True) -> None:
    global _enabled, _raise_on_violation
    _enabled = True
    _raise_on_violation = raise_on_violation


def disable_sentinel() -> None:
    global _enabled, _raise_on_violation
    _enabled = False
    _raise_on_violation = False


def reset_observations() -> None:
    """Drop the observed-order graph."""
    with _graph_lock:
        _edges.clear()


def _held() -> List["OrderedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site() -> str:
    for frame in reversed(traceback.extract_stack(limit=8)):
        if not frame.filename.endswith("locks.py"):
            return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class OrderedLock:
    """Drop-in ``threading.Lock`` with hierarchy and order checks."""

    __slots__ = ("name", "rank", "_inner")

    def __init__(self, name: str, rank: Optional[int] = None) -> None:
        self.name = name
        self.rank = rank
        self._inner = threading.Lock()

    def __repr__(self) -> str:
        return f"OrderedLock({self.name!r}, rank={self.rank})"

    def _violation(self, message: str) -> None:
        metrics.inc("locks.order_violations")
        from cassmantle_tpu_torch.obs.recorder import flight_recorder

        flight_recorder.record("locks.violation", lock=self.name,
                               message=message)
        if _raise_on_violation:
            raise LockOrderViolation(message)
        log.error("lock-order violation: %s", message)

    def _check(self, held: List["OrderedLock"]) -> None:
        if not held:
            return
        site = _site()
        if any(h is self for h in held):
            self._violation(
                f"re-acquire of non-reentrant {self.name!r} already held "
                f"by this thread at {site} (self-deadlock)")
            return
        for h in held:
            if self.rank is not None and h.rank is not None \
                    and h.rank >= self.rank:
                self._violation(
                    f"acquiring {self.name!r} (rank {self.rank}) while "
                    f"holding {h.name!r} (rank {h.rank}) at {site}: the "
                    f"hierarchy requires strictly increasing ranks")
                return
        with _graph_lock:
            for h in held:
                if h.name == self.name:
                    continue
                reverse = _edges.get((self.name, h.name))
                if reverse is not None:
                    self._violation(
                        f"acquisition-order inversion: {h.name!r} -> "
                        f"{self.name!r} at {site}, but {self.name!r} -> "
                        f"{h.name!r} was acquired at {reverse}")
                    return
                _edges.setdefault((h.name, self.name), site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled:
            # before blocking: a violation must raise, not deadlock
            self._check(_held())
        acquired = self._inner.acquire(blocking, timeout)
        if acquired:
            _held().append(self)
        return acquired

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False
