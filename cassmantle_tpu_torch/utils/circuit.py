"""Circuit breaker for the device-facing dispatch paths.

A copy of ``cassmantle_tpu/utils/circuit.py``:

- **closed**: normal operation; failures are counted in a sliding window;
- **open**: too many recent failures; calls fail fast until
  ``reset_timeout_s`` passes;
- **half_open**: one trial call is let through; success closes the
  breaker, failure re-opens it.

Transitions are counted (``circuit.<name>.opened`` / ``.closed`` /
``.half_open``), the state is a gauge, and the flight recorder keeps
their order. The clock is injectable; the breaker is thread-safe.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict

from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("circuit")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitOpen(Exception):
    """Raised (or returned as a fast-fail) when the breaker rejects a call."""


class CircuitBreaker:
    """Closed/open/half-open breaker with a sliding failure window.

    ``allow()`` must be called before the guarded operation;
    ``record_success()`` / ``record_failure()`` after it. ``allow()`` is
    where the open -> half_open transition happens (lazily, on the first
    call after the cooldown), so an idle breaker needs no timer task.
    """

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 5,
        window_s: float = 120.0,
        reset_timeout_s: float = 45.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.window_s = window_s
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        # innermost tier of the lock hierarchy: breaker state may be read
        # under the supervisor lock, never the other way around
        self._lock = OrderedLock(f"circuit.{name}", rank=40)
        self._state = CLOSED
        self._failures: Deque[float] = deque()
        self._opened_at = 0.0
        # half-open lets ONE probe through at a time; a probe that never
        # reports (hung device call) expires after reset_timeout_s so the
        # breaker cannot wedge in half_open forever
        self._probe_at: float = -1.0

    # -- state ------------------------------------------------------------
    def _set_state(self, state: str) -> None:
        if state == self._state:
            return
        prev, self._state = self._state, state
        event = {CLOSED: "closed", OPEN: "opened",
                 HALF_OPEN: "half_open"}[state]
        metrics.inc(f"circuit.{self.name}.{event}")
        metrics.gauge(f"circuit.{self.name}.state", _STATE_GAUGE[state])
        # the flight recorder keeps the order of transitions (lazy
        # import: utils never depends on obs at module scope)
        from cassmantle_tpu_torch.obs.recorder import flight_recorder

        flight_recorder.record("breaker", name=self.name,
                               state=state, prev=prev,
                               recent_failures=len(self._failures))
        log.warning("breaker %r -> %s", self.name, state)

    def _tick(self, now: float) -> None:
        """Lazy transitions: open -> half_open after the cooldown."""
        if self._state == OPEN and \
                now - self._opened_at >= self.reset_timeout_s:
            self._set_state(HALF_OPEN)
            self._probe_at = -1.0

    @property
    def state(self) -> str:
        with self._lock:
            self._tick(self.clock())
            return self._state

    def seconds_until_half_open(self) -> float:
        """0 unless open; how long callers should wait before retrying."""
        with self._lock:
            now = self.clock()
            self._tick(now)
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s - (now - self._opened_at))

    # -- the guard --------------------------------------------------------
    def allow(self) -> bool:
        """True if a call may proceed. open: fast-fail. half_open: one
        probe at a time (an unreported probe expires after the cooldown)."""
        with self._lock:
            now = self.clock()
            self._tick(now)
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probe_at < 0 or \
                        now - self._probe_at >= self.reset_timeout_s:
                    self._probe_at = now
                    return True
                metrics.inc(f"circuit.{self.name}.rejected")
                return False
            metrics.inc(f"circuit.{self.name}.rejected")
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures.clear()
            self._probe_at = -1.0
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            self._tick(now)
            metrics.inc(f"circuit.{self.name}.failures")
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh cooldown
                self._probe_at = -1.0
                self._opened_at = now
                self._set_state(OPEN)
                return
            self._failures.append(now)
            while self._failures and now - self._failures[0] > self.window_s:
                self._failures.popleft()
            if self._state == CLOSED and \
                    len(self._failures) >= self.failure_threshold:
                self._opened_at = now
                self._set_state(OPEN)

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            now = self.clock()
            self._tick(now)
            return {
                "state": self._state,
                "recent_failures": len(self._failures),
                "failure_threshold": self.failure_threshold,
                "retry_after_s": (
                    max(0.0, self.reset_timeout_s - (now - self._opened_at))
                    if self._state == OPEN else 0.0
                ),
            }
