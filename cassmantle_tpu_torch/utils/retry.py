"""Retry budget: a token bucket that bounds the rate of retries.

A copy of ``cassmantle_tpu/utils/retry.py::RetryBudget`` (``:22-79``),
what the device-recovery manager spends its rebuild attempts from. The
reference's ``retry_async`` serves the engine's round generation, a later
slice.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("retry")


class RetryBudget:
    """Token-bucket cap on the rate of retries.

    Per-call retry loops are individually bounded but collectively
    unbounded: under a persistent fault, every caller spends its full
    ``max_retries`` re-dialing the same dead thing, and the retry
    traffic itself becomes load (checkpoint re-reads in device
    recovery, device dials behind a flaky tunnel). A shared budget
    makes the AGGREGATE bounded: each retry attempt spends a token,
    tokens refill at a fixed rate, and an empty bucket turns further
    retries into immediate give-ups (``retry.budget_exhausted``).

    Thread-safe; ``clock`` is injectable for tests and drills.
    """

    def __init__(self, name: str, capacity: float = 10.0,
                 refill_per_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._tokens = float(capacity)
        self._at = clock()

    def tokens(self) -> float:
        """Current token balance (after refill), for status surfaces."""
        with self._lock:
            self._refill_locked()
            return self._tokens

    def _refill_locked(self) -> None:
        now = self.clock()
        self._tokens = min(self.capacity,
                           self._tokens
                           + (now - self._at) * self.refill_per_s)
        self._at = now

    def acquire(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available. False = budget exhausted:
        the caller must give up this retry (counted, logged)."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
        metrics.inc("retry.budget_exhausted",
                    labels={"budget": self.name})
        log.warning("retry budget %r exhausted; giving up retry",
                    self.name)
        return False
