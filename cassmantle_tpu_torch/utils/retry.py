"""Retry with backoff, and a retry budget.

A copy of ``cassmantle_tpu/utils/retry.py``: :class:`RetryBudget`, the
token bucket the device-recovery manager spends its rebuild attempts
from, and :func:`retry_async` with the reference's linear backoff
schedule, which wraps the engine's round generation.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Awaitable, Callable, Optional, Tuple, Type, TypeVar

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

T = TypeVar("T")

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

# Default jitter source: one process-wide stream (``rng`` overrides it
# per call).
_jitter_rng = random.Random()


def linear_backoff(base_s: float = 10.0):
    """The reference schedule: (attempt+1) * base seconds."""

    def schedule(attempt: int) -> float:
        return (attempt + 1) * base_s

    return schedule


async def retry_async(
    op: Callable[[], Awaitable[T]],
    *,
    max_retries: int = 5,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    backoff: Optional[Callable[[int], float]] = None,
    sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
    name: str = "op",
    deadline_s: Optional[float] = None,
    give_up_on: Tuple[Type[BaseException], ...] = (),
    jitter: bool = True,
    rng: Optional[random.Random] = None,
    budget: Optional[RetryBudget] = None,
) -> T:
    """Run ``op`` with up to ``max_retries`` attempts; re-raises the last
    failure (callers keep skip-don't-crash semantics at their level).

    Backoff is FULL-JITTERED by default: each pause is drawn uniformly
    from (0, schedule(attempt)] — N callers tripped by one store blip
    (every worker's round clock hitting the same dead leader) spread
    their re-dials across the window instead of retrying in lockstep
    and re-spiking the thing that just fell over. ``rng`` injects the
    jitter source (deterministic under drill seeds); ``jitter=False``
    keeps the exact reference schedule.

    ``deadline_s`` bounds total wall time: no further attempt starts once
    elapsed + the next backoff would pass it. Callers that retry while
    holding an expiring lock set this below the lock timeout, so the lock
    cannot lapse mid-retry and admit a second worker (a started attempt
    can still overrun — an in-flight device call is not preemptible).

    ``give_up_on`` exceptions abort immediately with no further attempts —
    e.g. a CircuitOpen fast-fail, where backing off and re-dialing an
    open breaker would just burn the caller's lock budget.

    ``budget``: a shared :class:`RetryBudget` each RE-dial must acquire
    from (the first attempt is free — it is not a retry). Exhaustion
    re-raises the last failure immediately; give_up_on fast-fails never
    touch the budget."""
    backoff = backoff or linear_backoff()
    loop = asyncio.get_running_loop()
    start = loop.time()
    last: Optional[BaseException] = None
    for attempt in range(max_retries):
        try:
            return await op()
        except give_up_on:
            raise
        except retry_on as exc:  # noqa: PERF203
            last = exc
            metrics.inc(f"retry.{name}.failures")
            log.warning("%s attempt %d/%d failed: %s",
                        name, attempt + 1, max_retries, exc)
            if attempt + 1 < max_retries:
                if budget is not None and not budget.acquire():
                    log.warning("%s: retry budget exhausted after %d "
                                "attempt(s)", name, attempt + 1)
                    break
                pause = backoff(attempt)
                if jitter and pause > 0:
                    # full jitter (uniform over (0, schedule]): the
                    # spread that actually decorrelates a thundering
                    # herd; attempts stay bounded by max_retries and
                    # the deadline check below, so a small draw cannot
                    # turn backoff into an unbounded hot loop
                    pause *= (rng or _jitter_rng).random()
                if deadline_s is not None and \
                        loop.time() - start + pause >= deadline_s:
                    log.warning("%s: deadline %.0fs reached after %d "
                                "attempts", name, deadline_s, attempt + 1)
                    break
                await sleep(pause)
    assert last is not None
    raise last
