"""Overload control plane, its admission half: adaptive admission.

A copy of ``cassmantle_tpu/serving/overload.py`` (``:50-279`` and
``:545-652``) without the SLO brownout ladder (``BrownoutTier``,
``BrownoutLadder``, ``configure_brownout``, ``quality_overrides``), which
needs ``obs/slo.py`` and the HTTP server and waits for the server slice.

:class:`AdaptiveLimiter` is an AIMD concurrency limit per
:class:`~cassmantle_tpu_torch.serving.queue.BatchingQueue`, driven by the
measured per-batch ``queue_wait_s + service_s`` against a latency target:
under the target the limit creeps up additively, a breach decreases it
multiplicatively (at most once per cooldown). Rejections carry a
computed Retry-After from the predicted-wait estimator (depth x the
observed per-item service time), and a request whose predicted wait
already exceeds its deadline is rejected at submit. Background work
(round generation) sheds first, at ``background_fraction`` of the limit
and on event-loop lag.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("overload")

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BACKGROUND = "background"


@dataclasses.dataclass(frozen=True)
class Rejection:
    """An admission verdict: why, and how long the client should wait
    (the computed Retry-After the HTTP layer serves)."""

    reason: str            # "overload" | "background" | "predicted_late"
                           # | "loop_lag" | "chaos"
    retry_after_s: float


class AdaptiveLimiter:
    """Gradient/AIMD concurrency limiter for one queue.

    The signal is the per-batch end-to-end latency (slowest member's
    queue wait + the batch's service time) against ``target_s``:

    - under target → additive increase (+``increase`` per batch, capped
      at ``max_limit``): the limit probes for capacity;
    - over target → multiplicative decrease (×``decrease``, floored at
      ``min_limit``), at most once per cooldown window (~one batch
      service time) so a single slow batch cannot collapse the limit
      to the floor before its successors report in.

    The same observations feed the predicted-wait estimator: an EWMA of
    per-item service time × current depth ≈ how long a new arrival will
    wait — the number behind every computed Retry-After and behind
    rejecting already-doomed work (predicted wait > deadline) at
    submit. Unloaded, the limit sits at ``max_limit`` and the estimator
    predicts ~0, so admission is exactly the old static bound.

    Thread contract: ``admit`` runs on the submitting event loop,
    ``observe_batch`` on the queue's collector; a queue owns its
    limiter, but /readyz reads snapshots cross-thread — state is
    guarded by an :class:`OrderedLock` (rank 54).
    """

    def __init__(
        self,
        name: str,
        *,
        target_s: float = 1.0,
        min_limit: int = 8,
        max_limit: int = 4096,
        decrease: float = 0.7,
        increase: float = 1.0,
        background_fraction: float = 0.5,
        loop_lag_shed_s: float = 0.25,
        ewma_alpha: float = 0.3,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
        loop_lag_fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.name = name
        self.target_s = float(target_s)
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.decrease = float(decrease)
        self.increase = float(increase)
        self.background_fraction = float(background_fraction)
        self.loop_lag_shed_s = float(loop_lag_shed_s)
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self._registry = registry if registry is not None else metrics
        # an injected loop_lag_fn (tests) is read live; the default
        # registry read — an O(all-gauges) scan under the process-wide
        # metrics lock — is cached ~250 ms so the admit fast path never
        # pays it per request at exactly the moment the system is hot
        self._loop_lag_fn = loop_lag_fn
        self._lag_cache: Tuple[float, float] = (-1e9, 0.0)
        self._lock = OrderedLock(f"overload.limiter.{name}", rank=54)
        self._limit = float(self.max_limit)
        # EWMA of per-ITEM service time (batch service / batch width):
        # depth × this = predicted wait. None until the first batch.
        self._item_service_s: Optional[float] = None
        self._last_decrease: Optional[float] = None
        self._last_latency_s = 0.0
        # NOT auto-registered: make_admission (the wiring site) calls
        # register_limiter, so transient constructions — config probes,
        # lock-rank tests — never become phantom /readyz queue rows

    # -- signals -----------------------------------------------------------
    def _loop_lag(self) -> float:
        if self._loop_lag_fn is not None:
            return self._loop_lag_fn()
        now = self._clock()
        cached_at, value = self._lag_cache
        if now - cached_at > 0.25:
            values = self._registry.gauge_values("server.loop_lag_s")
            value = max(values) if values else 0.0
            self._lag_cache = (now, value)
        return value

    def observe_batch(self, wait_s: float, service_s: float,
                      batch_size: int) -> None:
        """One completed batch: update the service-time estimator and
        run the AIMD step on the batch's end-to-end latency."""
        latency = float(wait_s) + float(service_s)
        per_item = float(service_s) / max(1, int(batch_size))
        now = self._clock()
        with self._lock:
            self._last_latency_s = latency
            if self._item_service_s is None:
                self._item_service_s = per_item
            else:
                a = self.ewma_alpha
                self._item_service_s = (
                    a * per_item + (1.0 - a) * self._item_service_s)
            if latency > self.target_s:
                # cooldown ≈ one batch service time (floor: the target):
                # every in-flight batch admitted before the decrease will
                # still report the old regime's latency
                cooldown = max(self.target_s, float(service_s))
                if self._last_decrease is None or \
                        now - self._last_decrease >= cooldown:
                    # gradient estimate: the depth this queue can hold
                    # and still meet the target is throughput × target
                    # (Little's law). Clamping the multiplicative step
                    # to it converges in ONE decrease from any height —
                    # a limit parked at max_pending must not take
                    # log-many cooldowns to reach a sane bound while
                    # admitted work burns its deadline budget.
                    est = (int(batch_size) / max(float(service_s), 1e-6)
                           ) * self.target_s
                    self._limit = max(
                        float(self.min_limit),
                        min(self._limit * self.decrease, est))
                    self._last_decrease = now
            else:
                self._limit = min(float(self.max_limit),
                                  self._limit + self.increase)
            limit = self._limit
        self._registry.gauge(f"{self.name}.admit_limit", limit)

    # -- estimator ---------------------------------------------------------
    def predicted_wait_s(self, depth: int) -> float:
        """Expected queue wait for an arrival behind ``depth`` pending
        items: depth × observed per-item service time. 0 before the
        first batch (never reject on a guess)."""
        with self._lock:
            per_item = self._item_service_s
        if per_item is None:
            return 0.0
        return max(0, int(depth)) * per_item

    def retry_after_s(self, depth: int) -> float:
        """The computed Retry-After for a rejection at ``depth``: the
        predicted wait for the backlog ahead (floor 1 s — the HTTP
        header is integral seconds and 0 invites an instant retry)."""
        return max(1.0, self.predicted_wait_s(depth))

    # -- admission ---------------------------------------------------------
    def limit(self) -> float:
        with self._lock:
            return self._limit

    def admit(self, depth: int, priority: str,
              deadline_s: Optional[float]) -> Optional[Rejection]:
        """None = admitted; a :class:`Rejection` otherwise. Background
        sheds first (at ``background_fraction`` of the limit, and on
        any event-loop lag); interactive sheds at the limit, or
        immediately when its predicted wait already exceeds its
        deadline (doomed work must fail in <50 ms, not at deadline)."""
        lag = self._loop_lag()
        background = priority == PRIORITY_BACKGROUND
        if lag > self.loop_lag_shed_s and \
                (background or lag > 4.0 * self.loop_lag_shed_s):
            # the event loop is the resource upstream of every queue:
            # shed before the queues themselves ever look deep
            metrics.inc("overload.loop_lag_sheds")
            return Rejection("loop_lag", max(1.0, lag))
        with self._lock:
            limit = self._limit
        bound = limit * self.background_fraction if background else limit
        if depth >= bound:
            return Rejection("background" if background else "overload",
                             self.retry_after_s(depth))
        predicted = self.predicted_wait_s(depth)
        if deadline_s is not None and predicted > deadline_s:
            return Rejection("predicted_late", self.retry_after_s(depth))
        return None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "limit": round(self._limit, 1),
                "target_s": self.target_s,
                "item_service_s": (round(self._item_service_s, 6)
                                   if self._item_service_s is not None
                                   else None),
                "last_latency_s": round(self._last_latency_s, 4),
            }


# -- process-global wiring --------------------------------------------------
#
# Like the chaos plan, the control plane is process-global: the limiters
# register by queue name and the status block reads them all.

_LIMITERS: Dict[str, AdaptiveLimiter] = {}
# last time any queue shed for overload: what the membership heartbeat
# advertises so peers stop hedging into us (server/app.py)
_LAST_SHED_T: Optional[float] = None
_SHED_ADVERT_S = 10.0


def register_limiter(limiter: AdaptiveLimiter) -> None:
    """Newest limiter wins its name: services are rebuilt per test/app
    and /readyz must describe the live one."""
    _LIMITERS[limiter.name] = limiter


def note_shed() -> None:
    """A queue rejected work for overload: remember when, so the
    membership heartbeat can advertise pressure to hedging peers."""
    global _LAST_SHED_T
    _LAST_SHED_T = time.monotonic()


def note_table_served(n: int) -> None:
    """Scoring work served from the host int8 embed table
    (ops/embed_table.py) never reached this module's limiter — by
    construction it costs no device time, so admitting it would only
    distort the limiter's wait/service estimates. Counted here
    (``overload.table_served``) so the interactive tier's capacity math
    can attribute traffic that bypassed admission entirely."""
    if n:
        metrics.inc("overload.table_served", n)


def shedding(within_s: float = _SHED_ADVERT_S) -> bool:
    return _LAST_SHED_T is not None and \
        time.monotonic() - _LAST_SHED_T < within_s


def peer_advert() -> Dict[str, object]:
    """The overload fields a worker's membership heartbeat carries:
    peers consult them before hedging scorer work here
    (``score.hedge_skipped_overloaded``, server/app.py)."""
    return {"shed": 1} if shedding() else {}


def make_admission(name: str, cfg) -> AdaptiveLimiter:
    """The per-queue adaptive limiter from a FrameworkConfig, registered
    for :func:`status_block`."""
    s = cfg.serving
    limiter = AdaptiveLimiter(
        name,
        target_s=s.queue_latency_target_s,
        min_limit=s.admission_min_pending,
        max_limit=s.max_pending,
        background_fraction=s.admission_background_fraction,
        loop_lag_shed_s=s.loop_lag_shed_s,
    )
    register_limiter(limiter)
    return limiter


def status_block() -> Dict[str, object]:
    """The readiness overload block: every live queue limiter's state
    (the brownout ladder is not configured in the port yet)."""
    return {
        "brownout": {"tier": 0, "configured": False},
        "queues": {name: lim.snapshot()
                   for name, lim in sorted(_LIMITERS.items())},
        "shedding": shedding(),
        # lifetime count of scoring items the embed-table rung served
        # without ever reaching a queue limiter (zero device work)
        "table_served": int(metrics.counter_total(
            "overload.table_served")),
    }
