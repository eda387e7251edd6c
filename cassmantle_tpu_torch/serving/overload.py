"""Overload control plane: adaptive admission and the SLO brownout ladder.

A copy of ``cassmantle_tpu/serving/overload.py``. Two mechanisms:

- :class:`AdaptiveLimiter` is an AIMD concurrency limit per
  :class:`~cassmantle_tpu_torch.serving.queue.BatchingQueue`, driven by
  the measured per-batch ``queue_wait_s + service_s`` against a latency
  target: under the target the limit creeps up additively, a breach
  decreases it multiplicatively (at most once per cooldown). Rejections
  carry a computed Retry-After from the predicted-wait estimator (depth x
  the observed per-item service time), and a request whose predicted
  wait already exceeds its deadline is rejected at submit. Background
  work (round generation) sheds first, at ``background_fraction`` of the
  limit and on event-loop lag.
- :class:`BrownoutLadder` consumes the SLO burn-rate engine
  (``obs/slo.py``): on sustained fast-window burn it steps through ordered
  quality tiers (fewer diffusion steps, a wider encoder-propagation
  stride, the few-step consistency student, half resolution, coarser
  blur buckets). Each tier is a config delta the pipelines build once
  and reuse (``serving/pipeline.py``: a tier's captured graphs are its
  own). It steps back down with hysteresis: the engine's slow-window
  recovery plus a dwell. ``CASSMANTLE_NO_BROWNOUT=1`` pins tier 0.

The ``overload.brownout`` fault point forces a tier step (the drill
lever); ``server.admit`` forces mis-admission.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from cassmantle_tpu_torch.chaos import ChaosInjected, fault_point
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("overload")

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BACKGROUND = "background"


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def adaptive_admission_disabled() -> bool:
    """CASSMANTLE_NO_ADAPTIVE_ADMISSION=1 reverts every queue to the
    static ``max_pending`` / ``degraded_max_pending`` pair (read when a
    service builds its queues)."""
    return _env_flag("CASSMANTLE_NO_ADAPTIVE_ADMISSION")


def brownout_disabled() -> bool:
    """CASSMANTLE_NO_BROWNOUT=1 pins the ladder at tier 0. Checked on
    every evaluation AND every override read, so setting it mid-flight
    drops quality degradation at once (with the flag set, serving is
    bit for bit the undegraded path)."""
    return _env_flag("CASSMANTLE_NO_BROWNOUT")


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


# -- brownout ladder --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BrownoutTier:
    """One rung of quality degradation: a config delta the serving
    paths apply without new work in steady state (each distinct delta
    builds its graphs once and is cached)."""

    name: str
    # diffusion step-count multiplier (the dominant latency knob)
    num_steps_scale: float = 1.0
    # added to SamplerConfig.encprop_stride when encprop is on (more
    # propagated decoder-only steps per full encoder forward)
    encprop_stride_add: int = 0
    # step INTO the few-step consistency student
    # (SamplerConfig.consistency, ops/samplers.py::consistency_sample)
    # at CONSISTENCY_BROWNOUT_STEPS — the biggest step-count lever in
    # the ladder, taken BEFORE any resolution downshift: a 4-forward
    # image at full resolution beats a half-resolution 30-forward one
    # on both latency and user-visible quality. Only engages when the
    # deployment declares a distilled student checkpoint
    # (SamplerConfig.consistency or .consistency_available — an
    # UNDISTILLED eps-net sampled 4-step is near-noise, worse than any
    # resolution downshift), and ignored while CASSMANTLE_NO_CONSISTENCY
    # pins the student off; otherwise the rung degrades like the
    # previous one and the ladder falls through to the resolution tier.
    consistency: bool = False
    # image resolution multiplier (quadratic compute lever)
    image_size_scale: float = 1.0
    # blur-ladder quantization in px: coarser buckets = fewer distinct
    # decode+blur+encode renders per round (engine/game.py)
    blur_bucket_px: float = 0.5


#: step count the few-step brownout tier serves (the lcm preset's 4)
CONSISTENCY_BROWNOUT_STEPS = 4

# Ordered mild → severe; tier 0 is full quality. Every tier includes
# the previous tiers' deltas so stepping up only ever removes compute.
DEFAULT_TIERS: Tuple[BrownoutTier, ...] = (
    BrownoutTier("full"),
    BrownoutTier("fewer-steps", num_steps_scale=0.6),
    BrownoutTier("stride", num_steps_scale=0.6, encprop_stride_add=2),
    BrownoutTier("few-step", num_steps_scale=0.6, encprop_stride_add=2,
                 consistency=True),
    BrownoutTier("low-res", num_steps_scale=0.6, encprop_stride_add=2,
                 consistency=True, image_size_scale=0.5),
    BrownoutTier("coarse-blur", num_steps_scale=0.6,
                 encprop_stride_add=2, consistency=True,
                 image_size_scale=0.5, blur_bucket_px=2.0),
)


def degraded_sampler_cfg(sampler_cfg, tier: BrownoutTier):
    """Apply a tier's deltas to a SamplerConfig, respecting the
    config's structural invariants (deepcache pairing needs even ddim
    step counts, encprop's dense prefix must fit the step count, the
    latent grid needs image_size on a /16 boundary, consistency does
    not compose with deepcache/encprop). Returns a config EQUAL to the
    input at tier 0 (callers skip the degraded path)."""
    from cassmantle_tpu_torch.ops.samplers import consistency_disabled
    from cassmantle_tpu_torch.serving.pipeline import effective_sampler_cfg

    # with the kill switch set serving already reverted to the teacher
    # path (kind @ consistency_teacher_steps); tiers degrade THAT — the
    # config the pipeline is actually dispatching (one shared revert,
    # so the brownout path can never diverge from the pinned bit-exact
    # teacher revert the pipeline/staged paths take)
    s = effective_sampler_cfg(sampler_cfg)
    steps = max(2, int(round(s.num_steps * tier.num_steps_scale)))
    if s.deepcache and s.kind == "ddim":
        steps += steps % 2
    stride = s.encprop_stride
    if s.encprop and tier.encprop_stride_add:
        stride = s.encprop_stride + int(tier.encprop_stride_add)
    size = s.image_size
    if tier.image_size_scale != 1.0:
        size = max(32, (int(s.image_size * tier.image_size_scale)
                        // 16) * 16)
    if (tier.consistency and not consistency_disabled()
            and (s.consistency or s.consistency_available)):
        # the few-step tier swaps the whole sampling loop for the
        # consistency student; deepcache/encprop don't compose with it
        # and eta is meaningless for the deterministic re-noise ladder,
        # so the delta clears all three and touches nothing else. A
        # config ALREADY serving the student keeps its
        # (<= CONSISTENCY_BROWNOUT_STEPS) step count: there is no
        # cheaper rung than the few-step path.
        few = (min(CONSISTENCY_BROWNOUT_STEPS, s.num_steps)
               if s.consistency else CONSISTENCY_BROWNOUT_STEPS)
        return dataclasses.replace(
            s, consistency=True, num_steps=few, deepcache=False,
            encprop=False, eta=0.0, image_size=size)
    dense = min(s.encprop_dense_steps, steps)
    return dataclasses.replace(
        s, num_steps=steps, encprop_stride=stride, image_size=size,
        encprop_dense_steps=dense)


class BrownoutLadder:
    """The ok↔burning consumer: steps the tier up while any watched
    objective reports ``burning`` (the engine's fast-window trip) for
    at least ``step_up_dwell_s``, and back down — one rung at a time —
    only after every watched objective has been ``ok`` (the engine's
    slow-window recovery) for ``step_down_dwell_s``. The asymmetric
    dwell pair IS the hysteresis: quality drops fast under real burn
    and recovers deliberately.

    The ``overload.brownout`` fault point lets a drill force a tier
    step regardless of SLO state (tier-flap drills).
    """

    def __init__(
        self,
        tiers: Sequence[BrownoutTier] = DEFAULT_TIERS,
        *,
        objectives: Sequence[str] = (),
        step_up_dwell_s: float = 10.0,
        step_down_dwell_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
        recorder=None,
    ) -> None:
        assert tiers, "the ladder needs at least tier 0"
        self.tiers = tuple(tiers)
        # empty = watch every objective the engine evaluates
        self.objectives = tuple(objectives)
        self.step_up_dwell_s = float(step_up_dwell_s)
        self.step_down_dwell_s = float(step_down_dwell_s)
        self._clock = clock
        self._registry = registry if registry is not None else metrics
        self._recorder = recorder if recorder is not None \
            else flight_recorder
        self._lock = OrderedLock("overload.brownout", rank=55)
        self._tier = 0
        self._burn_since: Optional[float] = None
        self._ok_since: Optional[float] = None
        self._registry.gauge("overload.brownout_tier", 0.0)

    # -- state -------------------------------------------------------------
    def tier(self) -> int:
        if brownout_disabled():
            return 0
        with self._lock:
            return self._tier

    def active_tier(self) -> Optional[BrownoutTier]:
        """The tier object when degraded, None at tier 0/disabled —
        what the pipelines consult per generate call."""
        t = self.tier()
        return self.tiers[t] if t else None

    def _step_to(self, new_tier: int, reason: str) -> None:
        """Caller holds the lock. Records the transition everywhere an
        operator could look for it."""
        old = self._tier
        self._tier = new_tier
        self._registry.gauge("overload.brownout_tier", float(new_tier))
        if new_tier > old:
            self._registry.inc("overload.brownout_trips")
        else:
            self._registry.inc("overload.brownout_recoveries")
        self._recorder.record(
            "overload.brownout", from_tier=old, to_tier=new_tier,
            tier_name=self.tiers[new_tier].name, reason=reason)
        log.warning("brownout tier %d -> %d (%s): %s", old, new_tier,
                    self.tiers[new_tier].name, reason)

    # -- the SLO-engine listener -------------------------------------------
    def on_slo_eval(self, verdicts: Dict[str, dict]) -> None:
        """Called by the SLO engine after every evaluation pass with
        the per-objective verdicts (obs/slo.py)."""
        if brownout_disabled():
            with self._lock:
                if self._tier:
                    self._step_to(0, "disabled")
                self._burn_since = self._ok_since = None
            return
        try:
            # drill lever: force a tier step independent of SLO state
            fault_point("overload.brownout")
        except ChaosInjected:
            with self._lock:
                if self._tier + 1 < len(self.tiers):
                    self._step_to(self._tier + 1, "chaos")
            return
        watched = {n: v for n, v in verdicts.items()
                   if not self.objectives or n in self.objectives}
        if not watched:
            return
        burning = any(v.get("state") == "burning"
                      for v in watched.values())
        now = self._clock()
        with self._lock:
            if burning:
                self._ok_since = None
                if self._burn_since is None:
                    self._burn_since = now
                elif now - self._burn_since >= self.step_up_dwell_s and \
                        self._tier + 1 < len(self.tiers):
                    self._step_to(self._tier + 1, "slo_burn")
                    # each further rung re-earns its own dwell
                    self._burn_since = now
            else:
                # the engine's own hysteresis already gated this: an
                # objective leaves "burning" only once the SLOW window
                # is back under budget
                self._burn_since = None
                if self._tier == 0:
                    self._ok_since = None
                elif self._ok_since is None:
                    self._ok_since = now
                elif now - self._ok_since >= self.step_down_dwell_s:
                    self._step_to(self._tier - 1, "slo_recovered")
                    self._ok_since = now

    def status(self) -> Dict[str, object]:
        disabled = brownout_disabled()
        with self._lock:
            tier = 0 if disabled else self._tier
            return {
                "tier": tier,
                "tier_name": self.tiers[tier].name,
                "tiers": len(self.tiers),
                "disabled": disabled,
            }


# -- process-global wiring --------------------------------------------------
#
# Like the chaos plan, the control plane is process-global: pipelines and
# the game engine read the active tier from worker threads without any
# app-object plumbing, and the status block reads the ladder and every
# limiter. configure_brownout is idempotent per service build.

_LADDER: Optional[BrownoutLadder] = None
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
    out: Dict[str, object] = {}
    if shedding():
        out["shed"] = 1
    tier = current_tier()
    if tier:
        out["btier"] = tier
    return out


def make_admission(name: str, cfg) -> Optional[AdaptiveLimiter]:
    """The per-queue adaptive limiter from a FrameworkConfig, registered
    for :func:`status_block`; None under CASSMANTLE_NO_ADAPTIVE_ADMISSION,
    which leaves the queue its static max_pending / degraded_max_pending
    pair exactly."""
    if adaptive_admission_disabled():
        return None
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


def configure_brownout(cfg, slo_engine) -> Optional[BrownoutLadder]:
    """Build the ladder from ``cfg.serving`` and subscribe it to the
    SLO engine. Returns the ladder."""
    global _LADDER
    serving = cfg.serving
    _LADDER = BrownoutLadder(
        DEFAULT_TIERS,
        objectives=serving.brownout_objectives,
        step_up_dwell_s=serving.brownout_step_up_dwell_s,
        step_down_dwell_s=serving.brownout_step_down_dwell_s,
    )
    slo_engine.add_listener(_LADDER.on_slo_eval)
    return _LADDER


def reset_brownout() -> None:
    """Drop the process's ladder: every actuation site serves full
    quality until :func:`configure_brownout` builds another."""
    global _LADDER
    _LADDER = None


def ladder() -> Optional[BrownoutLadder]:
    return _LADDER


def current_tier() -> int:
    return _LADDER.tier() if _LADDER is not None else 0


def quality_overrides() -> Optional[BrownoutTier]:
    """The active degradation tier, None at full quality — the ONE
    read every actuation site (pipelines, fake backend, blur ladder)
    performs. Cheap: a global check, a flag read, a lock-guarded int."""
    return _LADDER.active_tier() if _LADDER is not None else None


def blur_bucket_px(default: float = 0.5) -> float:
    """The blur-ladder quantum the game should use right now
    (engine/game.py fetch_masked_image_b64)."""
    tier = quality_overrides()
    return tier.blur_bucket_px if tier is not None else default


def quantize_blur_radius(radius: float, default: float = 0.5) -> float:
    """Snap a reveal radius onto the active blur-bucket ladder. At the
    default quantum this is the legacy round-to-nearest (bit-for-bit
    the pre-brownout buckets); a COARSENED quantum rounds UP — quality
    degradation must only ever add blur, never serve a near-winner's
    almost-sharp radius as fully sharp (a tier-4 quantum of 2.0 with
    nearest-rounding would have revealed every radius < 1.0 px)."""
    quantum = blur_bucket_px(default)
    if quantum == default:
        return round(radius / quantum) * quantum
    return math.ceil(radius / quantum) * quantum


def status_block() -> Dict[str, object]:
    """The readiness overload block: the brownout verdict plus every
    live queue limiter's state."""
    return {
        "brownout": (_LADDER.status() if _LADDER is not None
                     else {"tier": 0, "disabled": brownout_disabled(),
                           "configured": False}),
        "queues": {name: lim.snapshot()
                   for name, lim in sorted(_LIMITERS.items())},
        "shedding": shedding(),
        # lifetime count of scoring items the embed-table rung served
        # without ever reaching a queue limiter (zero device work)
        "table_served": int(metrics.counter_total(
            "overload.table_served")),
    }
