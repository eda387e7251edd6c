"""Serving supervisor: one readiness signal for the whole device path.

A copy of ``cassmantle_tpu/serving/supervisor.py``. It fuses the
degradation detectors into one state:

- the **content breaker** around round generation;
- the **score breaker** around the guess-scorer dispatch (the service
  degrades to floor scores while it is open);
- the **dispatch watchdog** in ``serving/queue.py`` (a handler that
  overruns its hang deadline calls :meth:`note_dispatch_overrun`);
- the **device-loss state** (``serving/device_recovery.py``): while the
  recovery manager rebuilds, the queues fail fast;
- optionally ``utils/health.py``'s :class:`DeviceHealth`, the CUDA probe
  the server wires in (``device_health``).

:meth:`status` is the body of ``/readyz`` and ``/healthz``, with the room
fabric's block (``fabric_status``) and per-stage progress.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, Optional

from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.circuit import OPEN, CircuitBreaker
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("supervisor")


class ServingSupervisor:
    def __init__(
        self,
        *,
        content_breaker: Optional[CircuitBreaker] = None,
        score_breaker: Optional[CircuitBreaker] = None,
        device_health=None,
        degraded_cooldown_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.clock = clock
        self.content_breaker = content_breaker or CircuitBreaker(
            "content", clock=clock)
        self.score_breaker = score_breaker or CircuitBreaker(
            "score", clock=clock)
        # set by the server when it serves on a device (utils/health.py)
        self.device_health = device_health
        # set by a room fabric: a sync callable returning the /readyz
        # cluster block (fabric/rooms.py RoomFabric.status)
        self.fabric_status: Optional[Callable[[], Dict[str, object]]] = None
        self.degraded_cooldown_s = degraded_cooldown_s
        # lock hierarchy: supervisor state is leaf-ward of the dispatch
        # locks, outward of the breakers
        self._lock = OrderedLock("supervisor", rank=30)
        self._degraded_until = 0.0
        self._overruns = 0
        # the DeviceRecoveryManager when an InferenceService owns this
        # supervisor (serving/service.py publishes it)
        self.recovery = None
        # device-loss state (serving/device_recovery.py): reason string
        # while the accelerator runtime is gone and the recovery manager
        # is rebuilding serving state; None when healthy
        self._device_lost: Optional[str] = None
        # stage -> last time it made observable progress (staged serving)
        self._stage_progress: Dict[str, float] = {}

    # -- watchdog ---------------------------------------------------------
    def note_dispatch_overrun(self, queue_name: str) -> None:
        """A batch handler blew through its hang deadline: the dispatch
        thread was wedged (and has been replaced). Hold the worker in
        degraded state for a cooldown — one overrun means in-flight
        device work is unreliable right now, not just that one batch."""
        with self._lock:
            self._overruns += 1
            self._degraded_until = max(
                self._degraded_until,
                self.clock() + self.degraded_cooldown_s,
            )
        metrics.inc("supervisor.dispatch_overruns")
        flight_recorder.record("supervisor.overrun", queue=queue_name,
                               cooldown_s=self.degraded_cooldown_s)
        log.error("dispatch overrun on %r: degraded for %.0fs",
                  queue_name, self.degraded_cooldown_s)

    @property
    def watchdog_degraded(self) -> bool:
        with self._lock:
            return self.clock() < self._degraded_until

    # -- per-stage health (staged serving) -----------------------------------
    def note_stage_progress(self, stage: str) -> None:
        """A serving stage made observable progress (a batch completed, a
        slot retired): the ``stages`` block of :meth:`status`."""
        with self._lock:
            self._stage_progress[stage] = self.clock()

    def stage_health(self) -> Dict[str, float]:
        """Seconds since each registered stage last made progress."""
        with self._lock:
            now = self.clock()
            return {s: round(now - t, 3)
                    for s, t in self._stage_progress.items()}

    # -- device loss (serving/device_recovery.py) --------------------------
    def note_device_lost(self, reason: str) -> None:
        """The recovery manager classified a dispatch failure / probe
        pattern as accelerator-runtime loss: hold `/readyz` 503 (state
        ``device_lost``) until :meth:`note_device_recovered`."""
        with self._lock:
            self._device_lost = reason or "device lost"
        metrics.gauge("supervisor.device_lost", 1.0)
        flight_recorder.record("device.lost", reason=reason)
        log.error("device lost (%s): serving degraded until the "
                  "recovery manager rebuilds device state", reason)

    def note_device_recovered(self) -> None:
        with self._lock:
            self._device_lost = None
        metrics.gauge("supervisor.device_lost", 0.0)
        flight_recorder.record("device.recovered")
        log.warning("device recovered: serving state rebuilt")

    @property
    def device_lost(self) -> Optional[str]:
        """The loss reason while in the ``device_lost`` state, else
        None. Read by `/readyz` (names the state) and the queues (fail
        fast instead of batching work for a dead device)."""
        with self._lock:
            return self._device_lost

    def device_unhealthy(self) -> bool:
        """True only when the cached probe verdict is a hard False: a read
        with no probe, cheap enough for the request path."""
        dh = self.device_health
        return dh is not None and dh.last_verdict() is False

    # -- device -----------------------------------------------------------
    async def probe_device(self) -> Optional[bool]:
        """The DeviceHealth verdict; None when nothing is probed (a fake
        backend). Off the event loop: the probe blocks up to its timeout
        on a wedged card."""
        if self.device_health is None:
            return None
        loop = asyncio.get_running_loop()
        ok, _ = await loop.run_in_executor(None, self.device_health.check)
        return ok

    # -- fused signal -----------------------------------------------------
    @property
    def degraded(self) -> bool:
        """True while ANY detector is unhappy: open/half-open breaker or
        a recent dispatch overrun. Queues tighten rejection thresholds on
        this; `/readyz` flips 503."""
        return (
            self.watchdog_degraded
            or self.device_lost is not None
            or self.content_breaker.state != "closed"
            or self.score_breaker.state != "closed"
        )

    def shed_scores(self) -> bool:
        """Should the API refuse scoring work outright (503) instead of
        returning floor scores? Only when the breaker KNOWS the scorer is
        dark — half-open still lets the probe traffic through."""
        return self.score_breaker.state == OPEN

    def retry_after_s(self) -> float:
        """Seconds a shed client should wait: the longest of the open
        breakers' cooldown remainders and the watchdog window (floor 1)."""
        with self._lock:
            watchdog = max(0.0, self._degraded_until - self.clock())
        return max(
            1.0,
            watchdog,
            # a rebuild (re-upload + re-warm) takes seconds at best:
            # don't invite shed clients back mid-recovery
            5.0 if self.device_lost is not None else 0.0,
            self.content_breaker.seconds_until_half_open(),
            self.score_breaker.seconds_until_half_open(),
        )

    def status(self, device_ok: Optional[bool] = None,
               include_events: bool = False) -> Dict[str, object]:
        """The `/readyz` body. ``device_ok`` is the (executor-run)
        DeviceHealth verdict when the caller has one; None = no device to
        probe (fake backend). ``include_events`` embeds the flight-
        recorder tail in a degraded verdict — the HTTP layer sets it
        only for loopback callers (the same internal-state boundary
        `/debugz` enforces; remote probes get the verdict, not the
        event history)."""
        degraded = self.degraded
        lost = self.device_lost
        ready = not degraded and device_ok is not False
        with self._lock:
            watchdog = {
                "degraded": self.clock() < self._degraded_until,
                "overruns": self._overruns,
                "degraded_for_s": max(
                    0.0, self._degraded_until - self.clock()),
            }
        metrics.gauge("supervisor.degraded", 0.0 if ready else 1.0)
        status: Dict[str, object] = {
            "ready": ready,
            # device_lost is its own named state
            "state": ("device_lost" if lost is not None
                      else "ok" if ready else "degraded"),
            "breakers": {
                b.name: b.snapshot()
                for b in (self.content_breaker, self.score_breaker)
            },
            "watchdog": watchdog,
            "device": device_ok,
        }
        if lost is not None:
            status["device_lost"] = {"reason": lost}
        stages = self.stage_health()
        if stages:
            status["stages"] = stages
        from cassmantle_tpu_torch import chaos

        if chaos.armed():
            # a drill must never read as an incident: whenever a fault
            # plan is armed, BOTH probe surfaces say so (healthz embeds
            # this same status block)
            status["chaos"] = chaos.status()
        if self.fabric_status is not None:
            try:
                status["fabric"] = self.fabric_status()
            except Exception:
                # advisory: a torn membership snapshot never breaks the
                # readiness verdict
                log.exception("fabric status failed")
                status["fabric"] = {"error": "unavailable"}
        if not ready and include_events:
            # a degraded verdict carries the recent event history that
            # explains it — the flight-recorder tail (trip order,
            # watchdog fires, reserve rotations), not just end states
            status["events"] = flight_recorder.tail(25)
        return status
