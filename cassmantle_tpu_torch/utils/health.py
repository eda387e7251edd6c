"""Device liveness: a tiny probe on the card with a deadline, cached.

Port of ``cassmantle_tpu/utils/health.py``. The probe puts a fixed
8-element tensor on the device, runs ``(v * 2).sum()``, synchronizes its
thread's stream and compares with 56.0 (the reference's jitted probe); a
wedged card hangs instead of raising, so the probe runs on a daemon
thread and a caller waits at most ``timeout_s``. The verdict is cached
``cache_s`` so health polling cannot pile probes onto the device. The
device is an argument (default ``cuda``): a host without CUDA raises at
construction, and a probe that raises is a verdict (False), never a
skipped check.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from cassmantle_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    synchronize,
)
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("health")


def _probe_once(device: torch.device) -> bool:
    v = torch.arange(8, dtype=torch.float32, device=device)
    y = (v * 2.0).sum()
    # this thread's stream only: a device-wide synchronize would break
    # another thread's graph capture (ops/graphs.py)
    synchronize(device)
    return float(y.item()) == 56.0


class _Probe:
    """One probe on a daemon thread: a stuck device call cannot be
    cancelled, only disowned."""

    def __init__(self, device: torch.device) -> None:
        self.done = threading.Event()
        self.ok = False
        # the exception when the probe raised (vs hung or miscomputed):
        # the recovery manager can classify it as device loss
        self.exc: Optional[BaseException] = None
        self.started_at = time.monotonic()
        threading.Thread(target=self._run, args=(device,), daemon=True,
                         name="device-probe").start()

    def _run(self, device: torch.device) -> None:
        try:
            self.ok = bool(_probe_once(device))
        except Exception as exc:
            log.warning("device probe failed: %s", exc)
            self.ok = False
            self.exc = exc
        self.done.set()


class DeviceHealth:
    """Cached device-liveness prober. ``check()`` returns (healthy, age_s);
    a probe past ``timeout_s`` marks the device unhealthy without holding
    the caller longer, and is replaced once it is twice that old."""

    def __init__(self, timeout_s: float = 10.0, cache_s: float = 15.0,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.timeout_s = timeout_s
        self.cache_s = cache_s
        self._lock = OrderedLock("health.device", rank=50)
        self._healthy: Optional[bool] = None
        self._checked_at = 0.0
        self._inflight: Optional[_Probe] = None
        # the class behind a False verdict: "timeout", "raise:<Type>" or
        # "miscompute"; None while healthy or unknown
        self._failure: Optional[str] = None
        # wired by the server (DeviceRecoveryManager.note_probe_exception):
        # called outside the lock with a probe's exception
        self.on_probe_error = None

    def last_verdict(self) -> Optional[bool]:
        """The cached verdict, with no probe: the request path's read."""
        with self._lock:
            return self._healthy

    def last_failure(self) -> Optional[str]:
        with self._lock:
            return self._failure

    def invalidate(self) -> None:
        """Drop the cached verdict (a rebuilt runtime is probed afresh)."""
        with self._lock:
            self._healthy = None
            self._failure = None
            self._checked_at = 0.0

    def check(self) -> tuple:
        with self._lock:
            age = time.monotonic() - self._checked_at
            if self._healthy is not None and age < self.cache_s:
                return self._healthy, age
            stale = (self._inflight is not None
                     and not self._inflight.done.is_set()
                     and time.monotonic() - self._inflight.started_at
                     > 2 * self.timeout_s)
            if self._inflight is None or stale:
                self._inflight = _Probe(self.device)
            probe = self._inflight
        if probe.done.wait(timeout=self.timeout_s):
            ok = probe.ok
            failure = (None if ok else
                       f"raise:{type(probe.exc).__name__}"
                       if probe.exc is not None else "miscompute")
        else:
            ok = False
            failure = "timeout"
            log.warning("device probe exceeded %.1fs (device hung?)",
                        self.timeout_s)
        with self._lock:
            if probe.done.is_set():
                self._inflight = None
            self._healthy = ok
            self._failure = failure
            self._checked_at = time.monotonic()
        metrics.gauge("health.device_ok", 1.0 if ok else 0.0)
        hook = self.on_probe_error
        if probe.exc is not None and hook is not None:
            try:
                hook(probe.exc)
            except Exception:
                log.exception("probe-error hook failed")
        return ok, 0.0
