"""Device-loss detection and serving-state rebuild.

A port of ``cassmantle_tpu/serving/device_recovery.py`` (``:45-245``):

- :func:`classify_device_loss` decides whether an exception from a
  dispatch region means the device runtime is gone, as opposed to a
  data-dependent failure (``OutputInvalid``), a deadline, backpressure or
  running out of memory (``torch.OutOfMemoryError`` is never a loss). It
  walks the cause/context chain and matches type names (the reference's
  ``XlaRuntimeError`` and ``DeadBufferError``, and CUDA's
  ``torch.AcceleratorError`` and ``torch.cuda.CudaError``) and message
  markers (the reference's, the ``device.lost`` chaos fault point, and
  the CUDA driver's: an illegal memory access, a device-side assert, an
  unspecified launch failure, an uncorrectable ECC error, an
  insufficient driver, a device that is not ready, ...).
- :class:`DeviceRecoveryManager` owns the single-flight recovery: flip
  the supervisor into ``device_lost`` (the queues fail fast), then on a
  background thread rebuild serving state (the pipelines reload their
  parameters in place; a meshed image pipeline then re-places every
  other card's replica from the rebuilt models, in place, so every
  position's graphs stay valid) and warm the hot dispatch path under
  ``ops/graphs.py::no_new_captures``. Bounded retries with backoff spend
  a :class:`~cassmantle_tpu_torch.utils.retry.RetryBudget`; exhaustion is
  permanent loss: the worker stays ``device_lost`` and ``on_permanent``
  fires.

Sticky CUDA errors: after an illegal memory access or a device-side
assert, the process's CUDA context is unusable, every later CUDA call
fails with the same error, and no rebuild inside the process can
succeed. Such a loss runs the manager's bounded attempts, each failing,
and ends in permanent ``device_lost``: the reference's exhaustion path,
which tells the operator to replace the worker. A chaos ``device.lost``
leaves the context healthy, and there the in-place rebuild succeeds.

Kill switch: ``CASSMANTLE_NO_DEVICE_RECOVERY`` disables the rebuild only
(a classified loss still flips the supervisor); read per call.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.logging import get_logger, metrics
from cassmantle_tpu_torch.utils.retry import RetryBudget

log = get_logger("device_recovery")

# Exception type names (matched anywhere in the cause/context chain)
# that mean the device runtime itself failed: the reference's, and
# torch's for CUDA errors (``torch.AcceleratorError``,
# ``torch.cuda.CudaError``). Name-matched, not isinstance, so tests can
# raise look-alikes without a dead device to hand.
_LOSS_TYPES = frozenset({"XlaRuntimeError", "DeadBufferError",
                         "AcceleratorError", "CudaError"})

# Never a loss, whatever the message: running out of device memory is
# load, and the context stays healthy.
_NOT_LOSS_TYPES = frozenset({"OutOfMemoryError"})

# Message substrings (lowercased) that mark runtime loss even under a
# generic exception type. "device.lost" is the chaos fault-point name —
# ChaosInjected carries it, so drills classify like real losses.
_LOSS_MARKERS = (
    "device.lost",
    "device is lost",
    "device lost",
    "runtime is gone",
    "data transfer failed",
    "failed to enqueue",
    "hardware failure",
    "tpu driver",
    # the CUDA driver's sticky and fatal errors, as torch words them
    "illegal memory access",
    "illegal instruction",
    "misaligned address",
    "device-side assert",
    "unspecified launch failure",
    "uncorrectable ecc",
    "cuda driver version is insufficient",
    "device not ready",
    "cuda-capable device(s) is/are busy or unavailable",
    "gpu has fallen off the bus",
    "launch timed out",
)


def recovery_disabled() -> bool:
    """CASSMANTLE_NO_DEVICE_RECOVERY kill switch, read per-call."""
    return os.environ.get(
        "CASSMANTLE_NO_DEVICE_RECOVERY", ""
    ).lower() not in ("", "0", "false", "no", "off")


def classify_device_loss(exc: BaseException) -> Optional[str]:
    """A short reason string when ``exc`` (or anything in its
    cause/context chain) looks like accelerator-runtime loss, else
    None. Deliberately conservative: deadlines, backpressure, and
    invalid-output and out-of-memory failures are NOT losses —
    misclassifying those would bounce serving through a needless
    rebuild."""
    seen = set()
    node: Optional[BaseException] = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        name = type(node).__name__
        if name in _NOT_LOSS_TYPES:
            return None
        if name in _LOSS_TYPES:
            return f"{name}: {str(node)[:120]}"
        text = str(node).lower()
        for marker in _LOSS_MARKERS:
            if marker in text:
                return f"{name}: {marker}"
        node = node.__cause__ or node.__context__
    return None


class DeviceRecoveryManager:
    """Single-flight device-loss recovery.

    ``rebuild`` performs ONE rebuild attempt (re-upload params; raises
    on failure); ``warm`` optionally re-drives the hot paths after a
    successful rebuild (a failure there fails the attempt — a rebuilt
    device that cannot serve is not recovered). Both run on the
    manager's daemon thread, never on a dispatch thread.
    """

    def __init__(
        self,
        *,
        supervisor,
        rebuild: Callable[[], None],
        warm: Optional[Callable[[], None]] = None,
        on_permanent: Optional[Callable[[str], None]] = None,
        max_attempts: int = 3,
        backoff_s: float = 2.0,
        budget: Optional[RetryBudget] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.supervisor = supervisor
        self.rebuild = rebuild
        self.warm = warm
        # default None leaves the worker device_lost: the readiness
        # 503 is the drain signal
        self.on_permanent = on_permanent
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        # rebuilds re-upload multi-GB checkpoints: a flapping device
        # must not melt the host re-reading them in a tight loop. ~6
        # attempts burst, one earned back per minute.
        self.budget = budget or RetryBudget(
            "device_recovery", capacity=6.0, refill_per_s=1.0 / 60.0,
            clock=clock)
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.Lock()
        self._recovering = False
        self._thread: Optional[threading.Thread] = None
        self.permanent = False

    # -- classification entry points --------------------------------------
    def note_dispatch_exception(self, exc: BaseException) -> bool:
        """Called from dispatch error paths (BatchingQueue
        ``on_dispatch_error``, the service's generate/similarity arms).
        Returns True when ``exc`` classified as device loss (recovery
        has been kicked off or is already in flight)."""
        reason = classify_device_loss(exc)
        if reason is None:
            return False
        self.begin_recovery(reason)
        return True

    # DeviceHealth probe raises funnel through the same classifier; a
    # probe that RAISES (vs times out) carries the runtime's own error
    note_probe_exception = note_dispatch_exception

    # -- recovery ----------------------------------------------------------
    def begin_recovery(self, reason: str) -> None:
        """Flip the supervisor and start the single-flight rebuild
        thread. Re-entrant: concurrent classifications during an active
        recovery (every queue fails fast with the same root cause)
        coalesce into the one in-flight attempt."""
        with self._lock:
            if self._recovering or self.permanent:
                return
            self._recovering = True
        self.supervisor.note_device_lost(reason)
        if recovery_disabled():
            log.error(
                "device recovery disabled (CASSMANTLE_NO_DEVICE_RECOVERY);"
                " worker stays device_lost: %s", reason)
            with self._lock:
                self._recovering = False
            return
        thread = threading.Thread(
            target=self._recover, args=(reason,), daemon=True,
            name="device-recovery")
        with self._lock:
            self._thread = thread
        thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight recovery thread (tests, drills)."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout)

    @property
    def recovering(self) -> bool:
        with self._lock:
            return self._recovering

    def _recover(self, reason: str) -> None:
        start = self.clock()
        try:
            for attempt in range(1, self.max_attempts + 1):
                if not self.budget.acquire():
                    log.error("device recovery: retry budget exhausted "
                              "after %d attempt(s)", attempt - 1)
                    break
                try:
                    self.rebuild()
                    if self.warm is not None:
                        self.warm()
                except Exception as exc:
                    log.exception("device recovery attempt %d/%d failed",
                                  attempt, self.max_attempts)
                    flight_recorder.record(
                        "device.recovery_failed", attempt=attempt,
                        error=f"{type(exc).__name__}: {str(exc)[:160]}")
                    if attempt < self.max_attempts:
                        self.sleep(self.backoff_s * attempt)
                    continue
                elapsed = self.clock() - start
                metrics.inc("device.recoveries")
                metrics.observe("device.recovery_s", elapsed)
                self.supervisor.note_device_recovered()
                log.warning("device recovered in %.2fs (attempt %d/%d)",
                            elapsed, attempt, self.max_attempts)
                return
            # attempts (or budget) exhausted: permanent loss. The worker
            # stays device_lost — queues fail fast, /readyz serves 503
            # until the operator replaces it.
            self.permanent = True
            metrics.inc("device.recovery_permanent")
            flight_recorder.record("device.recovery_permanent",
                                   reason=reason)
            log.critical(
                "device recovery FAILED permanently (%s); worker stays "
                "device_lost — drain and replace it", reason)
            if self.on_permanent is not None:
                try:
                    self.on_permanent(reason)
                except Exception:
                    log.exception("permanent-loss drain hook failed")
        finally:
            with self._lock:
                self._recovering = False
