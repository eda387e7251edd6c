"""Per-worker device telemetry: device memory, per-pipeline highwater.

Port of ``cassmantle_tpu/obs/device.py``. Per visible CUDA device, read
from ``torch.cuda.memory_stats`` and the device's properties in place of
``jax.local_devices()`` and ``memory_stats()``:

- ``device.hbm_bytes_in_use`` (allocated bytes), ``device.hbm_peak_bytes``
  (their peak) and ``device.hbm_bytes_limit`` (the card's memory), labeled
  ``device=cuda:<i>``, refreshed on every ``/metrics`` scrape and by a
  background loop (``ObsConfig.process_sample_interval_s``);
- ``device.hbm_available``: 1, or 0 with no byte gauges at all where a
  device has no such telemetry (a CPU device), never zeros that would
  read as an empty card;
- ``device.hbm_highwater_bytes`` (labeled ``pipeline=``): the most bytes
  in use seen at a pipeline's dispatch boundary (:func:`note_dispatch`).

The device is an argument: ``DeviceMetrics()`` reads the CUDA devices and
raises on a host without CUDA; ``device="cpu"`` reports its device as
unavailable; the tests pass ``devices_fn`` and ``stats_fn``. A read never
initializes CUDA: before the process has, there are no devices to report.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Dict, Optional

import torch

from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("obs.device")

#: stats key -> exported gauge; only present keys export
_STAT_GAUGES = (
    ("bytes_in_use", "device.hbm_bytes_in_use"),
    ("bytes_limit", "device.hbm_bytes_limit"),
    ("peak_bytes_in_use", "device.hbm_peak_bytes"),
)


def _cuda_devices():
    """Every visible CUDA device, once the process has initialized CUDA."""
    if not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _memory_stats(device: torch.device) -> Optional[Dict[str, float]]:
    """A CUDA device's stats under the reference's keys: the caching
    allocator's allocated bytes and their peak, and the card's total
    memory. None for any other device."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                 0)),
            "bytes_limit": float(
                torch.cuda.get_device_properties(device).total_memory)}


def _device_label(device: torch.device) -> str:
    return f"{device.type}:{device.index or 0}"


class DeviceMetrics:
    """Device-memory gauges and per-pipeline dispatch-boundary highwater."""

    def __init__(self, registry=None, devices_fn=None,
                 device: DeviceLike = "cuda", stats_fn=None) -> None:
        self._registry = registry if registry is not None else metrics
        self._stats_fn = stats_fn if stats_fn is not None else _memory_stats
        if devices_fn is None:
            dev = resolve_device(device)
            devices_fn = (_cuda_devices if dev.type == "cuda"
                          else (lambda: [dev]))
        self._devices_fn = devices_fn
        self._lock = threading.Lock()
        self._highwater: Dict[str, float] = {}
        self._last: Dict[str, Optional[Dict[str, float]]] = {}

    def _stats(self, device) -> Optional[Dict[str, float]]:
        """``device``'s stats, or None where it has none, where the read
        raises, or where it names none of the exported keys."""
        try:
            stats = self._stats_fn(device)
        except Exception:
            return None
        if not isinstance(stats, dict) or \
                not any(k in stats for k, _ in _STAT_GAUGES):
            return None
        return stats

    def sample(self) -> Dict[str, Optional[Dict[str, float]]]:
        """Refresh the per-device gauges; returns {label: stats or None}."""
        seen: Dict[str, Optional[Dict[str, float]]] = {}
        try:
            devices = self._devices_fn()
        except Exception:
            log.exception("device list unavailable; memory gauges not "
                          "refreshed")
            return {}
        for dev in devices:
            label = _device_label(dev)
            stats = self._stats(dev)
            seen[label] = stats
            labels = {"device": label}
            if stats is None:
                # explicit unavailability, and no frozen byte gauges
                self._registry.gauge("device.hbm_available", 0.0,
                                     labels=labels)
                for _, gauge in _STAT_GAUGES:
                    self._registry.remove_gauge(gauge, labels=labels)
                continue
            self._registry.gauge("device.hbm_available", 1.0, labels=labels)
            for key, gauge in _STAT_GAUGES:
                if key in stats:
                    self._registry.gauge(gauge, float(stats[key]),
                                         labels=labels)
                else:
                    self._registry.remove_gauge(gauge, labels=labels)
        with self._lock:
            self._last = seen
        return seen

    def note_dispatch(self, pipeline: str) -> None:
        """After a pipeline's dispatch: the most bytes in use on any
        device, kept per pipeline. A no-op where no device has telemetry."""
        try:
            worst, seen_any = 0.0, False
            for dev in self._devices_fn():
                stats = self._stats(dev)
                if stats is None or "bytes_in_use" not in stats:
                    continue
                seen_any = True
                worst = max(worst, float(stats["bytes_in_use"]))
            if not seen_any:
                return
            with self._lock:
                if worst <= self._highwater.get(pipeline, 0.0):
                    return
                self._highwater[pipeline] = worst
                # under the lock: map update and export stay atomic
                self._registry.gauge("device.hbm_highwater_bytes", worst,
                                     labels={"pipeline": pipeline})
        except Exception:  # telemetry never breaks a dispatch
            log.exception("device memory highwater sample failed")

    def highwater(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._highwater)

    def device_block(self) -> Dict[str, object]:
        """The ``/readyz`` ``device_telemetry`` block: per-device bytes (or
        ``"unavailable"``), per-pipeline highwater, and the CUDA graphs
        captured so far (the port's counterpart of the reference's compile
        summary)."""
        from cassmantle_tpu_torch.ops import graphs

        devices: Dict[str, object] = {}
        for label, stats in self.sample().items():
            devices[label] = ("unavailable" if stats is None else
                              {key: int(stats[key]) for key, _ in _STAT_GAUGES
                               if key in stats})
        return {
            "devices": devices,
            "hbm_highwater_bytes": {k: int(v)
                                    for k, v in self.highwater().items()},
            "compile": {"graph_captures": graphs.capture_count()},
        }

    async def run(self, interval_s: float = 5.0) -> None:
        """Background sampler beside the process sampler."""
        self.sample()
        while True:
            await asyncio.sleep(interval_s)
            self.sample()


#: the instance pipelines report dispatches to; the server installs its own
_ACTIVE: Optional[DeviceMetrics] = None


def install(dm: Optional[DeviceMetrics]) -> None:
    """Make ``dm`` the instance :func:`note_dispatch` reports to (None:
    none)."""
    global _ACTIVE
    _ACTIVE = dm


def active() -> Optional[DeviceMetrics]:
    return _ACTIVE


def note_dispatch(pipeline: str) -> None:
    dm = _ACTIVE
    if dm is not None:
        dm.note_dispatch(pipeline)
