"""Process self-metrics: uptime, resident memory, CPU and event-loop lag.

A copy of ``cassmantle_tpu/obs/process.py``: ``process.uptime_s``,
``process.rss_bytes`` (``/proc/self/statm``; where there is no procfs,
``getrusage``'s peak, a ceiling), ``process.cpu_s`` (user + system) and
``server.loop_lag_s``, the overshoot of the sampler's own sleep: how long
a ready callback waited behind whatever held the event loop, which the
WS clock and every handler share. The sampler task refreshes all four
(``ObsConfig.process_sample_interval_s``); a ``/metrics`` scrape
refreshes the first three. Standard library only.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Callable

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("obs.process")

try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):
    _PAGE_SIZE = 4096


class ProcessMetrics:
    def __init__(self, registry=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._registry = registry if registry is not None else metrics
        self._clock = clock
        self._start = clock()

    def rss_bytes(self) -> float:
        try:
            with open("/proc/self/statm") as f:
                return float(f.read().split()[1]) * _PAGE_SIZE
        except Exception:
            import resource

            # ru_maxrss is PEAK rss in KiB on linux — a ceiling, used
            # only where procfs is absent
            return float(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            ) * 1024.0

    def cpu_seconds(self) -> float:
        t = os.times()
        return float(t.user + t.system)

    def sample(self) -> None:
        """Refresh the three process gauges (cheap: two syscalls and a
        procfs read — safe on every scrape)."""
        self._registry.gauge("process.uptime_s",
                             self._clock() - self._start)
        self._registry.gauge("process.rss_bytes", self.rss_bytes())
        self._registry.gauge("process.cpu_s", self.cpu_seconds())

    async def run(self, interval_s: float = 5.0) -> None:
        """Background sampler: process gauges plus the event-loop lag
        probe — the overshoot of our own sleep is exactly how long a
        ready callback waited behind whatever clogged the loop."""
        loop = asyncio.get_running_loop()
        self._registry.gauge("server.loop_lag_s", 0.0)
        self.sample()
        while True:
            t0 = loop.time()
            await asyncio.sleep(interval_s)
            lag = max(0.0, (loop.time() - t0) - interval_s)
            self._registry.gauge("server.loop_lag_s", lag)
            self.sample()
