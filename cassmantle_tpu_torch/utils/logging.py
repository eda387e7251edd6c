"""Namespaced loggers and the in-process metrics registry.

A copy of ``cassmantle_tpu/utils/logging.py`` trimmed to what the serving
seam uses: :func:`get_logger` (``:84-100``) and the :class:`Metrics`
registry (``:184-419``: counters, gauges, fixed-bucket histograms,
``counter_total``, ``gauge_values``, ``hist_totals``, ``timer``,
``snapshot``). The
Prometheus/OpenMetrics expositions, exemplars and federation belong to
the server, a later slice.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-shaped default bounds: sub-ms host work through cold-build
# minutes.
DEFAULT_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_LOGGER_LOCK = threading.Lock()


def get_logger(name: str) -> logging.Logger:
    """``cassmantle.<name>``, with one stream handler on the tree's root."""
    logger = logging.getLogger(f"cassmantle.{name}")
    root = logging.getLogger("cassmantle")
    if not root.handlers:
        with _LOGGER_LOCK:
            if not root.handlers:
                handler = logging.StreamHandler()
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s %(message)s"))
                root.addHandler(handler)
                root.setLevel(logging.INFO)
                root.propagate = False
    return logger


LabelsKey = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelsKey]


def _series_key(name: str, labels: Optional[Dict[str, str]]) -> SeriesKey:
    if not labels:
        return name, ()
    return name, tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(key: SeriesKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Histogram:
    """Cumulative fixed-bucket histogram: constant memory per series,
    percentiles by in-bucket linear interpolation."""

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds: Sequence[float]) -> None:
        self.bounds = tuple(sorted(float(b) for b in bounds))
        assert self.bounds, "histogram needs at least one bucket bound"
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += 1
        self.sum += float(value)

    def quantile(self, q: float) -> float:
        """The q-quantile (0..1); the overflow bucket reports the top
        finite bound."""
        if self.total == 0:
            return 0.0
        rank = q * self.total
        cum = 0
        for i, count in enumerate(self.counts):
            if count and cum + count >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * ((rank - cum) / count)
            cum += count
        return self.bounds[-1]

    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0


class Metrics:
    """Thread-safe counters, gauges and histograms. One global registry
    per process (:data:`metrics`); instantiable standalone."""

    def __init__(self,
                 default_buckets: Sequence[float] = DEFAULT_BUCKETS_S
                 ) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[SeriesKey, float] = {}
        self._gauges: Dict[SeriesKey, float] = {}
        self._hists: Dict[SeriesKey, Histogram] = {}
        self._default_buckets = tuple(default_buckets)

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_series_key(name, labels)] = value

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Record into the series' histogram; ``buckets`` applies only on
        the series' first observation."""
        key = _series_key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = Histogram(buckets or self._default_buckets)
                self._hists[key] = hist
            hist.observe(value)

    @contextmanager
    def timer(self, name: str, labels: Optional[Dict[str, str]] = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - start, labels=labels)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all its label sets."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def gauge_values(self, name: str) -> List[float]:
        """Every label set's current value of a gauge."""
        with self._lock:
            return [v for (n, _), v in self._gauges.items() if n == name]

    def hist_totals(self, name: str
                    ) -> Optional[Tuple[Tuple[float, ...],
                                        Tuple[int, ...], int]]:
        """(bounds, bucket counts, total) for a histogram, summed across
        label sets sharing the first-seen bounds (one process = one
        bucket ladder per name by construction); None when the series
        has never been observed. The SLO engine's latency objectives
        read this (obs/slo.py)."""
        with self._lock:
            bounds = None
            counts: List[int] = []
            total = 0
            for (n, _), h in self._hists.items():
                if n != name:
                    continue
                if bounds is None:
                    bounds = h.bounds
                    counts = list(h.counts)
                    total = h.total
                elif h.bounds == bounds:
                    counts = [a + b for a, b in zip(counts, h.counts)]
                    total += h.total
            if bounds is None:
                return None
            return bounds, tuple(counts), total

    def snapshot(self) -> Dict[str, object]:
        """Flat counters and gauges, and ``{count, mean_s, p50_s, p99_s}``
        per histogram (the reference's JSON shape)."""
        with self._lock:
            return {
                "counters": {_flat_name(k): v
                             for k, v in self._counters.items()},
                "gauges": {_flat_name(k): v
                           for k, v in self._gauges.items()},
                "timings": {
                    _flat_name(k): {"count": h.total, "mean_s": h.mean(),
                                    "p50_s": h.quantile(0.5),
                                    "p99_s": h.quantile(0.99)}
                    for k, h in self._hists.items() if h.total},
            }


class _NullMetrics:
    """A no-op registry with the Metrics emission surface: a canary Game
    runs the real engine paths but leaves no marks on player-facing
    series. Reads are not supported: nothing aggregates from a null
    sink."""

    def inc(self, name, value=1.0, labels=None):
        pass

    def gauge(self, name, value, labels=None):
        pass

    def observe(self, name, value, labels=None, buckets=None):
        pass

    @contextmanager
    def timer(self, name, labels=None):
        yield


NULL_METRICS = _NullMetrics()

metrics = Metrics()
