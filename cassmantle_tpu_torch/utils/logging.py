"""Namespaced loggers and the in-process metrics registry.

A copy of ``cassmantle_tpu/utils/logging.py``: :func:`get_logger` and the
:class:`Metrics` registry (counters, gauges, fixed-bucket histograms with
exemplars, ``counter_total``, ``gauge_values``, ``hist_totals``,
``timer``, the JSON ``snapshot`` and the Prometheus and OpenMetrics text
expositions the server's ``/metrics`` serves), and cluster federation:
``dump_state`` is a registry's full state as a peer ships it and
:func:`merge_states` folds the workers' states into one registry
(counters sum, gauges take a ``worker`` label, histograms with the same
bounds add bucket by bucket).
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from collections import OrderedDict
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
    percentiles by in-bucket linear interpolation. ``exemplars`` maps a
    bucket to the last retained trace that landed in it, ``(trace_id,
    value, unix_ts)``: a p99 bucket dereferences to ``/debugz?trace=``."""

    __slots__ = ("bounds", "counts", "total", "sum", "exemplars")

    def __init__(self, bounds: Sequence[float]) -> None:
        self.bounds = tuple(sorted(float(b) for b in bounds))
        assert self.bounds, "histogram needs at least one bucket bound"
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.total = 0
        self.sum = 0.0
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}

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


def _prom_name(name: str, labels: LabelsKey) -> Tuple[str, str]:
    """(metric name, label suffix) in Prometheus grammar: dots and dashes
    to underscores, the ``cassmantle_`` prefix, ``_s`` to ``_seconds``."""
    base = name.replace(".", "_").replace("-", "_")
    if base.endswith("_s"):
        base = base[:-2] + "_seconds"
    suffix = ""
    if labels:
        inner = ",".join(
            '{}="{}"'.format(k, v.replace("\\", "\\\\").replace('"', '\\"'))
            for k, v in labels)
        suffix = "{" + inner + "}"
    return "cassmantle_" + base, suffix


def _fmt(v: float) -> str:
    return repr(v) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


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
        # exemplars: an injected source answers "which trace is this
        # observation from, and is it already retained?" as (trace_id,
        # certain). Certain ones land in their bucket at once; the others
        # (a tail-pending trace) park until retain_exemplars or
        # discard_exemplars settles them. A fresh registry has no source.
        self._exemplar_source = None
        self._exemplar_pending: \
            "OrderedDict[str, List[Tuple[Histogram, int, float, float]]]" \
            = OrderedDict()
        self._exemplar_pending_cap = 256

    def set_default_buckets(self, bounds: Sequence[float]) -> None:
        """Default bounds of histograms created after this call (existing
        series keep theirs)."""
        with self._lock:
            self._default_buckets = tuple(bounds)

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_series_key(name, labels)] = value

    def remove_gauge(self, name: str,
                     labels: Optional[Dict[str, str]] = None) -> None:
        """Retract a gauge whose source is gone: absence, not a frozen
        last value (obs/device.py)."""
        with self._lock:
            self._gauges.pop(_series_key(name, labels), None)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Record into the series' histogram; ``buckets`` applies only on
        the series' first observation."""
        key = _series_key(name, labels)
        source = self._exemplar_source
        tagged = source() if source is not None else None
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = Histogram(buckets or self._default_buckets)
                self._hists[key] = hist
            hist.observe(value)
            if tagged is not None:
                trace_id, certain = tagged
                idx = bisect.bisect_left(hist.bounds, value)
                if certain:
                    hist.exemplars[idx] = (trace_id, float(value),
                                           time.time())
                else:
                    slots = self._exemplar_pending.get(trace_id)
                    if slots is None:
                        slots = self._exemplar_pending[trace_id] = []
                        while len(self._exemplar_pending) > \
                                self._exemplar_pending_cap:
                            self._exemplar_pending.popitem(last=False)
                    slots.append((hist, idx, float(value), time.time()))

    # -- exemplars ----------------------------------------------------------
    def set_exemplar_source(self, fn) -> None:
        """Install ``fn() -> None | (trace_id, certain)``, asked on every
        histogram observation (obs/trace.py owns the policy)."""
        self._exemplar_source = fn

    def retain_exemplars(self, trace_id: str) -> None:
        """A pending trace was retained: its parked observations become
        their buckets' exemplars."""
        with self._lock:
            for hist, idx, value, ts in \
                    self._exemplar_pending.pop(trace_id, ()):
                hist.exemplars[idx] = (trace_id, value, ts)

    def discard_exemplars(self, trace_id: str) -> None:
        """A pending trace was dropped: its observations never surface."""
        with self._lock:
            self._exemplar_pending.pop(trace_id, None)

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

    # -- federation (cluster /metrics, server/app.py) ----------------------
    def dump_state(self) -> Dict[str, list]:
        """The registry's full state as JSON-able lists, what a peer ships
        for federation: unlike :meth:`snapshot`, histogram buckets
        survive, so a merge is exact."""
        with self._lock:
            return {
                "counters": [[k[0], [list(p) for p in k[1]], v]
                             for k, v in self._counters.items()],
                "gauges": [[k[0], [list(p) for p in k[1]], v]
                           for k, v in self._gauges.items()],
                "hists": [[k[0], [list(p) for p in k[1]],
                           list(h.bounds), list(h.counts), h.sum, h.total]
                          for k, h in self._hists.items()],
            }

    def merge_hist_state(self, name: str, labels: Optional[Dict[str, str]],
                         bounds: Sequence[float], counts: Sequence[int],
                         total_sum: float, total: int) -> bool:
        """Fold one shipped histogram into this registry: with the same
        bounds the bucket counts add; on a bounds mismatch nothing changes
        and False returns, so the caller keeps a per-worker series
        instead of mis-binning."""
        bounds = tuple(float(b) for b in bounds)
        key = _series_key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = Histogram(bounds)
            if hist.bounds != bounds:
                return False
            hist.counts = [a + int(b) for a, b in zip(hist.counts, counts)]
            hist.total += int(total)
            hist.sum += float(total_sum)
            return True

    def snapshot(self, exemplars: bool = False) -> Dict[str, object]:
        """Flat counters and gauges, and ``{count, mean_s, p50_s, p99_s}``
        per histogram (the reference's JSON shape); ``exemplars=True``
        adds, per histogram and bucket bound, the last retained trace."""
        with self._lock:
            out: Dict[str, object] = {
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
            if exemplars:
                ex: Dict[str, dict] = {}
                for key, h in self._hists.items():
                    if h.exemplars:
                        ex[_flat_name(key)] = {
                            ("+Inf" if idx >= len(h.bounds)
                             else repr(float(h.bounds[idx]))):
                            {"trace_id": tid, "value": value, "ts": ts}
                            for idx, (tid, value, ts)
                            in sorted(h.exemplars.items())}
                out["exemplars"] = ex
            return out

    def _exposition(self, openmetrics: bool) -> str:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (h.bounds, tuple(h.counts), h.sum, h.total,
                         dict(h.exemplars))
                     for k, h in self._hists.items()}
        lines: List[str] = []
        typed = set()

        def emit_type(pname: str, kind: str) -> None:
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {kind}")

        def exemplar(ex) -> str:
            if ex is None or not openmetrics:
                return ""
            trace_id, value, ts = ex
            return (f' # {{trace_id="{trace_id}"}} '
                    f"{repr(float(value))} {repr(float(ts))}")

        for key in sorted(counters):
            pname, suffix = _prom_name(key[0], key[1])
            # OpenMetrics declares a counter on its base name
            emit_type(pname if openmetrics else pname + "_total",
                      "counter")
            lines.append(f"{pname}_total{suffix} {_fmt(counters[key])}")
        for key in sorted(gauges):
            pname, suffix = _prom_name(key[0], key[1])
            emit_type(pname, "gauge")
            lines.append(f"{pname}{suffix} {_fmt(gauges[key])}")
        for key in sorted(hists):
            bounds, counts, total_sum, total, exemplars = hists[key]
            pname, suffix = _prom_name(key[0], key[1])
            emit_type(pname, "histogram")
            label_body = suffix[1:-1] + "," if suffix else ""
            cum = 0
            for i, (bound, count) in enumerate(zip(bounds, counts)):
                cum += count
                lines.append(
                    f'{pname}_bucket{{{label_body}le="{_fmt(bound)}"}} '
                    f"{cum}{exemplar(exemplars.get(i))}")
            cum += counts[-1]
            lines.append(f'{pname}_bucket{{{label_body}le="+Inf"}} {cum}'
                         f"{exemplar(exemplars.get(len(bounds)))}")
            lines.append(f"{pname}_sum{suffix} {repr(float(total_sum))}")
            lines.append(f"{pname}_count{suffix} {total}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def prometheus(self) -> str:
        """Text exposition, format 0.0.4: counters as ``*_total``, gauges,
        histograms as cumulative ``_bucket{le=...}``, ``_sum``, ``_count``;
        sorted, so scrapes are stable. No exemplars."""
        return self._exposition(openmetrics=False)

    def openmetrics(self) -> str:
        """OpenMetrics 1.0: the same series, counters typed on their base
        name, exemplars on the ``_bucket`` lines, and ``# EOF``."""
        return self._exposition(openmetrics=True)


def _parse_labels(raw) -> Optional[Dict[str, str]]:
    if not raw:
        return None
    return {str(k): str(v) for k, v in raw}


def merge_states(states: Sequence[Tuple[str, Dict[str, list]]]
                 ) -> "Metrics":
    """Fold ``(worker, Metrics.dump_state())`` pairs into one registry, the
    cluster view of ``/metrics?scope=cluster``: counters sum; gauges get a
    ``worker`` label (a point-in-time value per process has no sum); a
    histogram's bucket counts add where the bounds agree, and a worker
    whose bounds differ keeps its own ``worker``-labeled series."""
    merged = Metrics()
    for worker, state in states:
        for name, labels, value in state.get("counters", []):
            merged.inc(name, value, labels=_parse_labels(labels))
        for name, labels, value in state.get("gauges", []):
            lbl = dict(_parse_labels(labels) or {})
            lbl["worker"] = worker
            merged.gauge(name, value, labels=lbl)
        for name, labels, bounds, counts, hsum, total in \
                state.get("hists", []):
            if not merged.merge_hist_state(name, _parse_labels(labels),
                                           bounds, counts, hsum, total):
                lbl = dict(_parse_labels(labels) or {})
                lbl["worker"] = worker
                merged.merge_hist_state(name, lbl, bounds, counts,
                                        hsum, total)
    return merged


class _NullMetrics:
    """A no-op registry with the Metrics emission surface: a canary Game
    runs the real engine paths but leaves no marks on player-facing
    series. Reads are not supported: nothing aggregates from a null
    sink."""

    def inc(self, name, value=1.0, labels=None):
        pass

    def gauge(self, name, value, labels=None):
        pass

    def remove_gauge(self, name, labels=None):
        pass

    def observe(self, name, value, labels=None, buckets=None):
        pass

    @contextmanager
    def timer(self, name, labels=None):
        yield


NULL_METRICS = _NullMetrics()

metrics = Metrics()
