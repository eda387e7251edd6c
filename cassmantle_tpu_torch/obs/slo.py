"""SLO burn-rate engine: declarative objectives over the metrics registry.

A copy of ``cassmantle_tpu/obs/slo.py``. It evaluates a small set of
declarative objectives against the cumulative counter/histogram registry
(``utils/logging.py``) over **multi-window burn rates**:

- the **fast window** (~5 min) answers "are we burning error budget
  RIGHT NOW": an objective trips to ``burning`` when its fast-window
  burn rate exceeds 1.0;
- the **slow window** (~1 h) answers "has the incident drained": a
  burning objective recovers only once the slow window is back under
  budget and the fast window agrees, so a flapping burst cannot flap
  the verdict with it.

Burn rate is ``bad_fraction / error_budget``. Windowed deltas come from
periodic samples of the cumulative series (a bounded ring; a window
older than the ring uses its oldest sample: a partial window, never a
fabricated one).

Three objective kinds: ``latency`` (a histogram + threshold, good counts
from the cumulative buckets at the smallest bound >= the threshold),
``ratio`` (good/bad counter tuples, summed across label sets) and
``gauge`` (instantaneous ``value / bound``).

Outputs: ``slo.burn_rate_fast`` / ``slo.burn_rate_slow`` /
``slo.burning`` gauges (labelled ``objective=``), ``slo.burn`` /
``slo.recovered`` flight-recorder events, and the listener calls that
step the brownout ladder (``serving/overload.py``). Clock, registry and
recorder are injectable.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Sequence, Tuple

from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("slo")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective. ``kind`` selects which fields apply:
    latency → metric (histogram) + threshold_s + objective_ratio;
    ratio → good/bad counter tuples + objective_ratio;
    gauge → metric (gauge) + bound."""

    name: str
    kind: str                       # "latency" | "ratio" | "gauge"
    description: str = ""
    metric: str = ""
    threshold_s: float = 0.0
    objective_ratio: float = 0.99
    good: Tuple[str, ...] = ()
    bad: Tuple[str, ...] = ()
    bound: float = 0.0

    def target(self) -> Dict[str, object]:
        if self.kind == "latency":
            return {"quantile": self.objective_ratio,
                    "le_s": self.threshold_s}
        if self.kind == "ratio":
            return {"success_ratio": self.objective_ratio}
        return {"max": self.bound}


def default_objectives(cfg) -> Tuple[Objective, ...]:
    """The worker's default SLO set, thresholds from ``ObsConfig``:
    the guess-path latency SLO, the round-generation success ratio the
    supervisor degrades on, and the replication-lag bound operators
    alert on."""
    obs = cfg.obs
    return (
        Objective(
            name="score_latency", kind="latency",
            metric="http.compute_score_s",
            threshold_s=obs.slo_score_p99_s, objective_ratio=0.99,
            description="p99 of /compute_score end-to-end latency"),
        Objective(
            name="round_generation", kind="ratio",
            good=("rounds.generated", "rounds.buffered"),
            bad=("rounds.buffer_failures",),
            objective_ratio=obs.slo_generation_ratio,
            description="round content generation success ratio"),
        Objective(
            name="replication_lag", kind="gauge", metric="repl.lag",
            bound=obs.slo_repl_lag_max,
            description="worst follower lag in shipped log commands"),
    ) + _probe_objectives(obs)


def _probe_objectives(obs) -> Tuple[Objective, ...]:
    """Black-box canary objectives, fed by the canary prober
    (``obs/prober.py``): the probe plays the real game surface, so its
    verdicts are the closest thing to a player's experience the SLO set
    has. They follow the prober's switch: absent entirely under
    CASSMANTLE_NO_PROBER, where the server starts no prober — a disabled
    prober leaves zero probe artifacts, including the
    slo.burning{objective=probe_*} gauges evaluate() would otherwise mint
    with no traffic."""
    from cassmantle_tpu_torch.obs.prober import prober_disabled

    if prober_disabled():
        return ()
    return (
        Objective(
            name="probe_success", kind="ratio",
            good=("probe.ok",), bad=("probe.failures",),
            objective_ratio=obs.probe_success_ratio,
            description="synthetic canary probe success ratio"),
        Objective(
            name="probe_latency", kind="latency",
            metric="probe.e2e_s",
            threshold_s=obs.probe_p99_s, objective_ratio=0.99,
            description="p99 of canary end-to-end probe time"),
    )


def _latency_good(bounds: Sequence[float], counts: Sequence[int],
                  threshold: float) -> int:
    """Observations ≤ the smallest bucket bound ≥ ``threshold`` — exact
    w.r.t. the ladder; a threshold above every bound counts everything
    outside the +Inf overflow bucket as good."""
    idx = bisect.bisect_left(list(bounds), threshold)
    if idx >= len(bounds):
        return int(sum(counts[:-1]))
    return int(sum(counts[: idx + 1]))


class SloEngine:
    """Samples the registry, computes per-objective fast/slow burn
    rates, and runs the ok↔burning state machine."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        *,
        registry=None,
        recorder=None,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        clock: Callable[[], float] = time.monotonic,
        min_eval_gap_s: Optional[float] = None,
        max_samples: int = 4096,
    ) -> None:
        self.objectives = tuple(objectives)
        self._registry = registry if registry is not None else metrics
        self._recorder = recorder if recorder is not None \
            else flight_recorder
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s),
                                 self.fast_window_s)
        self._clock = clock
        # scrape-driven evaluation (/sloz calls evaluate per hit) must
        # not grow the sample ring per request: below the gap the last
        # verdict is served verbatim
        self.min_eval_gap_s = (min(1.0, self.fast_window_s / 10.0)
                               if min_eval_gap_s is None
                               else float(min_eval_gap_s))
        # (t, {objective: raw}) — newest last; bounded both by time
        # (pruned past the slow window) and by count (scrape floods)
        self._samples: Deque[Tuple[float, Dict[str, object]]] = \
            deque(maxlen=max_samples)
        self._state: Dict[str, str] = {o.name: "ok"
                                       for o in self.objectives}
        self._last_eval: Optional[float] = None
        self._last: Dict[str, dict] = {}
        # consumers called after each evaluation pass with the verdict
        # dict (e.g. the brownout ladder, serving/overload.py); an
        # actuation bug must never break the evaluation loop
        self._listeners: list = []
        # the baseline: deltas measure from engine start, not from the
        # process's whole cumulative history
        self._samples.append((self._clock(), self._raw()))

    # -- raw sampling ------------------------------------------------------
    def _raw(self) -> Dict[str, object]:
        raw: Dict[str, object] = {}
        for obj in self.objectives:
            if obj.kind == "latency":
                ht = self._registry.hist_totals(obj.metric)
                if ht is None:
                    raw[obj.name] = (0, 0)
                else:
                    bounds, counts, total = ht
                    raw[obj.name] = (
                        _latency_good(bounds, counts, obj.threshold_s),
                        total)
            elif obj.kind == "ratio":
                good = sum(self._registry.counter_total(n)
                           for n in obj.good)
                bad = sum(self._registry.counter_total(n)
                          for n in obj.bad)
                raw[obj.name] = (good, good + bad)
            else:  # gauge
                values = self._registry.gauge_values(obj.metric)
                raw[obj.name] = max(values) if values else None
        return raw

    def _sample_at(self, t_cut: float) -> Optional[Dict[str, object]]:
        """The newest sample taken at or before ``t_cut``; the oldest
        resident sample when the ring doesn't reach that far back (a
        partial window — honest, never fabricated)."""
        best = None
        for t, raw in self._samples:
            if t <= t_cut:
                best = raw
            else:
                break
        if best is None and self._samples:
            best = self._samples[0][1]
        return best

    def _burn(self, obj: Objective, now_raw, now: float,
              window_s: float) -> float:
        if obj.kind == "gauge":
            if now_raw is None or obj.bound <= 0:
                return 0.0
            return float(now_raw) / obj.bound
        base = self._sample_at(now - window_s)
        g0, t0 = base.get(obj.name, (0, 0)) if base else (0, 0)
        g1, t1 = now_raw
        d_total = float(t1) - float(t0)
        if d_total <= 0:
            return 0.0          # no traffic in the window = no burn
        d_bad = max(0.0, d_total - (float(g1) - float(g0)))
        budget = max(1e-9, 1.0 - obj.objective_ratio)
        return (d_bad / d_total) / budget

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> Dict[str, dict]:
        """One evaluation pass: burn rates, state transitions, gauges,
        recorder events. Returns the per-objective verdicts (also kept
        for :meth:`status`). Rate-limited by ``min_eval_gap_s``."""
        now = self._clock()
        if self._last_eval is not None and \
                now - self._last_eval < self.min_eval_gap_s:
            return self._last
        self._last_eval = now
        raws = self._raw()
        out: Dict[str, dict] = {}
        for obj in self.objectives:
            fast = self._burn(obj, raws.get(obj.name), now,
                              self.fast_window_s)
            slow = self._burn(obj, raws.get(obj.name), now,
                              self.slow_window_s)
            state = self._state[obj.name]
            if state == "ok" and fast > 1.0:
                state = "burning"
                self._recorder.record(
                    "slo.burn", objective=obj.name,
                    fast_burn=round(fast, 3), slow_burn=round(slow, 3))
                log.warning("SLO %s burning: fast burn %.2f "
                            "(slow %.2f)", obj.name, fast, slow)
            elif state == "burning" and slow <= 1.0 and fast <= 1.0:
                state = "ok"
                self._recorder.record(
                    "slo.recovered", objective=obj.name,
                    fast_burn=round(fast, 3), slow_burn=round(slow, 3))
                log.info("SLO %s recovered", obj.name)
            self._state[obj.name] = state
            labels = {"objective": obj.name}
            self._registry.gauge("slo.burn_rate_fast", fast,
                                 labels=labels)
            self._registry.gauge("slo.burn_rate_slow", slow,
                                 labels=labels)
            self._registry.gauge(
                "slo.burning", 1.0 if state == "burning" else 0.0,
                labels=labels)
            out[obj.name] = {
                "kind": obj.kind,
                "state": state,
                "fast_burn": round(fast, 4),
                "slow_burn": round(slow, 4),
                "target": obj.target(),
                "description": obj.description,
            }
        self._registry.inc("slo.evals")
        self._samples.append((now, raws))
        # keep ONE sample at-or-before the slow-window start as the
        # boundary baseline; everything older is unreachable
        cut = now - self.slow_window_s
        while len(self._samples) > 1 and self._samples[1][0] <= cut:
            self._samples.popleft()
        self._last = out
        for listener in self._listeners:
            try:
                listener(out)
            except Exception:
                log.exception("slo listener failed; continuing")
        return out

    def add_listener(self, fn: Callable[[Dict[str, dict]], None]) -> None:
        """Subscribe a consumer to every evaluation pass (the brownout
        ladder). Listeners run inside evaluate(), on whichever thread
        called it — they must be fast and lock-light."""
        self._listeners.append(fn)

    def status(self) -> Dict[str, object]:
        """The `/sloz` body and the `/readyz` advisory block (callers
        wanting freshness call :meth:`evaluate` first)."""
        if not self._last:
            self.evaluate()
        return {
            "objectives": self._last,
            "burning": sorted(n for n, s in self._state.items()
                              if s == "burning"),
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
        }
