"""The SLO burn-rate engine of the port against the reference, on the
same series: each package's ``SloEngine`` reads its own registry, fed the
same counter, gauge and histogram observations under the same fake
clock (windows of 60 s and 240 s, so a burst drains within the
script), and every evaluation pass yields equal verdicts and burn rates,
equal ``slo.*`` gauges, and equal listener calls. The series drive every
objective kind through ok -> burning (fast window) -> ok (the slow window
drained), the evaluation gap, a partial window and the probe objectives'
kill switch; ``status()`` and the brownout ladder subscribed through
``configure_brownout`` follow."""

import pytest

from cassmantle_tpu import config as jconfig
from cassmantle_tpu.obs import slo as jslo
from cassmantle_tpu.obs.recorder import FlightRecorder as JRecorder
from cassmantle_tpu.serving import overload as joverload
from cassmantle_tpu.utils.logging import Metrics as JMetrics
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.obs import slo as pslo
from cassmantle_tpu_torch.obs.recorder import FlightRecorder as PRecorder
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.utils.logging import Metrics as PMetrics

PACKAGES = {"reference": (jslo, jconfig, JMetrics, JRecorder, joverload),
            "port": (pslo, pconfig, PMetrics, PRecorder, poverload)}


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# (seconds to advance, observations) per evaluation; an observation is
# (kind, name, value): guesses' latencies, round outcomes, replication
# lag and probe results, with a burst of slow guesses and failed rounds
# that trips the fast window and drains out of the slow one
def _script():
    steps = []
    for i in range(40):
        obs = [("observe", "http.compute_score_s", 0.05 + 0.01 * (i % 3))
               for _ in range(20)]
        obs += [("inc", "rounds.generated", 1.0), ("inc", "probe.ok", 1.0),
                ("observe", "probe.e2e_s", 0.5)]
        if 5 <= i < 9:                      # the burst
            obs += [("observe", "http.compute_score_s", 4.0)] * 6
            obs += [("inc", "rounds.buffer_failures", 1.0)] * 2
            obs += [("inc", "probe.failures", 1.0)]
        if i == 12:
            obs += [("gauge", "repl.lag", 900.0)]
        if i == 14:
            obs += [("gauge", "repl.lag", 3.0)]
        steps.append((30.0 if i % 4 else 0.5, obs))
    return steps


def _transcript(package, monkeypatch, probes: bool):
    slo, config, metrics_cls, recorder_cls, overload = PACKAGES[package]
    if probes:
        monkeypatch.delenv("CASSMANTLE_NO_PROBER", raising=False)
    else:
        monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    cfg = config.FrameworkConfig()
    clock, registry, recorder = FakeClock(), metrics_cls(), recorder_cls()
    engine = slo.SloEngine(
        slo.default_objectives(cfg), registry=registry, recorder=recorder,
        fast_window_s=60.0, slow_window_s=240.0, clock=clock,
        max_samples=64)
    calls = []
    engine.add_listener(lambda v: calls.append(
        {n: (o["state"], o["fast_burn"], o["slow_burn"])
         for n, o in v.items()}))

    def broken(_):
        raise RuntimeError("a listener fault must not stop evaluation")

    engine.add_listener(broken)
    monkeypatch.setattr(overload, "_LADDER", None)
    ladder = overload.configure_brownout(cfg, engine)
    ladder._clock = clock
    out = []
    for advance, observations in _script():
        clock.t += advance
        for kind, name, value in observations:
            getattr(registry, kind)(name, value)
        verdicts = engine.evaluate()
        out.append((verdicts, sorted(
            (k, v) for k, v in registry.snapshot()["gauges"].items()
            if k.startswith("slo.")), ladder.tier()))
    return out, calls, engine.status(), registry.counter_total("slo.evals")


@pytest.mark.parametrize("probes", [True, False])
def test_slo_engine_matches_reference(probes, monkeypatch):
    ref = _transcript("reference", monkeypatch, probes)
    port = _transcript("port", monkeypatch, probes)
    assert port == ref
    states = [{n: v["state"] for n, v in verdicts.items()}
              for verdicts, _, _ in port[0]]
    # the burst trips the latency and generation objectives, and the
    # replication lag its gauge; everything drains back to ok
    assert any(s["score_latency"] == "burning" for s in states)
    assert any(s["round_generation"] == "burning" for s in states)
    assert any(s["replication_lag"] == "burning" for s in states)
    assert all(v == "ok" for v in states[-1].values())
    assert ("probe_success" in states[0]) == probes
    # the ladder subscribed through configure_brownout stepped up
    assert max(tier for _, _, tier in port[0]) > 0
    # gap-limited evaluations return the last verdict without a pass
    assert port[3] < len(_script())


def test_hist_totals_matches_reference():
    """The registry read behind latency objectives: bounds, bucket counts
    summed across label sets, and the total."""
    regs = [JMetrics(), PMetrics()]
    for reg in regs:
        assert reg.hist_totals("x") is None
        for i, v in enumerate((0.001, 0.3, 2.0, 400.0, 0.05)):
            reg.observe("x", v, labels={"room": str(i % 2)})
        reg.observe("y", 1.0)
    assert regs[1].hist_totals("x") == regs[0].hist_totals("x")
    assert regs[1].hist_totals("y") == regs[0].hist_totals("y")
