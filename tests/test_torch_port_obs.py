"""The port's observability and health pieces held against the
reference's: ``traceparent`` round trips, the tracer's tail-sampling ring
(retention by slowness, error and mark, the baseline demotion, the
pending ring's TTL and capacity, the eviction memory), exemplars in the
expositions, ``configure_observability``, the rate limiter's eviction and
key shape, ``ProcessMetrics``' gauges, ``DeviceMetrics`` over the same
fake devices, ``DeviceHealth`` with a probe injected to fail, to hang and
to miscompute, the supervisor's health half, ``chaos.configure_from_env``
and the pipelines' counters. The SLO loop of the port's app steps the
brownout ladder up on burn and back down under an injected clock, and
``CASSMANTLE_NO_SLO`` keeps it from starting.
"""

import asyncio
import dataclasses
import json
import random
import re
import time
import types

import pytest
import torch

import cassmantle_tpu.obs as jobs
import cassmantle_tpu.obs.device as jdevice
import cassmantle_tpu.obs.process as jprocess
import cassmantle_tpu.obs.trace as jtrace
import cassmantle_tpu.server.ratelimit as jratelimit
import cassmantle_tpu.serving.supervisor as jsupervisor
import cassmantle_tpu.utils.health as jhealth
import cassmantle_tpu.utils.logging as jlogging
import cassmantle_tpu_torch.obs as pobs
import cassmantle_tpu_torch.obs.device as pdevice
import cassmantle_tpu_torch.obs.process as pprocess
import cassmantle_tpu_torch.obs.trace as ptrace
import cassmantle_tpu_torch.server.ratelimit as pratelimit
import cassmantle_tpu_torch.serving.supervisor as psupervisor
import cassmantle_tpu_torch.utils.health as phealth
import cassmantle_tpu_torch.utils.logging as plogging
from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu.config import ChaosConfig as JChaosConfig
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.config import ChaosConfig as PChaosConfig

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

TRACE = dict(ref=jtrace, port=ptrace)


@pytest.mark.parametrize("value", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-ff  ",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "garbage", "", None,
])
def test_traceparent_round_trips_match_reference(value):
    got = {}
    for name, mod in TRACE.items():
        ctx = mod.parse_traceparent(value)
        got[name] = None if ctx is None else (
            ctx.trace_id, ctx.span_id, ctx.sampled, ctx.marks, ctx.head,
            mod.format_traceparent(ctx))
    assert got["port"] == got["ref"]
    if got["port"] is not None:
        assert ptrace.parse_traceparent(got["port"][-1]).trace_id == \
            got["port"][0]


def _root(mod, tr, name, sleep_s=0.0, status="ok", mark=None):
    try:
        with tr.span(name, root=True) as h:
            with tr.span("child"):
                pass
            if mark:
                tr.mark_retain(mark, h.ctx)
            if sleep_s:
                time.sleep(sleep_s)
            if status == "error":
                raise RuntimeError("boom")
    except RuntimeError:
        pass
    return h.trace_id


def _tail_script(mod):
    """Which traces the ring keeps, in order, under each verdict."""
    tr = mod.Tracer(capacity=3, sample_rate=0.0, rng=random.Random(3))
    tr.configure(tail_slow_default_s=0.05)
    ids = {
        "healthy": _root(mod, tr, "http.get /fetch"),
        "slow": _root(mod, tr, "http.get /fetch", sleep_s=0.08),
        "error": _root(mod, tr, "http.post /x", status="error"),
        "marked": _root(mod, tr, "http.post /x", mark="shed"),
        "baseline_error": _root(mod, tr, "http.get /init", status="error",
                                mark="baseline"),
    }
    tr.configure(tail_slow_routes={"http.get /slowroute": 0.0})
    ids["routed"] = _root(mod, tr, "http.get /slowroute")
    # capacity 3: the oldest retained (slow) is evicted, and a late span
    # of it is dropped, never resurrected
    late = mod.SpanContext(ids["slow"], "f" * 16, True, head=True)
    tr.record_span("late", late, start_wall=time.time(), duration_s=0.0)
    kept = {k: tr.get_trace(v) is not None for k, v in ids.items()}
    names = {k: sorted(s["name"] for s in tr.get_trace(v) or [])
             for k, v in ids.items()}
    order = [next(k for k, v in ids.items() if v == t)
             for t in tr.trace_ids()]
    # the pending ring's TTL: a root that never ends is abandoned
    tr.configure(pending_ttl_s=0.0)
    orphan = tr.new_root_ctx()
    tr.record_span("orphan", tr.child_ctx(orphan), start_wall=time.time(),
                   duration_s=0.0)
    pending = tr.stats()["pending"]
    time.sleep(0.002)
    other = tr.new_root_ctx()
    tr.record_span("other", tr.child_ctx(other), start_wall=time.time(),
                   duration_s=0.0)
    abandoned = tr.get_trace(orphan.trace_id) is None
    # the pending ring's capacity evicts its oldest
    tr.configure(pending_ttl_s=120.0, pending_capacity=2)
    ctxs = [tr.new_root_ctx() for _ in range(3)]
    for c in ctxs:
        tr.record_span("p", tr.child_ctx(c), start_wall=time.time(),
                       duration_s=0.0)
    evicted = [tr.get_trace(c.trace_id) is None for c in ctxs]
    # a head trace is durable at once
    head = mod.Tracer(capacity=4, sample_rate=1.0)
    head_kept = head.get_trace(_root(mod, head, "http.get /fetch"))
    return (kept, names, order, pending, abandoned, evicted,
            head_kept is not None, sorted(tr.stats()))


def test_tail_sampling_matches_reference():
    ref, port = _tail_script(jtrace), _tail_script(ptrace)
    assert port == ref
    kept = port[0]
    assert kept == {"healthy": False, "slow": False, "error": True,
                    "marked": True, "baseline_error": False, "routed": True}


def _exposition_script(logging_mod, trace_mod):
    reg = logging_mod.Metrics()
    tr = trace_mod.Tracer(capacity=8, sample_rate=0.0)
    tr.configure(tail_slow_default_s=10.0)

    def probe():
        ctx = trace_mod.current_ctx()
        return None if ctx is None or not ctx.sampled else \
            ("T" if "keep" in ctx.marks else "D", ctx.head)

    reg.set_exemplar_source(probe)
    with tr.span("root", root=True) as keep:
        keep.ctx.marks["keep"] = True
        reg.observe("lat_s", 0.004)
    reg.retain_exemplars("T")
    with tr.span("root", root=True):
        reg.observe("lat_s", 0.2)
    reg.discard_exemplars("D")
    reg.inc("hits", 3, labels={"room": 'a"b'})
    reg.gauge("g", 2.5)
    reg.gauge("gone", 1.0)
    reg.remove_gauge("gone")
    reg.set_default_buckets((0.5, 1.0))
    reg.observe("new_s", 0.7)
    # an exemplar's wall timestamp differs run to run
    strip = lambda t: re.sub(  # noqa: E731
        r'(trace_id="\w+"\} [0-9.e+-]+) [0-9.e+-]+\n', r"\1\n", t)
    snap = reg.snapshot(exemplars=True)
    for per in snap["exemplars"].values():
        for ex in per.values():
            ex.pop("ts")
    return reg.prometheus(), strip(reg.openmetrics()), snap


def test_expositions_and_exemplars_match_reference():
    ref = _exposition_script(jlogging, jtrace)
    port = _exposition_script(plogging, ptrace)
    assert port == ref
    assert "# EOF" in port[1] and 'trace_id="T"' in port[1]
    assert "trace_id" not in port[0]


def test_configure_observability_matches_reference():
    from cassmantle_tpu.config import ObsConfig as JObs
    from cassmantle_tpu_torch.config import ObsConfig as PObs

    try:
        got = []
        for mod, obs in ((jobs, JObs), (pobs, PObs)):
            mod.configure_observability(obs(
                trace_capacity=17, trace_sample_rate=0.25,
                trace_pending_capacity=9, recorder_capacity=33,
                tail_slow_routes=(("http.get /x", 0.3),)))
            stats = mod.tracer.stats()
            # the configured fields (the resident counts are the process's
            # history, which differs between the packages)
            got.append(({k: stats[k] for k in ("capacity", "sample_rate",
                                               "pending_capacity")},
                        mod.tracer.max_spans_per_trace,
                        mod.tracer.pending_ttl_s,
                        mod.tracer.tail_slow_default_s,
                        mod.tracer.tail_slow_routes,
                        mod.flight_recorder.stats()["capacity"]))
        assert got[1] == got[0]
        assert got[1][0] == {"capacity": 17, "sample_rate": 0.25,
                             "pending_capacity": 9}
    finally:
        for mod, obs in ((jobs, JObs), (pobs, PObs)):
            mod.configure_observability(obs())


def _ratelimit_script(mod):
    limiter = mod.RateLimiter(max_entries=100, stale_s=1000.0)
    out = [limiter.allow(("s1", "lobby"), "/compute_score", rate=1.0),
           limiter.allow(("s1", "lobby"), "/compute_score", rate=1.0),
           limiter.allow(("s1", "room-1"), "/compute_score", rate=1.0),
           limiter.allow(("s1", "lobby"), "/init", rate=1.0)]
    for i in range(200):
        limiter.allow((f"s-{i}", "room-1"), "/compute_score", rate=1.0)
        limiter.allow(("s1", "lobby"), "/compute_score", rate=1.0)
    out += [len(limiter._buckets) <= 101,
            limiter.allow(("s1", "lobby"), "/compute_score", rate=1.0),
            (("s1", "lobby"), "/compute_score") in limiter._buckets,
            0.0 < limiter.retry_after_s(("s1", "lobby"), "/compute_score")
            <= 1.0, limiter.retry_after_s(("nobody", "x"), "/")]
    stale = mod.RateLimiter(max_entries=10, stale_s=0.01)
    for i in range(10):
        stale.allow(f"old-{i}", "/", rate=1.0)
    time.sleep(0.02)
    stale.allow("fresh", "/", rate=1.0)
    out.append(sorted(stale._buckets))
    return out


def test_rate_limiter_matches_reference():
    ref, port = _ratelimit_script(jratelimit), _ratelimit_script(pratelimit)
    assert port == ref
    assert port[:4] == [True, False, True, True]


def test_process_metrics_match_reference():
    got = []
    for log_mod, proc_mod in ((jlogging, jprocess), (plogging, pprocess)):
        reg = log_mod.Metrics()
        now = [10.0]
        pm = proc_mod.ProcessMetrics(registry=reg, clock=lambda: now[0])
        now[0] = 12.5
        pm.sample()

        async def one_tick():
            task = asyncio.ensure_future(pm.run(0.01))
            await asyncio.sleep(0.05)
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

        asyncio.run(one_tick())
        gauges = reg.snapshot()["gauges"]
        assert gauges["process.rss_bytes"] > 0 and \
            gauges["process.cpu_s"] > 0 and gauges["server.loop_lag_s"] >= 0
        got.append((sorted(gauges), gauges["process.uptime_s"]))
    assert got[1] == got[0] == (["process.cpu_s", "process.rss_bytes",
                                 "process.uptime_s", "server.loop_lag_s"],
                                2.5)


class _FakeDevice:
    """A reference device: ``memory_stats()`` as a JAX device answers it."""

    def __init__(self, dev_id, stats_of):
        self.platform, self.id = "gpu", dev_id
        self._stats_of = stats_of

    def memory_stats(self):
        return self._stats_of(self.id)


def _device_script(log_mod, dev_mod):
    """The same stats through both packages' samplers: the reference's
    over JAX-shaped fake devices, the port's over CUDA ``torch.device``s
    and an injected ``stats_fn``. Labels read ``cuda:<i>`` for both."""
    reg = log_mod.Metrics()
    table = {0: {"bytes_in_use": 100, "bytes_limit": 1000,
                 "peak_bytes_in_use": 400},
             1: {"bytes_in_use": 7}, 2: None, 3: RuntimeError("dark")}

    def stats_of(i):
        if isinstance(table[i], Exception):
            raise table[i]
        return table[i]

    if dev_mod is jdevice:
        devices = [_FakeDevice(i, stats_of) for i in range(4)]
        dm = dev_mod.DeviceMetrics(registry=reg, devices_fn=lambda: devices)
    else:
        devices = [torch.device("cuda", i) for i in range(4)]
        dm = dev_mod.DeviceMetrics(registry=reg, devices_fn=lambda: devices,
                                   stats_fn=lambda d: stats_of(d.index))
    out = [dm.sample(), reg.snapshot()["gauges"]]
    dm.note_dispatch("t2i")
    table[0] = {"bytes_in_use": 50}
    dm.note_dispatch("t2i")
    dm.note_dispatch("scorer")
    table[0] = None                   # going dark retracts byte gauges
    dm.sample()
    block = dm.device_block()
    out += [dm.highwater(), reg.snapshot()["gauges"], block["devices"],
            block["hbm_highwater_bytes"]]
    return json.loads(json.dumps(out).replace('"gpu:', '"cuda:')
                      .replace('=\\"gpu:', '=\\"cuda:'))


def test_device_metrics_match_reference():
    ref = _device_script(jlogging, jdevice)
    port = _device_script(plogging, pdevice)
    assert port == ref
    assert port[4]["cuda:0"] == "unavailable"
    assert port[1]['device.hbm_bytes_limit{device="cuda:0"}'] == 1000.0


def test_device_metrics_on_the_cpu_are_unavailable_and_never_init_cuda():
    reg = plogging.Metrics()
    dm = pdevice.DeviceMetrics(registry=reg, device="cpu")
    assert dm.sample() == {"cpu:0": None}
    assert reg.snapshot()["gauges"] == {
        'device.hbm_available{device="cpu:0"}': 0.0}
    # the CUDA default reads no device before the process initialized it
    assert pdevice._cuda_devices() == []
    dm.note_dispatch("t2i")
    assert dm.highwater() == {}
    assert dm.device_block()["compile"] == {"graph_captures":
                                            dm.device_block()["compile"]
                                            ["graph_captures"]}


def _health_script(mod, probe, monkeypatch, timeout_s=0.2):
    if mod is jhealth:
        monkeypatch.setattr(mod, "_probe_once", lambda: probe())
        h = mod.DeviceHealth(timeout_s=timeout_s, cache_s=60.0)
    else:
        monkeypatch.setattr(mod, "_probe_once", lambda device: probe())
        h = mod.DeviceHealth(timeout_s=timeout_s, cache_s=60.0,
                             device="cpu")
    errors = []
    h.on_probe_error = errors.append
    first = h.check()[0]
    cached = h.check()
    out = [first, h.last_verdict(), h.last_failure(), cached[0],
           cached[1] > 0.0, [type(e).__name__ for e in errors]]
    h.invalidate()
    out.append(h.last_verdict())
    return out


def _raise():
    raise RuntimeError("CUDA error: an illegal memory access")


def _hang():
    time.sleep(0.5)
    return True


@pytest.mark.parametrize("probe", [lambda: True, _raise, _hang,
                                   lambda: False],
                         ids=["ok", "raises", "times_out", "miscomputes"])
def test_device_health_matches_reference(probe, monkeypatch):
    ref = _health_script(jhealth, probe, monkeypatch)
    port = _health_script(phealth, probe, monkeypatch)
    assert port == ref
    if probe is _raise:
        assert port[:3] == [False, False, "raise:RuntimeError"]
        assert port[5] == ["RuntimeError"]
    if probe is _hang:
        assert port[2] == "timeout"


def test_device_health_probes_the_device_it_is_given():
    h = phealth.DeviceHealth(device="cpu", cache_s=0.0)
    assert h.check()[0] is True and str(h.device) == "cpu"


def _supervisor_script(mod, health):
    sup = mod.ServingSupervisor(device_health=health)
    now = [100.0]
    sup.clock = lambda: now[0]
    sup.note_stage_progress("denoise")
    now[0] = 102.5
    sup.fabric_status = lambda: {"worker": "w"}
    out = [sup.device_unhealthy(), sup.stage_health(),
           asyncio.run(sup.probe_device()),
           sup.status(device_ok=False, include_events=False)]
    health._healthy = False
    out.append(sup.device_unhealthy())

    def broken():
        raise RuntimeError("torn")

    sup.fabric_status = broken
    out.append(sup.status()["fabric"])
    return out


def _stand_in_probe():
    """A DeviceHealth stand-in: a passing check, a settable verdict."""
    probe = types.SimpleNamespace(_healthy=None, check=lambda: (True, 0.0))
    probe.last_verdict = lambda: probe._healthy
    return probe


def test_supervisor_health_half_matches_reference():
    ref = _supervisor_script(jsupervisor, _stand_in_probe())
    port = _supervisor_script(psupervisor, _stand_in_probe())
    assert port == ref
    assert port[0] is False and port[4] is True


@pytest.mark.parametrize("env,spec", [
    ("", ""),
    ("", "seed=3;round.generate=raise:times=1"),
    ("seed=4;device.lost=raise:times=2", "seed=3;round.generate=raise"),
])
def test_chaos_configure_from_env_matches_reference(env, spec,
                                                    monkeypatch):
    if env:
        monkeypatch.setenv("CASSMANTLE_CHAOS", env)
    else:
        monkeypatch.delenv("CASSMANTLE_CHAOS", raising=False)
    try:
        got = []
        for mod, cfg in ((jchaos, JChaosConfig), (pchaos, PChaosConfig)):
            plan = mod.configure_from_env(cfg(spec=spec))
            got.append((plan is None, mod.armed(), mod.status()))
        assert got[1] == got[0]
    finally:
        jchaos.disarm()
        pchaos.disarm()


def test_pipeline_counters_match_the_reference_sites():
    """The reference's counters, counted on the host: the encprop and
    consistency counters from the served schedule (as the reference's
    ``note_*`` helpers count them), the speculative decode's chunks and
    accept rate from its one transfer."""
    from cassmantle_tpu.serving import pipeline as jpipeline
    from cassmantle_tpu_torch.config import SamplerConfig
    from cassmantle_tpu_torch.serving import pipeline as ppipeline

    names = ("pipeline.encprop_key_steps", "pipeline.encprop_shallow_steps",
             "pipeline.encprop_prop_steps", "pipeline.consistency_steps",
             "decode.spec_chunks")

    def deltas(reg, fn):
        before = {n: reg.counter_total(n) for n in names}
        fn()
        return {n: reg.counter_total(n) - before[n] for n in names}

    for scfg in (SamplerConfig(encprop=True),
                 SamplerConfig(encprop=True, deepcache=True),
                 SamplerConfig(consistency=True, num_steps=4),
                 SamplerConfig()):
        variant = ppipeline.SamplerVariant(scfg)

        def port_fn():
            ppipeline.note_encprop_counters(variant.encprop_counts, 3)
            ppipeline.note_consistency_counter(variant.sampler_cfg, 3)

        def ref_fn():
            jpipeline.note_encprop_counters(variant.encprop_counts, 3)
            jpipeline.note_consistency_counter(scfg, 3)

        assert deltas(plogging.metrics, port_fn) == \
            deltas(jlogging.metrics, ref_fn)
    holder = types.SimpleNamespace()
    got = deltas(plogging.metrics, lambda: ppipeline.PromptGenerator.
                 _record_spec_stats(holder, [torch.tensor([3, 8, 6]),
                                             torch.tensor([2, 4, 2])]))
    assert got["decode.spec_chunks"] == 5
    assert holder.last_spec_stats["accept_rate"] == 8 / 12
    assert plogging.metrics.gauge_values("decode.spec_accept_rate") == \
        [8 / 12]


def test_generate_counts_images_and_text_fallbacks():
    """``pipeline.images`` per generated image and
    ``pipeline.text_fallbacks`` per round whose text fell back, on a tiny
    backend on the CPU."""
    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.serving.pipeline import TorchContentBackend

    count = plogging.metrics.counter_total
    images, fallbacks = count("pipeline.images"), count(
        "pipeline.text_fallbacks")
    backend = TorchContentBackend(test_config(), device="cpu")
    rc = backend.generate_sync("a seed", text="...")
    assert rc.image.shape == (64, 64, 3)
    assert count("pipeline.images") == images + 1
    assert count("pipeline.text_fallbacks") == fallbacks + 1
    assert backend.text_fallbacks == 1


def _burn_app(monkeypatch, no_slo: bool):
    """The port's app over the fake backend, with a ladder and an SLO
    engine on an injected clock: (app, engine, ladder, registry feed)."""
    import cassmantle_tpu_torch.server.app as papp
    from cassmantle_tpu_torch.config import ObsConfig
    from cassmantle_tpu_torch.config import test_config

    if no_slo:
        monkeypatch.setenv("CASSMANTLE_NO_SLO", "1")
    else:
        monkeypatch.delenv("CASSMANTLE_NO_SLO", raising=False)
    cfg = test_config()
    cfg = cfg.replace(
        obs=ObsConfig(slo_eval_interval_s=0.01, slo_fast_window_s=10.0,
                      slo_slow_window_s=60.0, slo_score_p99_s=0.001),
        serving=dataclasses.replace(cfg.serving,
                                    brownout_step_up_dwell_s=1.0,
                                    brownout_step_down_dwell_s=30.0))
    return papp, cfg


def test_slo_loop_steps_the_ladder_up_and_down(monkeypatch):
    """``_slo_loop`` evaluates on its interval and the ladder listening to
    the engine steps up on fast-window burn (one rung a dwell) and back
    down, one rung a step-down dwell, once the slow window recovers, all
    under an injected clock."""
    from cassmantle_tpu_torch.obs.slo import SloEngine, default_objectives
    from cassmantle_tpu_torch.serving import overload

    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    papp, cfg = _burn_app(monkeypatch, no_slo=False)
    now = [1000.0]
    reg = plogging.Metrics()
    engine = SloEngine(default_objectives(cfg), registry=reg,
                       fast_window_s=cfg.obs.slo_fast_window_s,
                       slow_window_s=cfg.obs.slo_slow_window_s,
                       clock=lambda: now[0], min_eval_gap_s=0.0)
    ladder = overload.BrownoutLadder(
        overload.DEFAULT_TIERS, objectives=("score_latency",),
        step_up_dwell_s=cfg.serving.brownout_step_up_dwell_s,
        step_down_dwell_s=cfg.serving.brownout_step_down_dwell_s,
        clock=lambda: now[0], registry=reg)
    engine.add_listener(ladder.on_slo_eval)
    tiers = []

    async def drive():
        task = asyncio.ensure_future(papp._slo_loop(
            engine, cfg.obs.slo_eval_interval_s))
        try:
            async def tick(seconds, burn=False):
                now[0] += seconds
                if burn:
                    for _ in range(50):
                        reg.observe("http.compute_score_s", 0.1)
                await asyncio.sleep(0.05)     # a few loop passes
                tiers.append(ladder.tier())

            for _ in range(4):                 # burning: up a rung a dwell
                await tick(1.0, burn=True)
            for _ in range(3):                 # quiet, fast window clean
                await tick(15.0)
            for _ in range(6):                 # slow window clean: down
                await tick(31.0)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    asyncio.run(drive())
    top = max(tiers)
    assert tiers[0] == 0 and top >= 2, tiers
    assert tiers == sorted(tiers[:tiers.index(top) + 1]) + \
        tiers[tiers.index(top) + 1:], tiers
    assert tiers[-1] == 0, tiers
    assert reg.counter_total("overload.brownout_trips") == top
    assert reg.counter_total("overload.brownout_recoveries") == top


@pytest.mark.parametrize("no_slo", [False, True], ids=["loop", "no_slo"])
def test_app_starts_the_slo_loop_unless_switched_off(no_slo, monkeypatch):
    """In the app: with the loop, burn on ``http.compute_score_s`` steps
    the ladder up with no request to /sloz or /readyz; under
    CASSMANTLE_NO_SLO=1 no loop runs and the ladder stays at tier 0."""
    from aiohttp.test_utils import TestClient, TestServer

    from cassmantle_tpu_torch.serving import overload

    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    papp, cfg = _burn_app(monkeypatch, no_slo=no_slo)
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, brownout_step_up_dwell_s=0.0))

    async def run():
        fabric = papp.build_fabric(cfg, fake=True, worker_id="slo")
        app = papp.create_app(fabric, cfg, start_timer=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            tasks = len(app[papp._OBS_TASKS])
            for _ in range(20):
                for _ in range(20):
                    plogging.metrics.observe("http.compute_score_s", 0.2)
                await asyncio.sleep(0.1)
                if overload.current_tier() >= 1:
                    break
            return tasks, overload.current_tier()
        finally:
            await client.close()
            overload.reset_brownout()

    tasks, tier = asyncio.run(run())
    # the process and device samplers and the canary prober, with the SLO
    # loop beside them unless it is switched off
    if no_slo:
        assert (tasks, tier) == (3, 0)
    else:
        assert tasks == 4 and tier >= 1
