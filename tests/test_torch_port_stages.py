"""The port's staged image server (serving/stages.py) on the CPU, at
``test_config()`` sizes, against the port's monolithic path and the
reference's slot sampler and gating.

- The slot samplers (ddim, euler, dpmpp_2m, consistency): a solo slot
  stepped one ``SlotSampler.step`` at a time is bit-equal to the port's
  monolithic ``sample_spec`` (``spec_step``), slots at different
  positions each bit-equal to their own solo trajectory; against the
  reference's ``make_slot_sampler`` on the same numpy x_T under the same
  toy denoiser, within fp32 rounding (max |port - ref| <= 1e-6 x max
  |ref|, each side's division and sqrt taken in its own order); eta > 0
  raises in both.
- ``_staged_enabled`` equals the reference's over a matrix of configs
  (staged on and off, the kill switch, DeepCache, encprop, eta, kinds,
  consistency).
- The pipeline: a solo request and a two-prompt request on the staged
  path are bit-equal to the monolithic path of the same pipeline for the
  same seed; mid-flight admission (the denoise thread held at a step
  boundary until the second request lands) runs widths 1 and 3, builds
  each width's step once, and the co-resident images are held to their
  monolithic images within the yardstick of the monolithic path's own
  batch variance (CPU torch's kernels do not give bitwise batch
  invariance: a row computed at width 3 can differ from the same row at
  width 1 by a level); the
  deadline preemption; the kill switch; metrics, flight-recorder events,
  spans and the supervisor's stage health; a ``stage.denoise.tick`` fault
  fails the callers; ``stop()`` fails pending work and the server
  restarts; a poisoned slot is quarantined and its slot serves clean
  afterwards; a brownout tier serves monolithic; the service's rebuild
  drops the server and the next generate makes a new one.
"""

import asyncio
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jconfig
from cassmantle_tpu.ops.samplers import make_slot_sampler as jax_slot_sampler
from cassmantle_tpu.serving.pipeline import Text2ImagePipeline as JText2Image
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import run_with_ctx, tracer
from cassmantle_tpu_torch.ops.ddim import sample_spec
from cassmantle_tpu_torch.ops.samplers import (
    ConsistencySchedule,
    make_schedule,
    make_slot_sampler,
)
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.serving.integrity import OutputInvalid
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.queue import DeadlineExceeded, QueueStopped
from cassmantle_tpu_torch.serving.service import InferenceService
from cassmantle_tpu_torch.serving.stages import StagedImageServer
from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor
from cassmantle_tpu_torch.utils.logging import metrics

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

KILL = "CASSMANTLE_NO_STAGED_SERVING"
KINDS = ("ddim", "euler", "dpmpp_2m", "consistency")


def staged(base, slots=3):
    return base.replace(serving=dataclasses.replace(
        base.serving, staged_serving=True, denoise_slots=slots))


@pytest.fixture(scope="module")
def sd_pipe():
    pipe = Text2ImagePipeline(staged(pconfig.test_config()), device="cpu")
    pipe.supervisor = ServingSupervisor()
    yield pipe
    pipe.drop_staged()


@pytest.fixture(autouse=True)
def _clean(sd_pipe, monkeypatch):
    monkeypatch.delenv(KILL, raising=False)
    poverload.reset_brownout()
    yield
    pchaos.disarm()
    if sd_pipe._staged is not None:
        sd_pipe._staged._on_step = None


def mono(monkeypatch, pipe, prompts, seed):
    """The monolithic image of the same pipeline (the kill switch)."""
    monkeypatch.setenv(KILL, "1")
    try:
        return pipe.generate(prompts, seed=seed)
    finally:
        monkeypatch.delenv(KILL, raising=False)


def diff_stats(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float(d.mean()), int(d.max())


# -- slot samplers ------------------------------------------------------------

def _toy_denoise(x, t):
    tt = t.to(torch.float32).view(-1, 1, 1, 1)
    return 0.003 * x * (tt + 1.0) - 0.01 * x


def _jax_toy_denoise(x, t):
    tt = jnp.asarray(t, jnp.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.003 * x * (tt + 1.0) - 0.01 * x


def _x_t(rows=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, 4, 4, 4)).astype(np.float32)


def _schedule(kind, steps):
    if kind == "consistency":
        return ConsistencySchedule.create(steps, 50)
    return make_schedule(kind, steps)


@pytest.mark.parametrize("kind", KINDS)
def test_slot_sampler_is_spec_step_bitwise(kind):
    """A solo slot is the monolithic loop value for value; three slots
    admitted one step apart each land on their own solo trajectory."""
    steps = 5
    lat = torch.from_numpy(_x_t(3))
    sampler = make_slot_sampler(kind, steps, lat[:1])
    assert sampler.num_steps == steps
    assert sampler.has_aux == (kind == "dpmpp_2m")
    solo = [sample_spec(_schedule(kind, steps).spec(lat[i:i + 1]),
                        _toy_denoise, lat[i:i + 1]) for i in range(3)]
    x, aux = sampler.prepare(lat[:1])
    for i in range(steps):
        x, aux = sampler.step(_toy_denoise, x, aux,
                              torch.tensor([i], dtype=torch.long))
    assert torch.equal(x, solo[0]), kind
    # slot k admitted at tick k: per-slot positions differ in one step
    x, aux = sampler.prepare(lat)
    pos = np.array([0, -1, -2])
    for _ in range(steps + 2):
        live = np.flatnonzero((pos >= 0) & (pos < steps))
        idx = torch.from_numpy(live)
        nx, naux = sampler.step(
            _toy_denoise, x[idx], aux[idx],
            torch.from_numpy(pos[live]).long())
        x, aux = x.clone(), aux.clone()
        x[idx], aux[idx] = nx, naux
        pos += 1
    for i in range(3):
        assert torch.equal(x[i:i + 1], solo[i]), (kind, i)


@pytest.mark.parametrize("kind", KINDS)
def test_slot_sampler_matches_reference(kind):
    """Slots at different positions, the same numpy x_T and toy
    denoiser: the port's slot steps against the reference's jitted
    make_slot_sampler, within fp32 rounding."""
    steps = 4
    lat_np = _x_t(3, seed=1)
    jprep, jstep, jn = jax_slot_sampler(kind, steps)
    sampler = make_slot_sampler(kind, steps, torch.from_numpy(lat_np[:1]))
    assert jn == sampler.num_steps == steps
    jx, jaux = jprep(jnp.asarray(lat_np))
    px, paux = sampler.prepare(torch.from_numpy(lat_np))
    jfn = jax.jit(lambda x, a, i: jstep(_jax_toy_denoise, x, a, i))
    idx = np.array([0, 2, 1])
    for _ in range(2):
        jx, jaux = jfn(jx, jaux, jnp.asarray(idx, jnp.int32))
        px, paux = sampler.step(_toy_denoise, px, paux,
                                torch.from_numpy(idx).long())
        idx = idx + 1
    ref = np.asarray(jx)
    assert np.abs(px.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    if kind == "dpmpp_2m":
        raux = np.asarray(jaux)
        assert np.abs(paux.numpy() - raux).max() <= 1e-6 * np.abs(raux).max()


def test_slot_sampler_rejects_stochastic_eta():
    with pytest.raises(ValueError, match="eta"):
        make_slot_sampler("ddim", 4, torch.zeros(1, 4, 4, 4), eta=0.3)
    with pytest.raises(ValueError, match="eta"):
        jax_slot_sampler("ddim", 4, eta=0.3)


# -- routing ------------------------------------------------------------------

GATING_CASES = [
    {}, {"staged_serving": False}, {"deepcache": True}, {"encprop": True},
    {"eta": 0.5}, {"kind": "euler"}, {"kind": "dpmpp_2m"},
    {"kind": "dpmpp_2m", "deepcache": True}, {"kind": "nonexistent"},
    {"consistency": True, "num_steps": 4},
    {"kind": "euler", "encprop": True}]


@pytest.mark.parametrize("meshed", [False, True])
@pytest.mark.parametrize("case", range(len(GATING_CASES)))
@pytest.mark.parametrize("killed", [False, True])
def test_staged_enabled_matches_reference(case, killed, meshed,
                                          monkeypatch):
    """The routing decision over the same config matrix, both packages,
    meshless and under a mesh (meshed serving stays monolithic)."""
    kw = dict(GATING_CASES[case])
    serving_kw = {"staged_serving": kw.pop("staged_serving", True)}
    if killed:
        monkeypatch.setenv(KILL, "1")

    def cfg(package):
        base = package.test_config()
        return base.replace(
            sampler=dataclasses.replace(base.sampler, **kw),
            serving=dataclasses.replace(base.serving, **serving_kw))

    mesh = object() if meshed else None
    ref = JText2Image._staged_enabled(SimpleNamespace(cfg=cfg(jconfig),
                                                      mesh=mesh))
    port = Text2ImagePipeline._staged_enabled(SimpleNamespace(
        cfg=cfg(pconfig), mesh=mesh))
    assert port == ref
    if case == 0:
        assert port == (not killed and not meshed)


def test_staged_config_presets():
    """staged_serving_config() is the default config with staging on and
    the reference's stage settings."""
    cfg = pconfig.staged_serving_config()
    ref = jconfig.staged_serving_config()
    assert cfg.serving.staged_serving and ref.serving.staged_serving
    for name in ("denoise_slots", "stage_encode_batch_sizes",
                 "stage_decode_batch_sizes", "stage_max_delay_ms"):
        assert getattr(cfg.serving, name) == getattr(ref.serving, name)
    assert cfg.sampler == pconfig.FrameworkConfig().sampler


# -- the pipeline: parity ----------------------------------------------------

def test_solo_bit_parity_sd15(sd_pipe, monkeypatch):
    prompt = ["a lighthouse over a stormy sea"]
    ref = mono(monkeypatch, sd_pipe, prompt, 7)
    out = sd_pipe.generate(prompt, seed=7)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.array_equal(ref, out)
    ref2 = mono(monkeypatch, sd_pipe, prompt, 8)
    assert np.array_equal(ref2, sd_pipe.generate(prompt, seed=8))
    assert not np.array_equal(ref, ref2)
    srv = sd_pipe._staged
    assert srv is not None and srv.stats["retirements"] >= 2


def test_multi_prompt_request_bit_parity(sd_pipe, monkeypatch):
    """A two-prompt request: one B-row x_T draw, its rows admitted at one
    boundary into two slots, in order."""
    prompts = ["a caravan crossing silver dunes", "an orchard at night"]
    ref = mono(monkeypatch, sd_pipe, prompts, 11)
    before = dict(sd_pipe._staged_server().width_steps)
    out = sd_pipe.generate(prompts, seed=11)
    assert np.array_equal(ref, out)
    after = sd_pipe._staged.width_steps
    assert after[2] - before.get(2, 0) == sd_pipe._staged.num_steps


def test_mid_flight_admission_and_build_once(sd_pipe, monkeypatch):
    """Request B (two prompts) lands while A is mid-denoise: the hook
    holds the boundary after A's second step until B is queued, so B
    joins at a boundary before A finishes, at width 3. Each width's step
    is built once over the whole history."""
    prompt_a = ["a night train between cities"]
    prompt_b = ["a watercolor harbor at dawn", "an orchard in snow"]
    ref_a = mono(monkeypatch, sd_pipe, prompt_a, 21)
    ref_b = mono(monkeypatch, sd_pipe, prompt_b, 22)
    srv = sd_pipe._staged_server()
    base = dict(srv.stats)
    snaps = []

    def hook(s):
        snaps.append((s.stats["steps"] - base["steps"],
                      s.stats["admissions"] - base["admissions"]))
        if (s.stats["admissions"] - base["admissions"] == 1
                and s.stats["steps"] - base["steps"] >= 2):
            deadline = time.monotonic() + 30.0
            while (s._admit_q.empty() and not s._pend
                   and time.monotonic() < deadline
                   and not s._stop_evt.is_set()):
                time.sleep(0.002)

    srv._on_step = hook
    with ThreadPoolExecutor(max_workers=2) as ex:
        fa = ex.submit(sd_pipe.generate, prompt_a, 21)
        deadline = time.monotonic() + 30.0
        while (srv.stats["admissions"] - base["admissions"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.002)
        fb = ex.submit(sd_pipe.generate, prompt_b, 22)
        out_a = fa.result(timeout=120)
        out_b = fb.result(timeout=120)
    srv._on_step = None
    n = srv.num_steps
    b_admitted = [s for s, adm in snaps if adm == 3]
    assert b_admitted and min(b_admitted) < n
    d_steps = srv.stats["steps"] - base["steps"]
    d_slot_steps = srv.stats["slot_steps"] - base["slot_steps"]
    assert d_slot_steps == 3 * n and d_slot_steps > d_steps
    # each against its own monolithic image, within the yardstick: the
    # monolithic path's own batch variance (row 0 of a two-prompt batch
    # against the solo image) plus 0.5 of a level on the mean and 2 at
    # the max
    for prompts, seed, out, ref in ((prompt_a, 21, out_a, ref_a),
                                    (prompt_b, 22, out_b, ref_b)):
        other = prompt_a if prompts is prompt_b else prompt_b
        yard = diff_stats(
            mono(monkeypatch, sd_pipe, [prompts[0], other[0]], seed)[:1],
            mono(monkeypatch, sd_pipe, prompts[:1], seed))
        got = diff_stats(out, ref)
        assert got[0] <= yard[0] + 0.5 and got[1] <= yard[1] + 2, (
            prompts, got, yard)
    builds = dict(srv.builds)
    assert set(builds) <= {1, 2, 3} and set(builds.values()) == {1}
    sd_pipe.generate(prompt_a, seed=23)
    sd_pipe.generate(prompt_b, seed=24)
    assert dict(srv.builds) == builds


def test_deadline_expiry_frees_slot_without_corrupting_neighbor(
        sd_pipe, monkeypatch):
    prompt_a = ["an art deco skyline"]
    prompt_b = ["a vaporwave fountain"]
    ref_a = mono(monkeypatch, sd_pipe, prompt_a, 31)
    srv = sd_pipe._staged_server()
    base = dict(srv.stats)
    state = {}

    def hook(s):
        # once both occupy slots, stall one boundary past B's deadline
        if (s.stats["admissions"] - base["admissions"] >= 2
                and "slept" not in state):
            state["slept"] = True
            time.sleep(0.7)

    srv._on_step = hook
    with ThreadPoolExecutor(max_workers=2) as ex:
        fa = ex.submit(sd_pipe.generate, prompt_a, 31)
        fb = ex.submit(lambda: sd_pipe.generate(prompt_b, 32,
                                                deadline_s=0.5))
        out_a = fa.result(timeout=120)
        with pytest.raises(DeadlineExceeded):
            fb.result(timeout=120)
    srv._on_step = None
    assert srv.stats["preemptions"] - base["preemptions"] >= 1
    assert any(e["kind"] == "stage.preempt"
               for e in flight_recorder.tail(100))
    assert np.array_equal(ref_a, out_a)
    assert sd_pipe.generate(prompt_b, seed=33).shape == out_a.shape


def test_kill_switch_routes_monolithic(sd_pipe, monkeypatch):
    srv = sd_pipe._staged_server()
    before = dict(srv.stats)
    monkeypatch.setenv(KILL, "1")
    out = sd_pipe.generate(["a quiet glass valley"], seed=41)
    assert out.dtype == np.uint8
    assert srv.stats == before


def test_brownout_tier_serves_monolithic(sd_pipe, monkeypatch):
    """An engaged tier serves its own degraded variant monolithic; the
    staged server sees nothing."""
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    srv = sd_pipe._staged_server()
    before = dict(srv.stats)
    ladder = poverload.BrownoutLadder(poverload.DEFAULT_TIERS,
                                      clock=lambda: 0.0,
                                      registry=type(metrics)())
    with ladder._lock:
        ladder._tier = 4
    monkeypatch.setattr(poverload, "_LADDER", ladder)
    out = sd_pipe.generate(["a quiet glass valley"], seed=42)
    monkeypatch.setattr(poverload, "_LADDER", None)
    assert out.shape[1] < sd_pipe.cfg.sampler.image_size
    assert srv.stats == before


def test_stage_metrics_events_spans_and_supervisor_health(sd_pipe):
    root = tracer.new_root_ctx()
    run_with_ctx(root, sd_pipe.generate, ["a velvet comet"], 51)
    snap = metrics.snapshot()
    assert snap["counters"].get("stage.denoise.admissions", 0) >= 1
    assert snap["counters"].get("stage.denoise.steps", 0) >= 1
    for name in ("stage.denoise.queue_wait_s", "stage.denoise.service_s",
                 "stage.encode.batch_size", "stage.decode.queue_wait_s"):
        assert name in snap["timings"], name
    assert 0.0 < snap["gauges"]["stage.denoise.slot_occupancy"] <= 1.0
    kinds = {e["kind"] for e in flight_recorder.tail(200)}
    assert {"stage.admit", "stage.retire"} <= kinds
    spans = {s["name"] for s in tracer.get_trace(root.trace_id) or []}
    assert {"stage.denoise.wait", "stage.denoise.service"} <= spans
    health = sd_pipe.supervisor.stage_health()
    assert {"encode", "denoise", "decode"} <= set(health)
    assert set(sd_pipe.supervisor.status()["stages"]) >= {
        "encode", "denoise", "decode"}


def test_tick_fault_fails_callers_not_hangs(sd_pipe):
    """A ``stage.denoise.tick`` fault while a request holds a slot fails
    that caller (the loop survives); the next request is clean."""
    srv = sd_pipe._staged_server()
    armed = {}

    def hook(s):
        if s._active_n and "on" not in armed:
            armed["on"] = True
            pchaos.configure("stage.denoise.tick=raise:times=1")

    srv._on_step = hook
    with pytest.raises(pchaos.ChaosInjected):
        sd_pipe.generate(["a broken loom"], seed=61)
    srv._on_step = None
    pchaos.disarm()
    assert metrics.counter_total("stage.denoise.loop_errors") >= 1
    assert sd_pipe.generate(["a mended loom"], seed=62).dtype == np.uint8


def test_stop_fails_pending_and_server_restarts(sd_pipe):
    srv = sd_pipe._staged_server()
    hold = threading.Event()

    def hook(s):
        while not hold.is_set() and not s._stop_evt.is_set():
            time.sleep(0.002)

    srv._on_step = hook
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(sd_pipe.generate, ["an unfinished bridge"], 71)
        deadline = time.monotonic() + 30.0
        while (not srv._pend and srv._admit_q.empty()
               and not srv._alive.any() and time.monotonic() < deadline):
            time.sleep(0.002)
        srv.stop()
        hold.set()
        with pytest.raises(QueueStopped):
            fut.result(timeout=60)
    srv._on_step = None
    assert sd_pipe.generate(["a rebuilt bridge"], seed=72).dtype == np.uint8


def test_poisoned_slot_is_quarantined_and_scrubbed(sd_pipe, monkeypatch):
    """device.poison at the admission seam: that request alone fails with
    OutputInvalid, the slot is scrubbed and freed, the content breaker
    counts it, and the next request admitted there is clean."""
    prompt = ["a glass orchard"]
    ref = mono(monkeypatch, sd_pipe, prompt, 81)
    srv = sd_pipe._staged_server()
    breaker = srv._supervisor.content_breaker
    failures = breaker.snapshot()["recent_failures"]
    before = srv.stats["quarantines"]
    pchaos.configure("device.poison=raise:peer=stage,times=1")
    with pytest.raises(OutputInvalid):
        sd_pipe.generate(prompt, seed=81)
    pchaos.disarm()
    assert srv.stats["quarantines"] == before + 1
    assert breaker.snapshot()["recent_failures"] == failures + 1
    assert any(e["kind"] == "stage.quarantine"
               for e in flight_recorder.tail(100))
    assert int(srv._alive.sum()) == 0
    assert np.array_equal(ref, sd_pipe.generate(prompt, seed=81))


def test_service_rebuild_drops_the_staged_server():
    """InferenceService wires its supervisor into the image pipeline;
    the device-loss rebuild drops the staged server, and the next
    generate makes a new one."""
    svc = InferenceService(staged(pconfig.test_config()), device="cpu",
                           table=None)
    try:
        t2i = svc.backend.t2i
        assert t2i.supervisor is svc.supervisor
        out = t2i.generate(["a harbor"], seed=5)
        first = t2i._staged
        assert first is not None and first.stats["retirements"] == 1
        assert "denoise" in svc.supervisor.status()["stages"]
        svc.rebuild_device_state()
        assert t2i._staged is None
        assert np.array_equal(out, t2i.generate(["a harbor"], seed=5))
        assert t2i._staged is not None and t2i._staged is not first
    finally:
        asyncio.run(svc.stop())
    assert svc.backend.t2i._staged is None


def test_server_refuses_configs_it_cannot_replay():
    for kw in ({"deepcache": True}, {"encprop": True}, {"eta": 0.5}):
        base = staged(pconfig.test_config())
        cfg = base.replace(sampler=dataclasses.replace(base.sampler, **kw))
        with pytest.raises(ValueError, match="staged serving"):
            StagedImageServer(cfg, torch.device("cpu"), encode_fn=None,
                              decode_fn=None, unet=None, tokenize=None,
                              vae_scale=2)


def test_probe_step_runs_a_width_and_restores_the_slots(sd_pipe):
    """The checks' seam: a width's step on the denoise thread from the
    current slot tensors, which are left as they were; duplicated rows in
    one step come out equal; widths and steps outside the server's
    refuse."""
    srv = sd_pipe._staged_server()
    sd_pipe.generate(["a probe"], seed=91)

    def state():
        return [t.clone() for t in (srv._lat, srv._aux, srv._counter,
                                    *srv._cond.values())]

    before = srv.run_on_denoise_thread(state)
    one, ms = srv.probe_step([0], step=1)
    assert ms is None and one.shape == (1,) + srv._lat.shape[1:]
    again, _ = srv.probe_step([0], step=1, graphed=False)
    assert torch.equal(one, again)
    two, _ = srv.probe_step([0, 1], step=1, same_rows=True)
    assert torch.equal(two[:1], two[1:])
    after = srv.run_on_denoise_thread(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    with pytest.raises(ValueError, match="width"):
        srv.probe_step([0, 1, 2, 0], step=0)
    with pytest.raises(ValueError, match="schedule"):
        srv.probe_step([0], step=srv.num_steps)
