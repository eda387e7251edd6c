"""The port's other samplers against the reference, on the CPU: Euler,
DPM-Solver++(2M) (with DeepCache pairs and encoder propagation), few-step
consistency sampling, DDIM at eta > 0 and img2img's schedule tails, with
``utils/jax_random.py`` against ``jax.random``.

Schedules must equal the reference's arrays. The sampler loops run under
one toy denoiser written in both frameworks (a tanh of a fixed linear map
of x plus t / 1000), so the solver arithmetic alone is compared: final
latents within 1e-5 of the reference's largest value (fp32). The graph
bodies (``SpecGraph``, ``SpecDeepCacheGraph``, ``EncpropGraph`` over each
solver; :class:`EagerStep` for the CUDA graph) equal the eager loops bit
for bit. Keys, bits and uniforms equal ``jax.random``'s bit for bit;
normals within 4 float32 ulps. The presets' whole tiny rounds are in
``test_torch_port_sampler_rounds.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.ops import ddim as jddim
from cassmantle_tpu.ops import samplers as jsamplers
from cassmantle_tpu.serving import pipeline as jpipeline
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.ops import ddim as port_ddim
from cassmantle_tpu_torch.ops import samplers as port_samplers
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.utils import jax_random

from _torch_port_common import EagerStep, assert_rel, randn

TOY_REL = 1e-5
NORMAL_ULPS = 4


# -- utils/jax_random.py against jax.random -----------------------------------

def _u32(t):
    return t.numpy().astype(np.uint32)


SEEDS = [0, 1, 7, 0x1C3, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, -1]
SHAPES = [(3,), (7,), (2, 5), (3, 3, 3), (1, 8, 8, 4), (2, 64, 64, 4)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    port = jax_random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(port), np.asarray(key))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(_u32(jax_random.split(port, n)),
                                      np.asarray(jax.random.split(key, n)))
    for data in (0, 1, 901, 2 ** 31 + 3):
        np.testing.assert_array_equal(
            _u32(jax_random.fold_in(port, data)),
            np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 1])
def test_bits_uniform_and_normal_match_jax(seed, shape):
    """Bits and uniforms (both ranges the reference draws) bit for bit;
    normals within a few float32 ulps (``log1p`` inside XLA's erfinv)."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    port = jax_random.split(jax_random.PRNGKey(seed))[1]
    np.testing.assert_array_equal(_u32(jax_random.random_bits(port, shape)),
                                  np.asarray(jax.random.bits(key, shape)))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    for minval, maxval in ((0.0, 1.0), (lo, 1.0)):
        ref = np.asarray(jax.random.uniform(key, shape, jnp.float32, minval,
                                            maxval))
        got = jax_random.uniform(port, shape, minval, maxval).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    ref = np.asarray(jax.random.normal(key, shape))
    got = jax_random.normal(port, shape).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS, ulps.max()


def test_erfinv_edges_match_xla():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 1e-30, 0.3, 0.99999994, 1.0],
                 np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = jax_random.erfinv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=4e-7, atol=0)


@pytest.mark.parametrize("t", [999, 740, 20, 1])
def test_consistency_renoise_matches_reference(t):
    ref = np.asarray(jsamplers.consistency_renoise(jnp.int32(t), (8, 8, 4)))
    got = port_samplers.consistency_renoise(t, (8, 8, 4)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS


# -- schedules -----------------------------------------------------------------

def _assert_fields_equal(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("n,start", [(4, 0), (24, 0), (25, 0), (50, 20),
                                     (7, 3), (10, 9)])
def test_schedules_equal_reference(n, start):
    _assert_fields_equal(
        port_samplers.EulerSchedule.create(n, start),
        jsamplers.EulerSchedule.create(n, start), ("timesteps", "sigmas"))
    _assert_fields_equal(
        port_samplers.DPMppSchedule.create(n, start),
        jsamplers.DPMppSchedule.create(n, start),
        ("timesteps", "alphas", "sigmas", "c_skip", "c_d0", "c_d1"))
    _assert_fields_equal(
        port_ddim.DDIMSchedule.create(n, start=start),
        jddim.DDIMSchedule.create(n, start=start),
        ("timesteps", "alpha_bars", "alpha_bars_prev"))


@pytest.mark.parametrize("n,teacher", [(1, 50), (2, 50), (4, 50), (8, 50),
                                       (3, 10), (9, 10)])
def test_consistency_schedule_equals_reference(n, teacher):
    _assert_fields_equal(
        port_samplers.ConsistencySchedule.create(n, teacher),
        jsamplers.ConsistencySchedule.create(n, teacher),
        ("timesteps", "alpha_bars", "alpha_bars_next", "c_skip", "c_out"))


def test_consistency_schedule_refuses_off_grid_counts():
    with pytest.raises(ValueError, match="teacher_steps-1"):
        port_samplers.ConsistencySchedule.create(10, 10)
    with pytest.raises(ValueError, match=">= 1"):
        port_samplers.ConsistencySchedule.create(0)


# -- the loops under a toy denoiser ---------------------------------------------

_RNG = np.random.default_rng(90)
X_T = randn(_RNG, 2, 8, 8, 4)
W = (0.5 * _RNG.standard_normal((4, 4))).astype(np.float32)
NOISE = randn(_RNG, 2, 8, 8, 4)


def jden(x, t):
    return jnp.tanh(x @ jnp.asarray(W) + t.astype(jnp.float32) / 1000.0)


def pden(x, t):
    return torch.tanh(x @ torch.from_numpy(W)
                      + t.to(torch.float32) / torch.tensor(1000.0))


# DeepCache and encprop stand-ins: the "deep" and "cache" are scaled x
def jfull(x, t):
    return jden(x, t), 0.5 * x


def pfull(x, t):
    return pden(x, t), 0.5 * x


def jshallow(x, t, deep):
    return jden(x + 0.1 * deep, t)


def pshallow(x, t, deep):
    return pden(x + 0.1 * deep, t)


def jkey(deepcache):
    def key(x, t):
        eps = jden(x, t)
        return (eps, 0.3 * x, 0.5 * x) if deepcache else (eps, 0.3 * x)
    return key


def pkey(deepcache):
    def key(x, t):
        eps = pden(x, t)
        return (eps, 0.3 * x, 0.5 * x) if deepcache else (eps, 0.3 * x)
    return key


def jprop(cache, ts):
    return jnp.stack([jden(cache, ts[i]) for i in range(ts.shape[0])])


def pprop(cache, ts):
    return torch.stack([pden(cache, ts[i:i + 1]) for i in range(ts.shape[0])])


def _x(np_array=X_T):
    return jnp.asarray(np_array), torch.from_numpy(np_array)


@pytest.mark.parametrize("kind", port_samplers.SAMPLER_KINDS)
@pytest.mark.parametrize("n", [1, 7, 25])
def test_make_sampler_matches_reference(kind, n):
    jx, px = _x()
    ref = jsamplers.make_sampler(kind, n)(jden, jx)
    schedule = port_samplers.make_schedule(kind, n)
    assert_rel(port_ddim.sample_spec(schedule.spec(px), pden, px), ref,
               TOY_REL)


@pytest.mark.parametrize("n,teacher", [(1, 50), (2, 50), (4, 50), (8, 50),
                                       (3, 10)])
def test_consistency_sample_matches_reference(n, teacher):
    jx, px = _x()
    ref = jsamplers.make_consistency_sampler(n, teacher)(jden, jx)
    schedule = port_samplers.make_schedule("ddim", n, consistency=True,
                                           teacher_steps=teacher)
    got = port_ddim.sample_spec(schedule.spec(px), pden, px)
    assert_rel(got, ref, TOY_REL)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_ddim_eta_matches_reference(seed):
    """DDIM at eta 0.5: the step noise drawn from the reference's split
    chain off PRNGKey(seed)."""
    jx, px = _x()
    ref = jddim.ddim_sample(jden, jx, jddim.DDIMSchedule.create(6), eta=0.5,
                            rng=jax.random.PRNGKey(seed))
    got = port_ddim.ddim_sample(pden, px, port_ddim.DDIMSchedule.create(6),
                                eta=0.5, key=jax_random.PRNGKey(seed))
    assert_rel(got, ref, TOY_REL)
    plain = port_ddim.ddim_sample(pden, px, port_ddim.DDIMSchedule.create(6))
    assert not torch.allclose(got, plain)


def test_ddim_eta_needs_a_key():
    with pytest.raises(ValueError, match="eta > 0 requires an rng key"):
        port_ddim.ddim_sample(pden, torch.from_numpy(X_T),
                              port_ddim.DDIMSchedule.create(4), eta=0.5)


@pytest.mark.parametrize("kind", port_samplers.SAMPLER_KINDS)
@pytest.mark.parametrize("n,start", [(10, 4), (10, 0), (50, 20), (10, 9)])
def test_img2img_sampler_matches_reference(kind, n, start):
    """``prepare`` (VP or k-space entry at ``start``) equal, the tail
    within 1e-5."""
    jprep, jsample = jsamplers.make_img2img_sampler(kind, n, start)
    pprep, schedule = port_samplers.img2img_start(kind, n, start)
    jx0, px0 = _x()
    jn, pn = _x(NOISE)
    ref_x = np.asarray(jprep(jx0, jn))
    got_x = pprep(px0, pn)
    np.testing.assert_array_equal(got_x.numpy(), ref_x)
    assert_rel(port_ddim.sample_spec(schedule.spec(got_x), pden, got_x),
               jsample(jden, jnp.asarray(ref_x)), TOY_REL)


@pytest.mark.parametrize("n", [6, 7, 24, 25])
def test_dpmpp_deepcache_matches_reference(n):
    """Pairs threading m1; an odd count ends on an unpaired full step."""
    jx, px = _x()
    ref = jsamplers.dpmpp_2m_sample_deepcache(
        jfull, jshallow, jx, jsamplers.DPMppSchedule.create(n))
    got = port_ddim.sample_spec_deepcache(
        port_samplers.DPMppSchedule.create(n).spec(px), pfull, pshallow, px)
    assert_rel(got, ref, TOY_REL)


@pytest.mark.parametrize("kind,deepcache", [("ddim", False), ("ddim", True),
                                            ("euler", False),
                                            ("dpmpp_2m", False),
                                            ("dpmpp_2m", True)])
@pytest.mark.parametrize("n,stride,dense", [(8, 3, 1), (7, 3, 0),
                                            (10, 2, 2)])
def test_encprop_sampler_matches_reference(kind, deepcache, n, stride,
                                           dense):
    jx, px = _x()
    ref = jsamplers.make_encprop_sampler(kind, n, stride, dense, deepcache)(
        jkey(deepcache), jprop, jx,
        denoise_shallow=jshallow if deepcache else None)
    got = port_ddim.encprop_sample(
        port_samplers.make_schedule(kind, n).spec(px), pkey(deepcache),
        pprop, px, stride, dense,
        denoise_shallow=pshallow if deepcache else None)
    assert_rel(got, ref, TOY_REL)


def test_encprop_sampler_refusals_match_reference():
    """Encoder propagation over euler with DeepCache, and an unknown
    kind, are refused when the pipeline is built, with the reference's
    sampler factories' errors."""
    s = _tiny(kind="euler", encprop=True, encprop_dense_steps=0,
              deepcache=True).sampler
    with pytest.raises(AssertionError, match="not 'euler'"):
        jsamplers.make_encprop_sampler("euler", 8, 3, 0, deepcache=True)
    for check in (port_pipeline.encprop_plan, port_pipeline.sampler_mode):
        with pytest.raises(AssertionError, match="not 'euler'"):
            check(s)
    for make in (jsamplers.make_sampler, port_samplers.make_schedule):
        with pytest.raises(ValueError, match="unknown sampler kind"):
            make("heun", 8)
    with pytest.raises(ValueError, match="unknown sampler kind"):
        port_pipeline.sampler_mode(_tiny(kind="heun").sampler)


# -- the graph bodies, run eagerly ---------------------------------------------

def _schedule(kind, n):
    return {"euler": port_samplers.EulerSchedule,
            "dpmpp_2m": port_samplers.DPMppSchedule,
            "ddim": port_ddim.DDIMSchedule}[kind].create(n)


def _toy_inputs():
    return {"context": torch.ones(2, 3)}


@pytest.mark.parametrize("which", ["euler", "dpmpp_2m", "consistency",
                                   "euler_tail", "dpmpp_2m_tail",
                                   "ddim_eta"])
def test_spec_graph_equals_the_eager_loop(which, monkeypatch):
    """``SpecGraph``'s one step graph, replayed T times, equals the eager
    spec loop bit for bit, twice (the second call after the warm-up moved
    the static carry, on other latents); the carry (DPM++'s (x, m1)) is
    reset by each call."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    if which == "consistency":
        schedule = port_samplers.ConsistencySchedule.create(4)
    elif which.endswith("_tail"):
        _, schedule = port_samplers.img2img_start(which[:-5], 10, 4)
    elif which == "ddim_eta":
        sched = port_ddim.DDIMSchedule.create(5)
        noise = jax_random.normal(jax_random.PRNGKey(1), (5, 2, 8, 8, 4))

        class schedule:                                      # noqa: N801
            @staticmethod
            def spec(latents):
                return sched.eta_spec(0.5, noise)
    else:
        schedule = _schedule(which, 7)
    make = lambda context: pden                             # noqa: E731
    x_t = torch.from_numpy(X_T)
    with torch.inference_mode():
        graph = port_ddim.SpecGraph(make, schedule, x_t, **_toy_inputs())
        for lat in (x_t, x_t * 0.5):
            got = graph(lat, **_toy_inputs())
            want = port_ddim.sample_spec(schedule.spec(lat), pden, lat)
            assert torch.equal(got, want)
    assert graph.graphs["step"].replays == 2 * graph.num_steps
    assert len(graph.carry) == (2 if which.startswith("dpmpp") else 1)


@pytest.mark.parametrize("n", [6, 7])
def test_spec_deepcache_graph_equals_the_eager_loop(n, monkeypatch):
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    schedule = port_samplers.DPMppSchedule.create(n)
    make = lambda context: (pfull, pshallow)                # noqa: E731
    x_t = torch.from_numpy(X_T)
    with torch.inference_mode():
        graph = port_ddim.SpecDeepCacheGraph(make, schedule, x_t,
                                             **_toy_inputs())
        for lat in (x_t, x_t * 0.5):
            got = graph(lat, **_toy_inputs())
            want = port_ddim.sample_spec_deepcache(
                schedule.spec(lat), pfull, pshallow, lat)
            assert torch.equal(got, want)
    replays = {k: g.replays for k, g in graph.graphs.items()}
    assert replays == ({"pair": 6, "tail": 2} if n % 2 else {"pair": 6})
    assert int(graph.step) == n


@pytest.mark.parametrize("kind,deepcache", [("euler", False),
                                            ("dpmpp_2m", False),
                                            ("dpmpp_2m", True)])
def test_encprop_graph_over_each_solver(kind, deepcache, monkeypatch):
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    schedule = _schedule(kind, 8)
    make = lambda context: (pkey(deepcache), pprop,         # noqa: E731
                            pshallow if deepcache else None)
    x_t = torch.from_numpy(X_T)
    with torch.inference_mode():
        graph = port_ddim.EncpropGraph(make, schedule, x_t, 3, 1,
                                       **_toy_inputs())
        for lat in (x_t, x_t * 0.5):
            got = graph(lat, **_toy_inputs())
            want = port_ddim.encprop_sample(
                schedule.spec(lat), pkey(deepcache), pprop, lat, 3, 1,
                denoise_shallow=pshallow if deepcache else None)
            assert torch.equal(got, want)
    assert {k: g.replays for k, g in graph.graphs.items()} == {
        "key": 2, "segment": 4, "tail": 2}


# -- the pipeline's validation and dispatch ------------------------------------

def _tiny(**sampler_kw):
    cfg = port_config.test_config()
    return cfg.replace(sampler=dataclasses.replace(cfg.sampler,
                                                   **sampler_kw))


PRESETS = ("fast_serving_config", "turbo_serving_config",
           "lcm_serving_config")


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    """The presets' sampler fields (every one the port keeps) and model
    flags equal the reference's; each serves its loop."""
    port, ref = getattr(port_config, name)(), getattr(jax_config, name)()
    for f in dataclasses.fields(port.sampler):
        assert getattr(port.sampler, f.name) == getattr(ref.sampler,
                                                        f.name), f.name
    assert port.models.vae == port_config.VAEConfig()
    assert port.models.unet == port_config.UNetConfig()
    assert port_pipeline.sampler_mode(port.sampler) == {
        "fast_serving_config": "dpmpp_2m",
        "turbo_serving_config": "deepcache",
        "lcm_serving_config": "consistency"}[name]


@pytest.mark.parametrize("kw", [
    dict(kind="euler"), dict(kind="dpmpp_2m", num_steps=7),
    dict(kind="dpmpp_2m", deepcache=True, num_steps=7),
    dict(kind="euler", encprop=True, num_steps=8, encprop_dense_steps=1),
    dict(consistency=True, num_steps=4),
    dict(consistency=True, num_steps=2, consistency_teacher_steps=10)])
def test_validation_matches_reference(kw):
    """Configs both accept: the reference's validators pass, and the port
    serves the same loop as ``run_cfg_denoise`` would."""
    port = _tiny(**kw).sampler
    ref = dataclasses.replace(jax_config.test_config().sampler, **kw)
    if ref.deepcache:
        jpipeline.deepcache_schedule(ref)
    if ref.encprop:
        jpipeline.encprop_plan(ref)
    if ref.consistency:
        jpipeline.consistency_plan(ref)
        assert port_pipeline.consistency_plan(port) == \
            jpipeline.consistency_plan(ref)
    if ref.encprop:
        assert port_pipeline.encprop_plan(port) == jpipeline.encprop_plan(ref)
    assert port_pipeline.effective_sampler_steps(port) == \
        jpipeline.effective_sampler_steps(ref)
    want = ("consistency" if ref.consistency else "encprop" if ref.encprop
            else "deepcache" if ref.deepcache else ref.kind)
    assert port_pipeline.sampler_mode(port) == want


def test_consistency_kill_switch_reverts_to_the_teacher(monkeypatch,
                                                        sampler_unet):
    """CASSMANTLE_NO_CONSISTENCY (read at build) serves the teacher path:
    the configured kind at ``consistency_teacher_steps``, bit for bit the
    plain pipeline's at that count (here DDIM at 6)."""
    sd, x_t, cond = sampler_unet
    cfg = _tiny(consistency=True, num_steps=2, consistency_teacher_steps=6)
    with torch.inference_mode():
        armed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
        assert armed.full_variant.mode == "consistency"
        monkeypatch.setenv("CASSMANTLE_NO_CONSISTENCY", "1")
        assert port_samplers.consistency_disabled()
        killed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
        teacher = Text2ImagePipeline(_tiny(num_steps=6), device="cpu",
                                     state_dicts=sd)
        assert killed.full_variant.mode == "ddim"
        assert port_pipeline.effective_sampler_steps(cfg.sampler) == 6
        got = killed.denoise(x_t, cond, graphed=False)
        assert torch.equal(got, teacher.denoise(x_t, cond, graphed=False))
        assert not torch.equal(got, armed.denoise(x_t, cond, graphed=False))
        monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
        assert torch.equal(killed.denoise(x_t, cond, graphed=True), got)


def test_pipeline_refuses_eta_as_the_reference(sampler_unet):
    """DDIM at eta > 0 builds, as the reference's pipeline does, and its
    denoise raises the reference's error (no step key); Euler and DPM++
    ignore eta, as there."""
    sd, x_t, cond = sampler_unet
    pipe = Text2ImagePipeline(_tiny(eta=0.5), device="cpu", state_dicts=sd)
    for graphed in (False, True):
        with pytest.raises(ValueError, match="eta > 0 requires an rng key"):
            pipe.denoise(x_t, cond, graphed=graphed)
    with torch.inference_mode():
        euler = Text2ImagePipeline(_tiny(kind="euler", eta=0.5),
                                   device="cpu", state_dicts=sd)
        plain = Text2ImagePipeline(_tiny(kind="euler"), device="cpu",
                                   state_dicts=sd)
        assert torch.equal(euler.denoise(x_t, cond, graphed=False),
                           plain.denoise(x_t, cond, graphed=False))


@pytest.fixture(scope="module")
def sampler_unet():
    """A tiny UNet state dict (the seeded init), CFG conditioning and
    x_T."""
    pipe = Text2ImagePipeline(port_config.test_config(), device="cpu")
    rng = np.random.default_rng(91)
    x_t = torch.from_numpy(randn(rng, 2, 8, 8, 4))
    cond = {"context": torch.from_numpy(randn(rng, 2, 16, 64)),
            "uncond_context": torch.from_numpy(randn(rng, 2, 16, 64))}
    return {"unet": pipe.unet.state_dict()}, x_t, cond


@pytest.mark.parametrize("kw,counts", [
    (dict(kind="dpmpp_2m", num_steps=5), {"step": 5}),
    (dict(kind="dpmpp_2m", num_steps=5, deepcache=True),
     {"pair": 2, "tail": 1}),
    (dict(consistency=True, num_steps=4), {"step": 4}),
    (dict(kind="euler", num_steps=4), {"step": 4}),
    (dict(kind="dpmpp_2m", num_steps=7, encprop=True,
          encprop_dense_steps=1, deepcache=True),
     {"key": 1, "segment": 2})])
def test_pipeline_graphed_denoise_equals_eager(kw, counts, sampler_unet,
                                               monkeypatch):
    """The pipeline's graphed loop (:class:`EagerStep` for the graph) of
    each new mode equals its eager loop bit for bit, one loop per batch
    size, each body replayed as the plan says."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    sd, x_t, cond = sampler_unet
    pipe = Text2ImagePipeline(_tiny(**kw), device="cpu", state_dicts=sd)
    with torch.inference_mode():
        eager = pipe.denoise(x_t, cond, graphed=False)
        graphed = pipe.denoise(x_t, cond, graphed=True)
    assert torch.equal(eager, graphed)
    assert list(pipe.full_variant.step_graphs) == [2]
    graphs = pipe.full_variant.step_graphs[2].graphs
    assert {k: g.replays for k, g in graphs.items()} == counts
