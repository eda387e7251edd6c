"""Encoder propagation, DeepCache and the fused VAE of the port against
the reference, on the CPU at ``test_config()`` sizes.

Reference parameter trees and inputs are made with numpy from a seed and
fed to both sides (``_torch_port_common``), in fp32. Tolerances: UNet
outputs and sampler latents within 1e-4 of the reference's largest value
(fp32 summation order), the fused VAE decoder within 2e-5 (the bar the
reference holds its own fused VAE to), uint8 images within 2 levels (mean
0.5). The port's eager loops and its graph bodies (``SamplerGraph`` with
:class:`EagerStep` for the CUDA graph, as in ``test_torch_port_graphs``)
agree bit for bit. The reference's fused VAE cannot run here (its Pallas
entry raises under the installed jax), so the port's fused decoder is
held against the reference's unfused one on the same tree.

The port's UNet hands out its caches as NCHW activations; the tests
permute them to the reference's NHWC. The presets' whole tiny rounds are
in ``test_torch_port_encprop_rounds.py``.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.config import test_sdxl_config as jax_test_sdxl_config
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.ops import ddim as jddim
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.vae import VAEDecoder, VAEResBlock
from cassmantle_tpu_torch.ops import ddim as port_ddim
from cassmantle_tpu_torch.ops import fused_conv
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

from _torch_port_common import EagerStep, assert_rel, jax_params, load, randn

REL = 1e-4
CTX_LEN = 16


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


# -- the UNet's three modes ---------------------------------------------------

def _unet_case(which):
    sdxl = which == "sdxl"
    cfg = jax_test_sdxl_config() if sdxl else jax_test_config()
    mu = cfg.models.unet
    rng = np.random.default_rng(71 if sdxl else 72)
    x = randn(rng, 2, 8, 8, 4)
    t = np.array([5, 901], dtype=np.int32)
    ctx = randn(rng, 2, CTX_LEN, mu.context_dim)
    extra = (randn(rng, 2, mu.addition_embed_dim),) if sdxl else ()
    unet = JUNet(mu)
    args = tuple(map(jnp.asarray, (x, t, ctx) + extra))
    params = jax_params(unet, 73, *args)
    port_cfg = (port_config.test_sdxl_config() if sdxl
                else port_config.test_config())
    port = load(UNet(port_cfg.models.unet), params,
                "unet_xl" if sdxl else "unet")
    targs = tuple(map(torch.from_numpy, (x, t, ctx) + extra))
    return dict(unet=unet, params=params, args=args, port=port, targs=targs,
                add=extra[0] if sdxl else None)


@pytest.fixture(scope="module", params=["sd15", "sdxl"])
def unet_case(request):
    return _unet_case(request.param)


def _ref(c, *mode):
    """The reference UNet with positional mode arguments after the
    addition embeds: (deep_cache, return_deep, skips_cache,
    return_skips)."""
    add = None if c["add"] is None else jnp.asarray(c["add"])
    return c["unet"].apply(c["params"], *c["args"][:3], add, *mode)


def _port(c, **mode):
    x, t, ctx = c["targs"][:3]
    add = c["targs"][3] if len(c["targs"]) > 3 else None
    with torch.inference_mode():
        return c["port"](x, t, ctx, add, **mode)


def test_unet_return_deep_and_shallow_pass(unet_case):
    """``return_deep`` gives eps and the activation entering level 0 of
    the up path; ``deep_cache=`` (the reference's own deep activation,
    fed to both) runs the shallow pass on other latents. Each within
    1e-4; a same-step deep cache reproduces the full forward."""
    c = unet_case
    eps_r, deep_r = _ref(c, None, True)
    eps_p, deep_p = _port(c, return_deep=True)
    assert_rel(eps_p, eps_r, REL)
    assert_rel(nhwc(deep_p), deep_r, REL)
    assert_rel(_port(c, deep_cache=deep_p), eps_p, 1e-6)
    add = None if c["add"] is None else jnp.asarray(c["add"])
    shallow_r = c["unet"].apply(c["params"], c["args"][0] * 0.5,
                                *c["args"][1:3], add, deep_r)
    x, t, ctx = c["targs"][:3]
    with torch.inference_mode():
        shallow_p = c["port"](x * 0.5, t, ctx, *c["targs"][3:],
                              deep_cache=nchw(deep_r))
    assert_rel(shallow_p, shallow_r, REL)
    assert not np.allclose(np.asarray(shallow_r), np.asarray(eps_r))


def test_unet_return_skips_and_decoder_only_pass(unet_case):
    """``return_skips`` gives the skip stack and the up-path entry; the
    decoder-only pass (``latents=None``, the reference's cache fed to
    both) at other timesteps. Each within 1e-4; a same-step cache
    reproduces the full forward."""
    c = unet_case
    eps_r, (skips_r, entry_r) = _ref(c, None, False, None, True)
    eps_p, (skips_p, entry_p) = _port(c, return_skips=True)
    assert_rel(eps_p, eps_r, REL)
    assert len(skips_p) == len(skips_r)
    for sp, sr in zip(skips_p, skips_r):
        assert_rel(nhwc(sp), sr, REL)
    assert_rel(nhwc(entry_p), entry_r, REL)
    cache_p = (tuple(nchw(s) for s in skips_r), nchw(entry_r))
    add = None if c["add"] is None else jnp.asarray(c["add"])
    t2 = np.array([400, 3], dtype=np.int32)
    dec_r = c["unet"].apply(c["params"], None, jnp.asarray(t2),
                            c["args"][2], add, None, False,
                            (skips_r, entry_r))
    with torch.inference_mode():
        dec_p = c["port"](None, torch.from_numpy(t2), c["targs"][2],
                          c["targs"][3] if c["add"] is not None else None,
                          skips_cache=cache_p)
        same = c["port"](None, c["targs"][1], c["targs"][2],
                         c["targs"][3] if c["add"] is not None else None,
                         skips_cache=(skips_p, entry_p))
    assert_rel(dec_p, dec_r, REL)
    assert_rel(same, eps_p, 1e-6)


def test_unet_both_returns_and_exclusive_modes(unet_case):
    """Both return flags together give (eps, deep, (skips, entry)) as the
    reference; the two cache inputs exclude each other, latents=None
    needs a skips cache, and return_skips needs the full encoder."""
    c = unet_case
    eps_r, deep_r, (skips_r, entry_r) = _ref(c, None, True, None, True)
    eps_p, deep_p, (skips_p, entry_p) = _port(c, return_deep=True,
                                              return_skips=True)
    assert_rel(eps_p, eps_r, REL)
    assert_rel(nhwc(deep_p), deep_r, REL)
    assert_rel(nhwc(entry_p), entry_r, REL)
    for sp, sr in zip(skips_p, skips_r):
        assert_rel(nhwc(sp), sr, REL)
    x, t, ctx = c["targs"][:3]
    with pytest.raises(AssertionError, match="mutually exclusive"):
        c["port"](x, t, ctx, deep_cache=deep_p,
                  skips_cache=(skips_p, entry_p))
    with pytest.raises(AssertionError, match="latents may be None"):
        c["port"](None, t, ctx)
    with pytest.raises(AssertionError, match="full encoder"):
        c["port"](x, t, ctx, deep_cache=deep_p, return_skips=True)


def test_flash_sites_per_forward_mode_follow_the_unet(monkeypatch):
    """chip_smoke's flash tallies per UNet forward, counted on a UNet of
    SD1.5's structure at tiny widths (four levels, attention at the first
    three, two blocks a level, 8x8 latents): each mode launches flash at
    the levels and batch chip_smoke names (a full forward 16 self and 16
    cross, the decoder-only forward at P = 2 the up path's 9 each at
    batch 4, the shallow forward level 0's 5 each)."""
    import chip_smoke

    from cassmantle_tpu_torch.ops import attention

    cfg = dataclasses.replace(
        port_config.UNetConfig(), base_channels=32, context_dim=64,
        time_embed_dim=128, dtype="float32")
    unet = UNet(cfg).eval()
    torch.manual_seed(0)
    for prm in unet.parameters():
        torch.nn.init.normal_(prm, std=0.02)
    calls = []
    real = attention.flash_attention

    def recording(q, k, v, **kw):
        level = {64: "l0", 16: "l1", 4: "l2", 1: "mid"}[q.shape[1]]
        kind = "self" if k.shape[1] == q.shape[1] else "cross"
        calls.append(f"{kind}_{level}" + ("_b4" if q.shape[0] == 4 else ""))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", recording)
    x = torch.randn(2, 8, 8, 4)
    t = torch.tensor([500], dtype=torch.int32)
    ctx = torch.randn(2, 77, 64)
    counts = {}
    with torch.inference_mode():
        _, deep, cache = unet(x, t.expand(2), ctx, return_deep=True,
                              return_skips=True)
        for mode, run in (
                ("full", lambda: unet(x, t.expand(2), ctx)),
                ("decoder_only", lambda: port_ddim.cfg_denoiser_encprop(
                    unet, ctx, 7.5)[1](cache, t.expand(2))),
                ("shallow", lambda: unet(x, t.expand(2), ctx,
                                         deep_cache=deep))):
            calls.clear()
            run()
            counts[mode] = dict(collections.Counter(calls))
    assert counts == chip_smoke.UNET_FLASH
    assert {m: sum(c.values()) for m, c in counts.items()} == {
        "full": 32, "decoder_only": 18, "shallow": 10}


# -- the key schedule ---------------------------------------------------------

SCHEDULES = [(50, 3, 5), (10, 3, 2), (8, 1, 0), (8, 8, 0), (6, 2, 6),
             (8, 4, 0), (7, 3, 1), (8, 3, 0)]


@pytest.mark.parametrize("deepcache", [False, True])
@pytest.mark.parametrize("n,stride,dense", SCHEDULES)
def test_key_schedule_and_counts_match_reference(n, stride, dense,
                                                 deepcache):
    np.testing.assert_array_equal(
        port_ddim.encprop_key_indices(n, stride, dense),
        jddim.encprop_key_indices(n, stride, dense))
    assert port_ddim._encprop_plan(n, stride, dense) == \
        jddim._encprop_plan(n, stride, dense)
    assert port_ddim.encprop_step_counts(n, stride, dense, deepcache) == \
        jddim.encprop_step_counts(n, stride, dense, deepcache)


def test_serving_schedule_counts():
    """The serving preset's schedule: 20 key forwards and 30 propagated
    steps (15 segments of 3 after 5 dense keys); DeepCache alone pairs
    25 full with 25 shallow forwards."""
    s = port_config.encprop_serving_config().sampler
    assert port_ddim.encprop_step_counts(
        s.num_steps, s.encprop_stride, s.encprop_dense_steps) == (20, 0, 30)
    assert port_ddim._encprop_plan(50, 3, 5) == (5, 15, 0)
    with pytest.raises(ValueError):
        port_ddim.encprop_key_indices(8, 0)
    with pytest.raises(ValueError):
        port_ddim.encprop_key_indices(8, 3, 9)


# -- the samplers -------------------------------------------------------------

@pytest.fixture(scope="module")
def sampler_case():
    """The tiny UNet's parameters, CFG conditioning and x_T, loaded into
    the port."""
    cfg = jax_test_config()
    mu = cfg.models.unet
    rng = np.random.default_rng(74)
    x_t = randn(rng, 2, 8, 8, 4)
    ctx, uctx = (randn(rng, 2, CTX_LEN, mu.context_dim) for _ in range(2))
    unet = JUNet(mu)
    params = jax_params(unet, 75, jnp.asarray(x_t),
                        jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, CTX_LEN, mu.context_dim)))
    port = load(UNet(port_config.test_config().models.unet), params, "unet")
    return dict(unet=unet, params=params, x_t=x_t, ctx=ctx, uctx=uctx,
                port=port)


def _jax_encprop(c, n, stride, dense, deepcache, batch_props=True):
    key, prop, shallow = jddim.make_cfg_denoiser_encprop(
        c["unet"].apply, c["params"], jnp.asarray(c["ctx"]),
        jnp.asarray(c["uctx"]), 7.5, deepcache=deepcache)
    return np.asarray(jddim.ddim_sample_encprop(
        key, prop, jnp.asarray(c["x_t"]), jddim.DDIMSchedule.create(n),
        stride, dense, denoise_shallow=shallow, batch_props=batch_props))


def _port_encprop(c, n, stride, dense, deepcache, batch_props=True):
    key, prop, shallow = port_ddim.make_cfg_denoiser_encprop(
        c["port"], torch.from_numpy(c["ctx"]), torch.from_numpy(c["uctx"]),
        7.5, deepcache=deepcache)
    with torch.inference_mode():
        return port_ddim.ddim_sample_encprop(
            key, prop, torch.from_numpy(c["x_t"]),
            port_ddim.DDIMSchedule.create(n), stride, dense,
            denoise_shallow=shallow, batch_props=batch_props)


@pytest.mark.parametrize("deepcache", [False, True])
def test_encprop_sample_matches_reference(sampler_case, deepcache):
    """7 steps, stride 3, one dense key: keys at 0, 1 and 4; with
    DeepCache the second step of each segment runs shallow.
    Batched propagated steps land on the reference's final latents
    within 1e-4, and the unbatched ones on the batched ones within
    1e-6 (each batch row is a single step's forward)."""
    c = sampler_case
    ref = _jax_encprop(c, 7, 3, 1, deepcache)
    got = _port_encprop(c, 7, 3, 1, deepcache)
    assert_rel(got, ref, REL)
    unbatched = _port_encprop(c, 7, 3, 1, deepcache, batch_props=False)
    assert_rel(unbatched, got.numpy(), 1e-6)


def test_encprop_tail_of_two_with_deepcache_matches_reference(sampler_case):
    """Stride 3 from step 0 over 5 steps: one segment and a tail of two
    (key + shallow)."""
    c = sampler_case
    ref = _jax_encprop(c, 5, 3, 0, True)
    assert_rel(_port_encprop(c, 5, 3, 0, True), ref, REL)


def test_encprop_stride_one_is_the_plain_sampler(sampler_case):
    """At stride 1 every step is a key step: the plain DDIM loop's
    latents, bit for bit."""
    c = sampler_case
    sched = port_ddim.DDIMSchedule.create(4)
    plain = port_ddim.make_cfg_denoiser(
        c["port"], torch.from_numpy(c["ctx"]), torch.from_numpy(c["uctx"]),
        7.5)
    with torch.inference_mode():
        want = port_ddim.ddim_sample(plain, torch.from_numpy(c["x_t"]),
                                     sched)
    assert torch.equal(_port_encprop(c, 4, 1, 0, False), want)


def _deepcache_pair(c):
    return port_ddim.make_cfg_denoiser_pair(
        c["port"], torch.from_numpy(c["ctx"]), torch.from_numpy(c["uctx"]),
        7.5)


def test_ddim_sample_deepcache_matches_reference(sampler_case):
    c = sampler_case
    full, shallow = jddim.make_cfg_denoiser_pair(
        c["unet"].apply, c["params"], jnp.asarray(c["ctx"]),
        jnp.asarray(c["uctx"]), 7.5)
    ref = jddim.ddim_sample_deepcache(full, shallow, jnp.asarray(c["x_t"]),
                                      jddim.DDIMSchedule.create(6))
    with torch.inference_mode():
        got = port_ddim.ddim_sample_deepcache(
            *_deepcache_pair(c), torch.from_numpy(c["x_t"]),
            port_ddim.DDIMSchedule.create(6))
    assert_rel(got, np.asarray(ref), REL)
    with pytest.raises(ValueError, match="even step count"):
        port_ddim.ddim_sample_deepcache(*_deepcache_pair(c),
                                        torch.from_numpy(c["x_t"]),
                                        port_ddim.DDIMSchedule.create(5))


# -- the graph bodies, run eagerly --------------------------------------------

def _inputs(c):
    return port_ddim.cfg_inputs(torch.from_numpy(c["ctx"]),
                                torch.from_numpy(c["uctx"]))


@pytest.mark.parametrize("n,stride,dense,deepcache", [
    (8, 3, 1, False), (8, 3, 1, True), (8, 3, 0, True), (7, 3, 1, False)])
def test_encprop_graph_bodies_match_the_eager_loop(sampler_case, n, stride,
                                                   dense, deepcache,
                                                   monkeypatch):
    """``EncpropGraph`` (key graph over the dense prefix, segment graph,
    tail graph; :class:`EagerStep` for the CUDA graph) equals the eager
    :func:`ddim_sample_encprop` bit for bit, twice, the second time on
    other inputs after the warm-up moved its buffers; each body replays
    as often as the plan says."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    c = sampler_case
    sched = port_ddim.DDIMSchedule.create(n)
    make = lambda **kw: port_ddim.cfg_denoiser_encprop(
        c["port"], guidance_scale=7.5, deepcache=deepcache, **kw)
    inputs = _inputs(c)
    x_t = torch.from_numpy(c["x_t"])
    other = {k: None if v is None else v.flip(0) for k, v in inputs.items()}
    with torch.inference_mode():
        graph = port_ddim.EncpropGraph(make, sched, x_t, stride, dense,
                                       **inputs)
        for lat, inp in ((x_t, inputs), (x_t * 0.5, other)):
            got = graph(lat, **inp)
            key, prop, shallow = make(**inp)
            want = port_ddim.ddim_sample_encprop(
                key, prop, lat, sched, stride, dense,
                denoise_shallow=shallow)
            assert torch.equal(got, want)
    _, nseg, tail = port_ddim._encprop_plan(n, stride, dense)
    want_replays = {"key": 2 * dense, "segment": 2 * nseg,
                    "tail": 2 if tail else None}
    got_replays = {k: graph.graphs[k].replays if k in graph.graphs else None
                   for k in want_replays}
    assert got_replays == {k: v or None for k, v in want_replays.items()}
    assert int(graph.step) == n


def test_deepcache_graph_body_matches_the_eager_loop(sampler_case,
                                                     monkeypatch):
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    c = sampler_case
    sched = port_ddim.DDIMSchedule.create(6)
    make = lambda **kw: port_ddim.cfg_denoiser_pair(
        c["port"], guidance_scale=7.5, **kw)
    inputs = _inputs(c)
    x_t = torch.from_numpy(c["x_t"])
    with torch.inference_mode():
        graph = port_ddim.SpecDeepCacheGraph(make, sched, x_t, **inputs)
        got = graph(x_t, **inputs)
        want = port_ddim.ddim_sample_deepcache(*make(**inputs), x_t, sched)
    assert torch.equal(got, want)
    assert graph.graphs["pair"].replays == 3 and int(graph.step) == 6


# -- the fused VAE decoder ----------------------------------------------------

def test_fused_vae_decoder_matches_reference():
    """``VAEDecoder(fused_conv=True)`` on the CPU (the plain version of
    the kernel at every ResBlock, channels-last throughout) against the
    reference's unfused decoder on the same tree: 2e-5 in fp32. The
    kill switch takes the unfused path on the same tree."""
    cfg = jax_test_config().models.vae
    lat = randn(np.random.default_rng(76), 2, 8, 8, 4)
    params = jax_params(JVAE(cfg), 77, jnp.asarray(lat))
    ref = np.asarray(JVAE(cfg).apply(params, jnp.asarray(lat)))
    port_cfg = dataclasses.replace(port_config.test_config().models.vae,
                                   fused_conv=True)
    assert port_cfg.arch() == port_config.test_config().models.vae
    port = load(VAEDecoder(port_cfg), params, "vae")
    layouts = []
    for m in port.modules():
        if isinstance(m, VAEResBlock):
            m.register_forward_pre_hook(lambda _, a: layouts.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    calls = []
    real = fused_conv.gn_silu_conv3x3

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr("cassmantle_tpu_torch.models.layers.gn_silu_conv3x3",
                   counting)
        out = port(torch.from_numpy(lat))
        n_fused = len(calls)
        mp.setenv("CASSMANTLE_NO_FUSED_CONV", "1")
        unfused = port(torch.from_numpy(lat))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(unfused.numpy(), ref, atol=2e-5, rtol=2e-5)
    assert layouts and all(layouts), layouts
    # 2 mid + 2 levels x 2 ResBlocks, two convs each; none unfused
    assert n_fused == 12 and len(calls) == 12


# -- the kill switch and the refusals -----------------------------------------

def _tiny(**sampler_kw):
    cfg = port_config.test_config()
    return cfg.replace(sampler=dataclasses.replace(cfg.sampler,
                                                   **sampler_kw))


def test_kill_switch_serves_full_forwards(sampler_case, monkeypatch):
    """CASSMANTLE_NO_ENCPROP (read when the pipeline is built) serves an
    encprop config with a full forward at every step: the plain DDIM
    loop, bit for bit, or DeepCache's when composed."""
    c = sampler_case
    sd = {"unet": c["port"].state_dict()}
    cfg = _tiny(encprop=True, num_steps=8, encprop_dense_steps=1)
    x_t = torch.from_numpy(c["x_t"])
    cond = {"context": torch.from_numpy(c["ctx"]),
            "uncond_context": torch.from_numpy(c["uctx"])}
    with torch.inference_mode():
        armed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
        assert armed.full_variant.mode == "encprop"
        assert armed.full_variant.encprop_counts == (4, 0, 4)
        monkeypatch.setenv("CASSMANTLE_NO_ENCPROP", "1")
        assert port_ddim.encprop_disabled()
        killed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
        plain = Text2ImagePipeline(_tiny(num_steps=8), device="cpu",
                                   state_dicts=sd)
        assert killed.full_variant.mode == "ddim"
        assert killed.full_variant.encprop_counts is None
        got = killed.denoise(x_t, cond, graphed=False)
        assert torch.equal(got, plain.denoise(x_t, cond, graphed=False))
        assert not torch.equal(got, armed.denoise(x_t, cond, graphed=False))
        both = Text2ImagePipeline(
            _tiny(encprop=True, deepcache=True, num_steps=8,
                  encprop_dense_steps=1), device="cpu", state_dicts=sd)
        assert both.full_variant.mode == "deepcache"


@pytest.mark.parametrize("sampler_kw,error,match", [
    (dict(encprop=True, eta=0.5), AssertionError, "encprop needs eta=0"),
    (dict(deepcache=True, eta=0.5), AssertionError, "deepcache needs eta=0"),
    (dict(deepcache=True, kind="euler"), AssertionError, "not 'euler'"),
    (dict(consistency=True, num_steps=9), AssertionError, "1-8 steps"),
    (dict(deepcache=True, num_steps=5), AssertionError, "even step count"),
    (dict(encprop=True, deepcache=True, num_steps=5,
          encprop_dense_steps=1), AssertionError, "even step count"),
    (dict(encprop=True, encprop_stride=0), AssertionError, "stride"),
    (dict(encprop=True), AssertionError, "dense prefix"),   # 5 dense of 4
    (dict(consistency=True, deepcache=True), AssertionError,
     "does not compose with deepcache"),
    (dict(consistency=True, encprop=True, encprop_dense_steps=1),
     AssertionError, "does not compose with encprop"),
    (dict(consistency=True, eta=0.5), AssertionError, "deterministic"),
    (dict(consistency=True, consistency_teacher_steps=4), AssertionError,
     "must exceed num_steps"),
    (dict(encprop=True, encprop_dense_steps=1, kind="heun"),
     AssertionError, "encprop composes with"),
    (dict(encprop=True, deepcache=True, encprop_dense_steps=1,
          kind="euler"), AssertionError, "deepcache composes with"),
    (dict(kind="heun"), ValueError, "unknown sampler kind"),
])
def test_refusals(sampler_kw, error, match):
    """The reference's build-time rejections (``deepcache_schedule``,
    ``encprop_plan``, ``consistency_plan``, ``make_sampler``'s kind),
    with its exceptions and messages; the reference raises each too."""
    from cassmantle_tpu.ops.samplers import make_sampler as jax_make_sampler
    from cassmantle_tpu.serving import pipeline as jpipeline

    with pytest.raises(error, match=match):
        port_pipeline.sampler_mode(_tiny(**sampler_kw).sampler)
    ref = dataclasses.replace(jax_test_config().sampler, **sampler_kw)
    with pytest.raises(error, match=match):
        if ref.deepcache:
            jpipeline.deepcache_schedule(ref)
        if ref.encprop:
            jpipeline.encprop_plan(ref)
        if ref.consistency:
            jpipeline.consistency_plan(ref)
        jax_make_sampler(ref.kind, ref.num_steps, ref.eta)


def test_presets_match_reference_fields():
    """The two presets' sampler and VAE settings equal the reference's."""
    from cassmantle_tpu import config as jax_config

    for name in ("encprop_serving_config", "deepcache_serving_config"):
        port, ref = getattr(port_config, name)(), getattr(jax_config,
                                                          name)()
        for part in ("sampler",):
            for f in dataclasses.fields(getattr(port, part)):
                assert getattr(port.sampler, f.name) == \
                    getattr(ref.sampler, f.name), (name, f.name)
        assert port.models.vae.fused_conv == ref.models.vae.fused_conv
        assert port.models.unet.fused_conv == ref.models.unet.fused_conv
        assert port_pipeline.sampler_mode(port.sampler) == name.split(
            "_")[0]


def test_tier_decoder_only_flash_at_stride_5(monkeypatch):
    """chip_smoke's encprop tier (stride 5: four propagated steps a
    segment): the decoder-only forward over four timesteps launches the
    up path's 9 self and 9 cross attentions at batch 8, the table
    ``TIER_UNET_FLASH["decoder_only_b8"]`` names."""
    import chip_smoke

    from cassmantle_tpu_torch.ops import attention

    cfg = dataclasses.replace(
        port_config.UNetConfig(), base_channels=32, context_dim=64,
        time_embed_dim=128, dtype="float32")
    unet = UNet(cfg).eval()
    torch.manual_seed(0)
    for prm in unet.parameters():
        torch.nn.init.normal_(prm, std=0.02)
    calls = []
    real = attention.flash_attention

    def recording(q, k, v, **kw):
        level = {64: "l0", 16: "l1", 4: "l2", 1: "mid"}[q.shape[1]]
        kind = "self" if k.shape[1] == q.shape[1] else "cross"
        calls.append(f"{kind}_{level}_b{q.shape[0]}")
        return real(q, k, v, **kw)

    x = torch.randn(2, 8, 8, 4)
    t = torch.tensor([500], dtype=torch.int32)
    ctx = torch.randn(2, 77, 64)
    with torch.inference_mode():
        _, _, cache = unet(x, t.expand(2), ctx, return_deep=True,
                           return_skips=True)
        monkeypatch.setattr(attention, "flash_attention", recording)
        port_ddim.cfg_denoiser_encprop(unet, ctx, 7.5)[1](
            cache, torch.tensor([400, 300, 200, 100], dtype=torch.int32))
    assert dict(collections.Counter(calls)) == \
        chip_smoke.TIER_UNET_FLASH["decoder_only_b8"]
