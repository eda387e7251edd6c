"""Port parity of SDXL's fused-conv and W8A8 UNets, its W8A8 dispatch
counter, and the reference's benched SDXL rounds (``sdxl_encprop``,
``sdxl_turbo``), at ``test_sdxl_config()`` size on the CPU.

The reference's fused and int8 sites run its lax references (its Pallas
interpret mode raises under the installed jax), as in
``tests/test_torch_port_w8a8.py``, whose site recorder and site check are
reused. Tolerances, each with its reason:
- a fused conv site against the reference's ``gn_silu_conv3x3_reference``
  on the same inputs, and the fused UNet's output against the reference's:
  1e-4 of max |output| (fp32 on both sides, sums in another order);
- a W8A8 site within ``FLIP_REL`` (1e-3) of max |output|: one int8 value
  may flip where an activation lands within an ulp of a rounding
  boundary (that file's docstring);
- the counter deltas are exact;
- the rounds' uint8 images within 2 levels everywhere and 0.5 on the
  mean, as every other round of the port is held.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops import fused_conv as jfc
from cassmantle_tpu.ops import samplers as jsamplers
from cassmantle_tpu.serving import overload as joverload
from cassmantle_tpu.serving import pipeline as jpipeline
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models import layers
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.ops import quant
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
from cassmantle_tpu_torch.utils.logging import metrics

from _torch_port_common import assert_rel, jax_params, load, randn
from test_torch_port_sdxl import PROMPTS, _ref_pipe, sdxl_ref  # noqa: F401
from test_torch_port_w8a8 import (
    check_sites,
    jax_w8a8_tree,
    record_sites,
    reference_lax_path,
)


def fused(ucfg):
    return dataclasses.replace(ucfg, fused_conv=True, conv_pad_to=128)


def w8a8_sdxl(module, **sampler):
    """``test_sdxl_config()`` with the reference's SDXL W8A8 bench flags
    (fused conv, pad 128, unet_w8a8) at w8a8_min_size 0."""
    cfg = module.test_sdxl_config()
    m = cfg.models
    cfg = cfg.replace(models=dataclasses.replace(
        m, unet=fused(m.unet), unet_w8a8=True, w8a8_min_size=0))
    if sampler:
        cfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, **sampler))
    return cfg


@pytest.fixture(scope="module")
def unet_case():
    """The tiny SDXL UNet with the fused-conv flags: reference parameters,
    inputs (CFG batch of 2, micro-conditioned) and its output."""
    ucfg = fused(jax_config.test_sdxl_config().models.unet)
    rng = np.random.default_rng(71)
    x, ctx = randn(rng, 2, 8, 8, 4), randn(rng, 2, 16, ucfg.context_dim)
    t = np.array([981, 21], dtype=np.int32)
    add = randn(rng, 2, ucfg.addition_embed_dim)
    mod = JUNet(ucfg)
    args = tuple(map(jnp.asarray, (x, t, ctx, add)))
    with reference_lax_path():
        params = jax_params(mod, 72, *args)
        ref = np.asarray(mod.apply(params, *args), dtype=np.float64)
    return dict(args=(x, t, ctx, add), params=params, ref=ref)


def _port_unet(unet_case):
    ucfg = fused(port_config.test_sdxl_config().models.unet)
    return load(UNet(ucfg), unet_case["params"], "unet_xl")


def test_sdxl_fused_unet_matches_reference_site_by_site(unet_case,
                                                       monkeypatch):
    """Every fused GroupNorm + SiLU + conv3x3 call of the fused SDXL
    UNet's forward (two a ResBlock) against the reference's lax reference
    of the fused contract on the same inputs; the output against the
    reference's fused UNet."""
    calls = []
    real = layers.gn_silu_conv3x3

    def record(x, a, b, w, bias, pad_to=0):
        out = real(x, a, b, w, bias, pad_to=pad_to)
        calls.append((x, a, b, w, bias, out))
        return out

    monkeypatch.setattr(layers, "gn_silu_conv3x3", record)
    port = _port_unet(unet_case)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, unet_case["args"]))
    resblocks = sum(1 for m in port.modules()
                    if type(m).__name__ == "ResBlock")
    assert len(calls) == 2 * resblocks > 0
    for x, a, b, w, bias, got in calls:
        ref = jfc.gn_silu_conv3x3_reference(
            *(jnp.asarray(t.detach().numpy()) for t in (x, a, b, w, bias)))
        assert_rel(got, np.asarray(ref), 1e-4)
    assert_rel(out, unet_case["ref"], 1e-4)


def test_sdxl_w8a8_unet_matches_reference_site_by_site(unet_case):
    """The W8A8 SDXL UNet: the reference's site set (attention, GEGLU,
    the ResBlocks' conv3x3), each site call within the flip limit of the
    reference's site function with its quantized leaf, per-tensor scales
    over the CFG batch."""
    port = _port_unet(unet_case)
    n = quant.w8a8_modules(port, predicate=lambda path, w: (
        quant.w8a8_default_predicate(path, w, min_size=0)))
    tree = jax_w8a8_tree(unet_case["params"])
    with torch.no_grad(), record_sites(port) as calls:
        port(*map(torch.from_numpy, unet_case["args"]))
    assert len(calls) == n > 0
    check_sites(calls, tree, per_token=False)


def _dispatches():
    return metrics.counter_total("pipeline.w8a8_dispatches")


@pytest.mark.parametrize("path", ["monolithic", "tier", "staged", "bf16"])
def test_w8a8_dispatch_counter_matches_reference(path, monkeypatch):
    """``pipeline.w8a8_dispatches`` after one SDXL image: the delta the
    reference's ``note_w8a8_counter`` adds for the same config and the
    sampler config served (a tier's degraded one), 0 for the bf16 UNet."""
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    monkeypatch.delenv("CASSMANTLE_NO_W8A8", raising=False)
    jcfg, pcfg = w8a8_sdxl(jax_config), w8a8_sdxl(port_config)
    if path == "staged":
        jcfg, pcfg = (c.replace(serving=dataclasses.replace(
            c.serving, staged_serving=True)) for c in (jcfg, pcfg))
    if path == "bf16":
        jcfg, pcfg = (c.replace(models=dataclasses.replace(
            c.models, unet_w8a8=False)) for c in (jcfg, pcfg))
    scfg = jcfg.sampler
    if path == "tier":
        for mod in (joverload, poverload):
            ladder = mod.BrownoutLadder(mod.DEFAULT_TIERS,
                                        registry=type(mod.metrics)())
            with ladder._lock:
                ladder._tier = 1
            monkeypatch.setattr(mod, "_LADDER", ladder)
        scfg = joverload.degraded_sampler_cfg(scfg,
                                              joverload.DEFAULT_TIERS[1])
        assert scfg.num_steps != jcfg.sampler.num_steps
    before = jpipeline.metrics.counter_total("pipeline.w8a8_dispatches")
    jpipeline.note_w8a8_counter(jcfg.models, scfg, 1)
    want = jpipeline.metrics.counter_total(
        "pipeline.w8a8_dispatches") - before
    pipe = SDXLPipeline(pcfg, device="cpu")
    try:
        start = _dispatches()
        img = pipe.generate(PROMPTS[:1], seed=5)
        assert img.shape[0] == 1
    finally:
        pipe.drop_staged()
    assert _dispatches() - start == want
    assert (want > 0) == (path != "bf16")


def _round_cfg(module, which):
    cfg = module.test_sdxl_config()
    if which == "encprop":
        # the reference bench's own encprop geometry at test size
        # (bench.py::_bench_encprop_ab, smoke)
        s = dataclasses.replace(cfg.sampler, num_steps=12, encprop=True,
                                encprop_stride=4, encprop_dense_steps=0)
        m = dataclasses.replace(cfg.models, vae=dataclasses.replace(
            cfg.models.vae, fused_conv=True))
        return cfg.replace(sampler=s, models=m)
    preset = module.turbo_serving_config().sampler
    return cfg.replace(sampler=dataclasses.replace(
        cfg.sampler, kind=preset.kind, num_steps=preset.num_steps,
        deepcache=preset.deepcache))


@pytest.mark.parametrize("which", ["encprop", "turbo"])
def test_sdxl_bench_rounds_match_reference(sdxl_ref, which):
    """The reference's benched SDXL rounds on its x_T: ``sdxl_encprop``
    (encoder propagation with the fused VAE) and ``sdxl_turbo``
    (DPM++(2M) at 24 steps with DeepCache), each through the port's
    SDXLPipeline against the reference's ``run_cfg_denoise`` with the
    micro-conditioning: within 2 levels, mean 0.5."""
    jcfg, pcfg = _round_cfg(jax_config, which), _round_cfg(port_config,
                                                           which)
    m, s = jcfg.models, jcfg.sampler
    ref = dict(sdxl_ref, cfg=jcfg)
    ns, params = _ref_pipe(ref)
    ids, uids = jnp.asarray(ref["ids"]), jnp.asarray(ref["uids"])
    ctx, pooled = JSDXL._encode(ns, params, ids)
    uctx, upooled = JSDXL._encode(ns, params, uids)
    time_ids = JSDXL._time_ids(ns, len(PROMPTS))
    unet, vae = JUNet(m.unet), JVAE(m.vae)
    dc = jpipeline.deepcache_schedule(s) if s.deepcache else None
    sample = jsamplers.make_sampler(s.kind, s.num_steps, s.eta)
    with reference_lax_path():
        final = jpipeline.run_cfg_denoise(
            s, sample, dc, unet.apply, params["unet"], ctx, uctx,
            jnp.asarray(ref["x_t"]),
            addition_embeds=jnp.concatenate([pooled, time_ids], axis=-1),
            uncond_addition_embeds=jnp.concatenate([upooled, time_ids],
                                                   axis=-1))
        want = np.asarray(jax_postprocess(vae.apply(params["vae"], final)))
    pipe = SDXLPipeline(pcfg, device="cpu", state_dicts=_state_dicts(ref))
    assert pipe.full_variant.mode == {"encprop": "encprop",
                                      "turbo": "deepcache"}[which]
    images = pipe.generate(PROMPTS, latents=torch.from_numpy(ref["x_t"]))
    diff = np.abs(images.astype(np.int32) - want.astype(np.int32))
    assert images.shape == want.shape and diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


def _state_dicts(ref):
    from cassmantle_tpu_torch.models.weights import from_jax

    p = ref["params"]
    return {"clip_text": from_jax("clip_text", p["clip"]),
            "clip_text_2": from_jax("clip_text_2", p["clip2"]),
            "unet": from_jax("unet_xl", p["unet"]),
            "vae": from_jax("vae_xl", p["vae"])}


def test_sdxl_build_counts():
    """The cost model's count an image for each SDXL build (on meta
    tensors): the fused conv and the weights-only int8 UNet run the bf16
    build's products (the int8 weights dequantize first), W8A8 the same
    total with its quantized sites in the int8 class; each build's
    signature tells W8A8 from bf16 and equals bf16's otherwise."""
    from cassmantle_tpu_torch.obs import costmodel

    base = port_config.test_sdxl_config()
    m = base.models
    builds = {
        "bf16": base,
        "fused": base.replace(models=dataclasses.replace(m, unet=fused(
            m.unet))),
        "int8": base.replace(models=dataclasses.replace(m, unet_int8=True)),
        "w8a8": w8a8_sdxl(port_config)}
    counts = {k: SDXLPipeline.shape_twin(c).image_products()
              for k, c in builds.items()}
    sigs = {k: costmodel.sdxl_signature(c) for k, c in builds.items()}
    assert counts["fused"] == counts["int8"] == counts["bf16"]
    assert counts["bf16"].int8 == 0 < counts["w8a8"].int8
    assert counts["w8a8"].total == pytest.approx(counts["bf16"].total,
                                                 rel=1e-12)
    assert sigs["fused"] == sigs["int8"] == sigs["bf16"] != sigs["w8a8"]
