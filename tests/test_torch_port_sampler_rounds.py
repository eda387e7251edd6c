"""Whole tiny rounds of the port's other samplers against the reference,
on the CPU. Under ``fast_serving_config``, ``turbo_serving_config`` and
``lcm_serving_config`` (their sampler fields on ``test_config()``'s
geometry) a round runs through ``TorchContentBackend`` on the reference's
x_T and lands within 2 uint8 levels (mean 0.5) of the reference's
``run_cfg_denoise`` round; the tiny SDXL UNet's CFG loop under each
sampler within 1e-4 of the reference's, graphed equal to eager.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops import samplers as jsamplers
from cassmantle_tpu.serving import pipeline as jpipeline
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import ddim as port_ddim
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import TorchContentBackend
from cassmantle_tpu_torch.utils.text import sanitize_text

from _torch_port_common import EagerStep, assert_rel, jax_params, randn

# -- whole tiny rounds ---------------------------------------------------------

ROUND_TEXT = ("The harbor lights were low tonight. The ships came in "
              "slowly.")
STYLE = "Watercolor"
ROUNDS = {"fast": "fast_serving_config", "turbo": "turbo_serving_config",
          "turbo_odd": "turbo_serving_config", "lcm": "lcm_serving_config"}


def _round_cfgs(which):
    """(reference, port) test geometry with the preset's sampler fields
    (``turbo_odd``: the turbo preset at 5 steps, an unpaired tail)."""
    out = []
    for mod in (jax_config, port_config):
        preset = getattr(mod, ROUNDS[which])().sampler
        cfg = mod.test_config()
        kw = dict(kind=preset.kind, num_steps=preset.num_steps,
                  deepcache=preset.deepcache,
                  consistency=preset.consistency)
        if which == "turbo_odd":
            kw["num_steps"] = 5
        out.append(cfg.replace(sampler=dataclasses.replace(cfg.sampler,
                                                           **kw)))
    return out


def _reference_image(cfg, prompt, x_t):
    """The reference's CLIP -> ``run_cfg_denoise`` -> VAE -> uint8 for one
    prompt (the sampler its pipeline builds), and its parameter trees."""
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.asarray(jax_tok(tok, [prompt], pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt], pad,
                               m.clip_text.vocab_size))
    clip, unet, vae = JClip(m.clip_text), JUNet(m.unet), JVAE(m.vae)
    params = {
        "clip_text": jax_params(clip, 92, ids),
        "unet": jax_params(unet, 93, jnp.asarray(x_t),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, pad, m.unet.context_dim))),
        "vae": jax_params(vae, 94, jnp.asarray(x_t)),
    }
    ctx = clip.apply(params["clip_text"], ids)["hidden"]
    uctx = clip.apply(params["clip_text"], uids)["hidden"]
    if s.consistency:
        jpipeline.consistency_plan(s)
    dc = jpipeline.deepcache_schedule(s) if s.deepcache else None
    sample = (None if jpipeline.effective_sampler_cfg(s).consistency
              else jsamplers.make_sampler(
                  s.kind, jpipeline.effective_sampler_steps(s), s.eta))
    final = jpipeline.run_cfg_denoise(s, sample, dc, unet.apply,
                                      params["unet"], ctx, uctx,
                                      jnp.asarray(x_t))
    images = np.array(jax_postprocess(vae.apply(params["vae"], final)))
    return images[0], params


@pytest.mark.parametrize("which", list(ROUNDS))
def test_tiny_round_matches_reference(which, monkeypatch):
    """A whole round through ``TorchContentBackend.generate_sync`` (text
    given, one style) on the reference's x_T: the uint8 image within 2
    levels of the reference's (mean 0.5), served by the preset's loop."""
    ref_cfg, cfg = _round_cfgs(which)
    hw = cfg.sampler.image_size // 2 ** (len(cfg.models.vae.channel_mults)
                                         - 1)
    x_t = randn(np.random.default_rng(95), 1, hw, hw, 4)
    prompt = (f"A {STYLE.lower()} style piece depicting: "
              f"{sanitize_text(ROUND_TEXT)}")
    ref_img, params = _reference_image(ref_cfg, prompt, x_t)
    monkeypatch.setattr(port_pipeline, "initial_latents",
                        lambda *a, **kw: torch.from_numpy(x_t))
    backend = TorchContentBackend(
        cfg, device="cpu", styles=[STYLE], rng=random.Random(0),
        state_dicts={k: from_jax(k, v) for k, v in params.items()})
    assert backend.t2i.full_variant.mode == port_pipeline.sampler_mode(
        cfg.sampler)
    rc = backend.generate_sync("seed", text=ROUND_TEXT)
    diff = np.abs(rc.image.astype(np.int32) - ref_img.astype(np.int32))
    assert rc.image.shape == ref_img.shape and diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


@pytest.mark.parametrize("which", ["fast", "turbo_odd", "lcm"])
def test_sdxl_denoise_stage_matches_reference(which):
    """The SDXL pipeline takes the same dispatch (the reference's SDXL
    pipeline calls ``run_cfg_denoise`` too): the tiny SDXL UNet's CFG
    loop under each new sampler (DPM++ at 5 steps, alone and in
    DeepCache pairs; 4 consistency steps), the micro-conditioning riding
    the 2B batch, within 1e-4 of the reference's; graphed equal to
    eager."""
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

    out = []
    for mod in (jax_config, port_config):
        preset = getattr(mod, ROUNDS[which])().sampler
        cfg = mod.test_sdxl_config()
        out.append(cfg.replace(sampler=dataclasses.replace(
            cfg.sampler, kind=preset.kind,
            num_steps=min(5, preset.num_steps),
            deepcache=preset.deepcache, consistency=preset.consistency)))
    ref_cfg, cfg = out
    m, s = ref_cfg.models, ref_cfg.sampler
    rng = np.random.default_rng(96)
    x_t = randn(rng, 1, 8, 8, 4)
    cond = {"context": randn(rng, 1, 16, m.unet.context_dim),
            "uncond_context": randn(rng, 1, 16, m.unet.context_dim),
            "addition_embeds": randn(rng, 1, m.unet.addition_embed_dim),
            "uncond_addition_embeds": randn(rng, 1,
                                            m.unet.addition_embed_dim)}
    unet = JUNet(m.unet)
    params = jax_params(unet, 97, jnp.asarray(x_t), jnp.zeros((1,),
                                                             jnp.int32),
                        jnp.zeros((1, 16, m.unet.context_dim)),
                        jnp.zeros((1, m.unet.addition_embed_dim)))
    dc = jpipeline.deepcache_schedule(s) if s.deepcache else None
    sample = (None if s.consistency
              else jsamplers.make_sampler(s.kind, s.num_steps, s.eta))
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    ref = jpipeline.run_cfg_denoise(
        s, sample, dc, unet.apply, params, jc["context"],
        jc["uncond_context"], jnp.asarray(x_t),
        addition_embeds=jc["addition_embeds"],
        uncond_addition_embeds=jc["uncond_addition_embeds"])
    pipe = SDXLPipeline(cfg, device="cpu",
                        state_dicts={"unet": from_jax("unet_xl", params)})
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        eager = pipe.denoise(torch.from_numpy(x_t), tcond, graphed=False)
        mp.setattr(port_ddim, "CapturedStep", EagerStep)
        graphed = pipe.denoise(torch.from_numpy(x_t), tcond, graphed=True)
    assert_rel(eager, ref, 1e-4)
    assert torch.equal(graphed, eager)
