"""Whole tiny encoder-propagation and DeepCache rounds of the port
against the reference, on the CPU at ``test_config()`` sizes: a round
through ``TorchContentBackend`` (text given, one style) on the
reference's x_T, its uint8 image within 2 levels (mean 0.5) of the
reference pipeline's, with the preset's loop and forward counts.
Reference trees come from numpy seeds (``_torch_port_common``), fp32.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops import ddim as jddim
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import TorchContentBackend
from cassmantle_tpu_torch.utils.text import sanitize_text

from _torch_port_common import jax_params, randn

# -- whole tiny rounds --------------------------------------------------------

ROUND_TEXT = ("The harbor lights were low tonight. The ships came in "
              "slowly.")
STYLE = "Watercolor"


def _round_cfgs(kind):
    """(reference, port) tiny configs of a preset: DeepCache at 4 steps,
    encprop (with the fused VAE) at 6 steps, stride 3, no dense key."""
    out = []
    for mod in (jax_test_config, port_config.test_config):
        cfg = mod()
        s = cfg.sampler
        if kind == "deepcache":
            cfg = cfg.replace(sampler=dataclasses.replace(s, deepcache=True))
        else:
            cfg = cfg.replace(sampler=dataclasses.replace(
                s, encprop=True, num_steps=6, encprop_dense_steps=0))
        out.append(cfg)
    ref, port = out
    if kind == "encprop":
        port = port.replace(models=dataclasses.replace(
            port.models, vae=dataclasses.replace(port.models.vae,
                                                 fused_conv=True)))
    return ref, port


def _reference_image(cfg, prompt, x_t, kind):
    """The reference's CLIP -> encprop/DeepCache CFG DDIM -> VAE -> uint8
    for one prompt, and its parameter trees."""
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.asarray(jax_tok(tok, [prompt], pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt], pad,
                               m.clip_text.vocab_size))
    clip, unet, vae = JClip(m.clip_text), JUNet(m.unet), JVAE(m.vae)
    params = {
        "clip_text": jax_params(clip, 78, ids),
        "unet": jax_params(unet, 79, jnp.asarray(x_t),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, pad, m.unet.context_dim))),
        "vae": jax_params(vae, 80, jnp.asarray(x_t)),
    }
    ctx = clip.apply(params["clip_text"], ids)["hidden"]
    uctx = clip.apply(params["clip_text"], uids)["hidden"]
    sched = jddim.DDIMSchedule.create(s.num_steps)
    if kind == "deepcache":
        full, shallow = jddim.make_cfg_denoiser_pair(
            unet.apply, params["unet"], ctx, uctx, s.guidance_scale)
        final = jddim.ddim_sample_deepcache(full, shallow, jnp.asarray(x_t),
                                            sched)
    else:
        key, prop, shallow = jddim.make_cfg_denoiser_encprop(
            unet.apply, params["unet"], ctx, uctx, s.guidance_scale)
        final = jddim.ddim_sample_encprop(
            key, prop, jnp.asarray(x_t), sched, s.encprop_stride,
            s.encprop_dense_steps, denoise_shallow=shallow)
    images = np.array(jax_postprocess(vae.apply(params["vae"], final)))
    return images[0], params


@pytest.mark.parametrize("kind", ["encprop", "deepcache"])
def test_tiny_round_matches_reference(kind, monkeypatch):
    """A whole round through ``TorchContentBackend.generate_sync`` (text
    given, one style) on the reference's x_T: the round's uint8 image
    within 2 levels of the reference pipeline's (mean 0.5), with the
    preset's loop and its forward counts."""
    ref_cfg, cfg = _round_cfgs(kind)
    hw = cfg.sampler.image_size // 2 ** (len(cfg.models.vae.channel_mults)
                                         - 1)
    x_t = randn(np.random.default_rng(81), 1, hw, hw, 4)
    prompt = (f"A {STYLE.lower()} style piece depicting: "
              f"{sanitize_text(ROUND_TEXT)}")
    ref_img, params = _reference_image(ref_cfg, prompt, x_t, kind)
    monkeypatch.setattr(port_pipeline, "initial_latents",
                        lambda *a, **kw: torch.from_numpy(x_t))
    backend = TorchContentBackend(
        cfg, device="cpu", styles=[STYLE], rng=random.Random(0),
        state_dicts={k: from_jax(k, v) for k, v in params.items()})
    t2i = backend.t2i
    assert t2i.full_variant.mode == kind
    rc = backend.generate_sync("seed", text=ROUND_TEXT)
    diff = np.abs(rc.image.astype(np.int32) - ref_img.astype(np.int32))
    assert rc.image.shape == ref_img.shape and diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()
    assert t2i.vae.up_0_res_0.fused_conv == (kind == "encprop")
    assert t2i.full_variant.encprop_counts == (
        (2, 0, 4) if kind == "encprop" else None)
