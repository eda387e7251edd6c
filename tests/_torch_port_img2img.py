"""Shared pieces of the img2img parity tests
(``test_torch_port_img2img.py``, ``test_torch_port_img2img_reference.py``):
the prompts and seeded images, the (reference, port) configs, the
reference's seeded trees and its ``_img2img_impl`` call."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import VAEEncoder as JEncoder
from cassmantle_tpu.serving import pipeline as jpipeline
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import config as port_config

from _torch_port_common import jax_params

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]


def images(seed, b=2, size=64):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                dtype=np.uint8)


def reference_img2img(cfg, params, images, prompts, strength, seed):
    """The reference's ``Text2ImagePipeline._img2img_impl`` (jitted per k
    in its ``generate_img2img``), called on a stand-in for its pipeline
    with the same modules, on the uint8 -> [-1, 1] input it makes."""
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.asarray(jax_tok(tok, prompts, pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt] * len(prompts), pad,
                               m.clip_text.vocab_size))
    me = types.SimpleNamespace(
        cfg=cfg, clip=JClip(m.clip_text), unet_apply=JUNet(m.unet).apply,
        vae=JVAE(m.vae), vae_enc=JEncoder(m.vae))
    steps = s.num_steps
    k = max(1, min(steps, int(round(strength * steps))))
    imgf = jnp.asarray(np.asarray(images, dtype=np.float32) / 127.5 - 1.0)
    out = jpipeline.Text2ImagePipeline._img2img_impl(
        me, k, {"clip": params["clip_text"], "unet": params["unet"],
                "vae": params["vae"], "vae_enc": params["vae_enc"]},
        ids, uids, imgf, jax.random.PRNGKey(seed))
    return np.asarray(out), k


def reference_trees():
    """Seeded reference trees of CLIP, the UNet, the decoder and the
    encoder at test_config() sizes."""
    cfg = jax_test_config()
    m, s = cfg.models, cfg.sampler
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    lat = jnp.zeros((1, 32, 32, 4))
    return {
        "clip_text": jax_params(JClip(m.clip_text), 103,
                                jnp.zeros((1, pad), jnp.int32)),
        "unet": jax_params(JUNet(m.unet), 104, lat,
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, pad, m.unet.context_dim))),
        "vae": jax_params(JVAE(m.vae), 105, lat),
        "vae_enc": jax_params(JEncoder(m.vae), 106,
                              jnp.zeros((1, 64, 64, 3)),
                              jax.random.PRNGKey(0)),
    }


def configs(**sampler_kw):
    out = []
    for mod in (jax_test_config, port_config.test_config):
        cfg = mod()
        out.append(cfg.replace(sampler=dataclasses.replace(
            cfg.sampler, **sampler_kw)))
    return out
