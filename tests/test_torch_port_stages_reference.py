"""The port's staged image server against the reference's, on the CPU at
``test_config()`` / ``test_sdxl_config()`` sizes, and the staged path
under the composed presets.

- SD1.5 and SDXL: the reference's ``StagedImageServer`` (its own encode
  and decode stage methods, over Flax modules whose parameters are
  carried across with ``from_jax``) and the port's staged pipeline fed
  the reference's x_T (its ``initial_latents`` at ``PRNGKey(seed)``): a
  one-prompt and a two-prompt request within 2 uint8 levels everywhere
  and 0.5 on average, the port tests' image tolerance. SDXL's staged
  image is bit-equal to the port's monolithic one for the same seed.
- Fused conv and W8A8 (``fusedconv_serving_config`` /
  ``w8a8_serving_config`` geometry at test size, staging on): a solo
  request bit-equal to the monolithic path; two requests a few steps
  apart (widths 1 and 2) both complete with finite images. Under W8A8 a
  slot's activations share one dynamic scale with its neighbours', so
  only the solo bar holds there.
"""

import dataclasses
import time
import types
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jconfig
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.ops.ddim import initial_latents as jax_initial_latents
from cassmantle_tpu.serving.pipeline import Text2ImagePipeline as JText2Image
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu.serving.stages import StagedImageServer as JStaged
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

from _torch_port_common import jax_params

KILL = "CASSMANTLE_NO_STAGED_SERVING"
PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]


def staged(base, slots=2):
    return base.replace(serving=dataclasses.replace(
        base.serving, staged_serving=True, denoise_slots=slots))


def assert_close_images(images, ref):
    assert images.dtype == np.uint8 and images.shape == ref.shape
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


def reference_x_t(seed, n, cfg):
    vae_scale = 2 ** (len(cfg.models.vae.channel_mults) - 1)
    return np.array(jax_initial_latents(jax.random.PRNGKey(seed), n,
                                        cfg.sampler.image_size, vae_scale))


def _tokenize(cfg):
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min([s.prompt_pad_len] + [t.max_positions for t in (
        m.clip_text, m.clip_text_2) if t is not None])
    return partial(jax_tok, tok, pad_len=pad,
                   vocab_size=m.clip_text.vocab_size), pad


def _both_servers(jcfg, ns, params, stage_cls, pipe):
    """The reference's staged server over ``params``, beside the port's
    staged ``pipe``."""
    tokenize, _ = _tokenize(jcfg)
    m = jcfg.models
    ref = JStaged(jcfg, params,
                  encode_fn=partial(stage_cls._encode_stage, ns),
                  decode_fn=partial(stage_cls._decode_stage, ns),
                  unet_apply=JUNet(m.unet).apply,
                  tokenize=lambda p: tokenize(p),
                  vae_scale=2 ** (len(m.vae.channel_mults) - 1))
    return ref, pipe


def _run_against_reference(ref, pipe, jcfg, prompts, seed):
    try:
        want = ref.generate(prompts, seed)
        x_t = torch.from_numpy(reference_x_t(seed, len(prompts), jcfg))
        got = pipe.generate(prompts, latents=x_t)
    finally:
        ref.stop()
    assert_close_images(got, want)
    return got


@pytest.fixture(scope="module")
def sd15():
    jcfg = staged(jconfig.test_config())
    m = jcfg.models
    _, pad = _tokenize(jcfg)
    ids = jnp.zeros((2, pad), jnp.int32)
    x = jnp.zeros((2, 32, 32, 4))
    params = {
        "clip": jax_params(JClip(m.clip_text), 91, ids),
        "unet": jax_params(JUNet(m.unet), 92, x, jnp.zeros((2,), jnp.int32),
                           jnp.zeros((2, pad, m.unet.context_dim))),
        "vae": jax_params(JVAE(m.vae), 93, x),
    }
    sd = {"clip_text": from_jax("clip_text", params["clip"]),
          "unet": from_jax("unet", params["unet"]),
          "vae": from_jax("vae", params["vae"])}
    ns = types.SimpleNamespace(clip=JClip(m.clip_text), vae=JVAE(m.vae))
    pipe = Text2ImagePipeline(staged(pconfig.test_config()), device="cpu",
                              state_dicts=sd)
    yield {"jcfg": jcfg, "params": params, "ns": ns, "pipe": pipe}
    pipe.drop_staged()


@pytest.mark.parametrize("n", [1, 2])
def test_sd15_staged_matches_reference_staged_server(sd15, n):
    ref, pipe = _both_servers(sd15["jcfg"], sd15["ns"], sd15["params"],
                              JText2Image, sd15["pipe"])
    _run_against_reference(ref, pipe, sd15["jcfg"], PROMPTS[:n], 40 + n)
    assert pipe._staged.stats["retirements"] >= n


@pytest.fixture(scope="module")
def sdxl():
    jcfg = staged(jconfig.test_sdxl_config())
    m = jcfg.models
    _, pad = _tokenize(jcfg)
    ids = jnp.zeros((2, pad), jnp.int32)
    x = jnp.zeros((2, 32, 32, 4))
    params = {
        "clip": jax_params(JClip(m.clip_text), 94, ids),
        "clip2": jax_params(JClip(m.clip_text_2), 95, ids),
        "unet": jax_params(JUNet(m.unet), 96, x, jnp.zeros((2,), jnp.int32),
                           jnp.zeros((2, pad, m.unet.context_dim)),
                           jnp.zeros((2, m.unet.addition_embed_dim))),
        "vae": jax_params(JVAE(m.vae), 97, x),
        "clip2_proj": None,
    }
    ns = types.SimpleNamespace(
        cfg=jcfg, clip=JClip(m.clip_text), clip2=JClip(m.clip_text_2),
        clip2_proj=None, vae=JVAE(m.vae),
        time_id_dim=(m.unet.addition_embed_dim
                     - m.clip_text_2.hidden_size) // 6)
    ns._encode = partial(JSDXL._encode, ns)
    ns._time_ids = partial(JSDXL._time_ids, ns)
    sd = {"clip_text": from_jax("clip_text", params["clip"]),
          "clip_text_2": from_jax("clip_text_2", params["clip2"]),
          "unet": from_jax("unet_xl", params["unet"]),
          "vae": from_jax("vae_xl", params["vae"])}
    pipe = SDXLPipeline(staged(pconfig.test_sdxl_config()), device="cpu",
                        state_dicts=sd)
    yield {"jcfg": jcfg, "params": params, "ns": ns, "pipe": pipe}
    pipe.drop_staged()


@pytest.mark.parametrize("n", [1, 2])
def test_sdxl_staged_matches_reference_staged_server(sdxl, n):
    """Dual-tower conditioning and micro-conditioning ride the slots as
    ctx/uctx/add/uadd rows."""
    ref, pipe = _both_servers(sdxl["jcfg"], sdxl["ns"], sdxl["params"],
                              JSDXL, sdxl["pipe"])
    _run_against_reference(ref, pipe, sdxl["jcfg"], PROMPTS[:n], 50 + n)
    assert set(pipe._staged._cond) == {"ctx", "uctx", "add", "uadd"}


@pytest.mark.parametrize("n", [1, 2])
def test_sdxl_staged_bit_equal_to_monolithic(sdxl, n, monkeypatch):
    pipe = sdxl["pipe"]
    monkeypatch.setenv(KILL, "1")
    want = pipe.generate(PROMPTS[:n], seed=60 + n)
    monkeypatch.delenv(KILL)
    before = pipe._staged_server().stats["retirements"]
    got = pipe.generate(PROMPTS[:n], seed=60 + n)
    assert np.array_equal(got, want)
    assert pipe._staged.stats["retirements"] == before + n


def _composed(preset):
    base = pconfig.test_config()
    unet = dataclasses.replace(base.models.unet, fused_conv=True,
                               conv_pad_to=128)
    models = dataclasses.replace(base.models, unet=unet)
    if preset == "w8a8":
        models = dataclasses.replace(models, unet_w8a8=True, lm_w8a8=True)
    return staged(base.replace(models=models))


@pytest.mark.parametrize("preset", ["fusedconv", "w8a8"])
def test_composed_presets_solo_parity_and_mixed_run(preset, monkeypatch):
    """The fused-conv and W8A8 UNets compose with staging: a solo request
    is bit-equal to the monolithic path; two requests admitted a step
    apart both finish (finite, not constant)."""
    pipe = Text2ImagePipeline(_composed(preset), device="cpu")
    try:
        monkeypatch.setenv(KILL, "1")
        want = pipe.generate(PROMPTS[:1], seed=70)
        monkeypatch.delenv(KILL)
        assert np.array_equal(pipe.generate(PROMPTS[:1], seed=70), want)
        srv = pipe._staged
        base = dict(srv.stats)

        def hook(s):
            if (s.stats["admissions"] - base["admissions"] == 1
                    and s.stats["steps"] - base["steps"] >= 1):
                deadline = time.monotonic() + 30.0
                while (s._admit_q.empty() and not s._pend
                       and time.monotonic() < deadline
                       and not s._stop_evt.is_set()):
                    time.sleep(0.002)

        srv._on_step = hook
        with ThreadPoolExecutor(max_workers=2) as ex:
            fa = ex.submit(pipe.generate, PROMPTS[:1], 71)
            deadline = time.monotonic() + 30.0
            while (srv.stats["admissions"] == base["admissions"]
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            fb = ex.submit(pipe.generate, PROMPTS[1:], 72)
            outs = [fa.result(timeout=120), fb.result(timeout=120)]
        srv._on_step = None
        assert srv.width_steps[2] >= 1
        for out in outs:
            assert out.dtype == np.uint8 and int(out.max()) > int(out.min())
    finally:
        pipe.drop_staged()
