"""The port's slice as a whole against the reference, on the CPU at
``test_config()`` sizes: CFG DDIM, CLIP -> DDIM -> VAE -> uint8, greedy
GPT-2 decode, guess scoring and the blur. Reference parameter trees and
inputs are made with numpy from a seed and fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.minilm import MiniLMEncoder as JMiniLM
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops import blur as jax_blur
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.ops.decode import greedy_decode as jax_greedy
from cassmantle_tpu.ops.decode import make_apply_pair
from cassmantle_tpu.ops.scorer import EmbeddingScorer as JScorer
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import blur as port_blur
from cassmantle_tpu_torch.ops.ddim import DDIMSchedule, ddim_sample
from cassmantle_tpu_torch.ops.ddim import make_cfg_denoiser
from cassmantle_tpu_torch.ops.decode import greedy_decode
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

from _torch_port_common import assert_rel, jax_params, load, randn

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]


@pytest.fixture(scope="module")
def slice_ref():
    """The reference slice on the tiny geometry: parameters, x_T, the CLIP
    states, the final DDIM latents and the uint8 images."""
    cfg = jax_test_config()
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.asarray(jax_tok(tok, PROMPTS, pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt] * len(PROMPTS), pad,
                               m.clip_text.vocab_size))
    vae_scale = 2 ** (len(m.vae.channel_mults) - 1)
    hw = s.image_size // vae_scale
    x_t = randn(np.random.default_rng(11), len(PROMPTS), hw, hw, 4)
    clip, unet, vae = JClip(m.clip_text), JUNet(m.unet), JVAE(m.vae)
    params = {
        "clip_text": jax_params(clip, 12, ids),
        "unet": jax_params(unet, 13, jnp.asarray(x_t),
                           jnp.zeros((len(PROMPTS),), jnp.int32),
                           jnp.zeros((len(PROMPTS), pad, m.unet.context_dim))),
        "vae": jax_params(vae, 14, jnp.asarray(x_t)),
    }
    ctx = clip.apply(params["clip_text"], ids)["hidden"]
    uctx = clip.apply(params["clip_text"], uids)["hidden"]
    denoise = jax_cfg_denoiser(unet.apply, params["unet"], ctx, uctx,
                               s.guidance_scale)
    final = jax_ddim_sample(denoise, jnp.asarray(x_t),
                            JSchedule.create(s.num_steps))
    images = jax_postprocess(vae.apply(params["vae"], final))
    return {"params": params, "x_t": x_t, "ctx": np.array(ctx),
            "uctx": np.array(uctx), "final": np.array(final),
            "images": np.array(images)}


def test_cfg_ddim_matches_reference(slice_ref):
    """(c) Same x_T and CLIP states: the port's CFG DDIM loop lands on the
    reference's final latents (fp32; rel 1e-4 of the largest latent)."""
    cfg = port_test_config()
    unet = load(UNet(cfg.models.unet), slice_ref["params"]["unet"], "unet")
    denoise = make_cfg_denoiser(unet, torch.from_numpy(slice_ref["ctx"]),
                                torch.from_numpy(slice_ref["uctx"]),
                                cfg.sampler.guidance_scale)
    sched = DDIMSchedule.create(cfg.sampler.num_steps)
    np.testing.assert_array_equal(sched.timesteps,
                                  JSchedule.create(4).timesteps)
    with torch.inference_mode():
        final = ddim_sample(denoise, torch.from_numpy(slice_ref["x_t"]),
                            sched)
    assert_rel(final, slice_ref["final"], 1e-4)


def test_slice_images_match_reference(slice_ref):
    """(d) CLIP -> CFG DDIM -> VAE -> uint8 through the port's pipeline on
    the reference's x_T: within 2 levels everywhere, mean |diff| <= 0.5."""
    cfg = port_test_config()
    sd = {k: from_jax(k, v) for k, v in slice_ref["params"].items()}
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
    images = pipe.generate(PROMPTS, latents=torch.from_numpy(slice_ref["x_t"]))
    ref = slice_ref["images"]
    assert images.dtype == np.uint8 and images.shape == ref.shape
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()
    assert pipe.last_decoded_finite
    assert set(pipe.last_stage_seconds) == {"clip", "denoise", "vae"}


@pytest.mark.parametrize("eos_mode", ["unreachable", "early_stop"])
def test_greedy_decode_matches_reference(eos_mode):
    """(e) Greedy GPT-2 token ids equal the reference's greedy_decode, with
    an EOS the model never emits and with one it does (early stop)."""
    jm = jax_test_config().models.gpt2
    rng = np.random.default_rng(15)
    ids = rng.integers(0, jm.vocab_size, (2, 32)).astype(np.int32)
    lens = np.array([32, 19], dtype=np.int32)
    model = JGPT2(jm)
    params = jax_params(model, 16, jnp.asarray(ids))
    fns = make_apply_pair(model)

    def ref(eos):
        toks, n = jax_greedy(fns, params, jnp.asarray(ids), jnp.asarray(lens),
                             jax.random.PRNGKey(0), 8, eos, 0.0, 40)
        return np.asarray(toks), np.asarray(n)

    eos = jm.vocab_size
    ref_toks, ref_len = ref(eos)
    if eos_mode == "early_stop":
        eos = int(ref_toks[0, 3])
        ref_toks, ref_len = ref(eos)
        assert ref_len[0] <= 3
    port = load(GPT2LM(port_test_config().models.gpt2), params, "gpt2")
    with torch.inference_mode():
        toks, n = greedy_decode(port, torch.from_numpy(ids).long(),
                                torch.from_numpy(lens).long(), 8, eos)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(n.numpy(), ref_len)


def test_scorer_matches_reference():
    """(f) Guess similarities through the port's scorer (tokenize, pad into
    a bucket, encode, pool, cosine) within 1e-5 of the reference's."""
    jm = jax_test_config().models.minilm
    ref = JScorer(jm, batch_buckets=(8, 64), table=None)
    ids = jnp.zeros((1, ref.seq_len), jnp.int32)
    ref.params = jax_params(JMiniLM(jm), 17, ids, ids)
    pairs = [("lighthouse", "lighthouse"), ("crimson", "amber"),
             ("comet", "archive"), ("a quiet harbor", "harbor"),
             ("", "glacier"), ("orchard", "an orchard at dusk, glowing"),
             ("Caravan", "caravan"), ("teal", "silver"), ("x", "y")]
    port = EmbeddingScorer(port_test_config().models.minilm, "cpu",
                           batch_buckets=(8, 64),
                           state_dict=from_jax("minilm", ref.params))
    sims = port.similarity(pairs)
    np.testing.assert_allclose(sims, ref.similarity(pairs), atol=1e-5, rtol=0)
    assert np.all(np.abs(sims) <= 1 + 1e-6)


@pytest.mark.parametrize("radius", [0.0, 5.0, 15.0])
def test_blur_matches_reference(radius):
    """(g) The reveal blur within 1 level of the reference's device_blur."""
    img = np.random.default_rng(18).integers(0, 256, (64, 48, 3),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(port_blur.gaussian_taps(radius),
                                  jax_blur.gaussian_taps(radius))
    out = port_blur.device_blur(img, radius, device="cpu")
    ref = jax_blur.device_blur(img, radius)
    assert out.dtype == np.uint8 and out.shape == img.shape
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1
