"""The port's SDXL slice against the reference, on the CPU at
``test_sdxl_config()`` sizes: both text towers (penultimate, pooled), the
micro-conditioned UNet (heads fixed and heads = channels // 64), the
size/crop time ids, the dual-tower encode with and without bigG's
projection, the CFG denoiser with additions, the whole slice's uint8
image on the same x_T, and the backend's choice of pipeline.

Reference parameter trees and inputs are made with numpy from a seed and
fed to both sides (``_torch_port_common``). Tolerances: fp32 models and
steps within 1e-4 of the reference's largest value; uint8 images within
2 levels (mean 0.5), as the SD1.5 slice.
"""

import asyncio
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import sdxl_config as jax_sdxl_config
from cassmantle_tpu.config import test_sdxl_config as jax_test_sdxl_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch.config import sdxl_config as port_sdxl_config
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.config import (
    test_sdxl_config as port_test_sdxl_config,
)
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import KINDS, from_jax
from cassmantle_tpu_torch.ops import quant
from cassmantle_tpu_torch.ops.ddim import make_cfg_denoiser
from cassmantle_tpu_torch.serving.pipeline import (
    INIT_SEEDS,
    Text2ImagePipeline,
    TorchContentBackend,
)
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
from cassmantle_tpu_torch.serving.service import InferenceService

from _torch_port_common import assert_rel, jax_params, load, randn

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]


def _towers():
    """(reference, port) configs of tower 1 and tower 2 of the tiny SDXL
    config, and of tower 2 with bigG's exact GELU (the tiny config
    inherits quick_gelu)."""
    jm, pm = jax_test_sdxl_config().models, port_test_sdxl_config().models
    return {
        "clip_text": (jm.clip_text, pm.clip_text),
        "clip_text_2": (jm.clip_text_2, pm.clip_text_2),
        "clip_text_2_gelu": tuple(dataclasses.replace(c, hidden_act="gelu")
                                  for c in (jm.clip_text_2, pm.clip_text_2)),
    }


def _ids(n=2, seq=16, vocab=1024, seed=30):
    ids = np.random.default_rng(seed).integers(0, vocab - 1, (n, seq))
    ids[:, -3] = vocab - 1                     # EOT, the highest id
    return ids.astype(np.int32)


@pytest.mark.parametrize("tower", ["clip_text", "clip_text_2",
                                   "clip_text_2_gelu"])
def test_clip_towers_penultimate_and_pooled(tower):
    """Each tower's hidden, pooled and penultimate states (the state after
    block num_layers - 2, no final LayerNorm) within 1e-4; the
    penultimate is not the hidden state, so taking one for the other
    would fail."""
    jcfg, pcfg = _towers()[tower]
    ids = _ids(vocab=jcfg.vocab_size)
    ref_mod = JClip(jcfg)
    params = jax_params(ref_mod, 31, jnp.asarray(ids))
    ref = ref_mod.apply(params, jnp.asarray(ids))
    port = load(ClipTextEncoder(pcfg), params, tower.replace("_gelu", ""))
    with torch.inference_mode():
        out = port(torch.from_numpy(ids).long())
    for key in ("hidden", "pooled", "penultimate"):
        assert_rel(out[key], np.asarray(ref[key]), 1e-4)
    gap = np.abs(np.asarray(ref["penultimate"])
                 - np.asarray(ref["hidden"])).max()
    assert gap > 1e-2 * np.abs(np.asarray(ref["hidden"])).max()


def _unet_case(num_heads, seed=32):
    m = jax_test_sdxl_config().models
    ucfg = dataclasses.replace(m.unet, num_heads=num_heads)
    rng = np.random.default_rng(seed)
    x = randn(rng, 2, 8, 8, 4)
    t = np.array([981, 21], dtype=np.int32)
    ctx = randn(rng, 2, 16, ucfg.context_dim)
    add = randn(rng, 2, ucfg.addition_embed_dim)
    ref_mod = JUNet(ucfg)
    params = jax_params(ref_mod, seed + 1, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(ctx), jnp.asarray(add))
    pcfg = dataclasses.replace(port_test_sdxl_config().models.unet,
                               num_heads=num_heads)
    port = load(UNet(pcfg), params, "unet_xl")
    return ref_mod, params, port, (x, t, ctx, add)


@pytest.mark.parametrize("num_heads,with_add", [(4, True), (None, True),
                                                (4, False)])
def test_unet_micro_conditioning(num_heads, with_add):
    """The UNet with add_fc1 -> SiLU -> add_fc2 into the time embedding,
    at 4 heads and at heads = channels // 64 (64 channels: one head at
    D = 64), and without additions (they are skipped, as in the
    reference); fp32, within 1e-4."""
    ref_mod, params, port, (x, t, ctx, add) = _unet_case(num_heads)
    if num_heads is None:
        blk = port.mid_attn.block_0.self_attn
        assert (blk.num_heads, blk.head_dim) == (1, 64)
    args = [jnp.asarray(a) for a in (x, t, ctx)]
    targs = [torch.from_numpy(a) for a in (x, t, ctx)]
    if with_add:
        args.append(jnp.asarray(add))
        targs.append(torch.from_numpy(add))
    ref = np.asarray(ref_mod.apply(params, *args))
    with torch.inference_mode():
        out = port(*targs)
    assert_rel(out, ref, 1e-4)
    if with_add:                      # the additions move the output
        with torch.inference_mode():
            plain = port(*targs[:3])
        assert np.abs(plain.numpy() - out.numpy()).max() \
            > 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("image_size", [64, 1024])
def test_time_ids_match_reference(image_size):
    """The sinusoidal size/crop embedding of [s, s, 0, 0, s, s], at the
    tiny config's 64 (time_id_dim 32) and SDXL's 1024 (time_id_dim 256).
    fp32 cos/sin of arguments up to 1024: the two frameworks' exp of the
    frequencies may differ by an ulp, which moves an argument of 1024 by
    about 6e-5, so the limit is 2e-4 absolute, not bit equality."""
    if image_size == 1024:
        jcfg, pcfg = jax_sdxl_config(), port_sdxl_config()
    else:
        jcfg, pcfg = jax_test_sdxl_config(), port_test_sdxl_config()
    jm = jcfg.models
    tid = (jm.unet.addition_embed_dim - jm.clip_text_2.hidden_size) // 6
    assert tid == (256 if image_size == 1024 else 32)
    ref = np.asarray(JSDXL._time_ids(
        types.SimpleNamespace(cfg=jcfg, time_id_dim=tid), 3))
    port = SDXLPipeline._time_ids(types.SimpleNamespace(
        cfg=pcfg, time_id_dim=tid, device=torch.device("cpu")), 3)
    assert port.shape == ref.shape == (3, 6 * tid)
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), ref, atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def sdxl_ref():
    """Reference parameters of the tiny SDXL slice, its token ids and x_T."""
    cfg = jax_test_sdxl_config()
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions,
              m.clip_text_2.max_positions)
    ids = jax_tok(tok, PROMPTS, pad, m.clip_text.vocab_size)
    uids = jax_tok(tok, [s.negative_prompt] * len(PROMPTS), pad,
                   m.clip_text.vocab_size)
    vae_scale = 2 ** (len(m.vae.channel_mults) - 1)
    hw = s.image_size // vae_scale
    x_t = randn(np.random.default_rng(41), len(PROMPTS), hw, hw, 4)
    b = len(PROMPTS)
    params = {
        "clip": jax_params(JClip(m.clip_text), 42, jnp.asarray(ids)),
        "clip2": jax_params(JClip(m.clip_text_2), 43, jnp.asarray(ids)),
        "unet": jax_params(
            JUNet(m.unet), 44, jnp.asarray(x_t), jnp.zeros((b,), jnp.int32),
            jnp.zeros((b, pad, m.unet.context_dim)),
            jnp.zeros((b, m.unet.addition_embed_dim))),
        "vae": jax_params(JVAE(m.vae), 45, jnp.asarray(x_t)),
    }
    proj = randn(np.random.default_rng(46), m.clip_text_2.hidden_size,
                 m.clip_text_2.hidden_size) / np.float32(
                     np.sqrt(m.clip_text_2.hidden_size))
    return {"cfg": cfg, "params": params, "ids": ids, "uids": uids,
            "x_t": x_t, "proj": proj}


def _ref_pipe(ref, proj=None):
    """The reference pipeline's conditioning methods over the JAX modules
    (no parameter init: the test's own trees go in)."""
    m = ref["cfg"].models
    ns = types.SimpleNamespace(
        cfg=ref["cfg"], clip=JClip(m.clip_text), clip2=JClip(m.clip_text_2),
        clip2_proj=proj,
        time_id_dim=(m.unet.addition_embed_dim
                     - m.clip_text_2.hidden_size) // 6)
    params = dict(ref["params"], clip2_proj=proj)
    return ns, params


def _port_pipe(ref, proj=None):
    p = ref["params"]
    sd = {"clip_text": from_jax("clip_text", p["clip"]),
          "clip_text_2": from_jax("clip_text_2", p["clip2"]),
          "unet": from_jax("unet_xl", p["unet"]),
          "vae": from_jax("vae_xl", p["vae"])}
    if proj is not None:
        sd["clip_text_2_projection"] = torch.from_numpy(proj)
    return SDXLPipeline(port_test_sdxl_config(), device="cpu",
                        state_dicts=sd)


@pytest.mark.parametrize("projected", [False, True])
def test_encode_matches_reference(sdxl_ref, projected):
    """Penultimate of tower 1 ++ penultimate of tower 2 as the context,
    bigG's pooled state as is or through the square projection
    (``pooled @ proj``, no transpose), within 1e-4."""
    proj = sdxl_ref["proj"] if projected else None
    ns, params = _ref_pipe(sdxl_ref, proj)
    ctx, pooled = JSDXL._encode(ns, params, jnp.asarray(sdxl_ref["ids"]))
    pipe = _port_pipe(sdxl_ref, proj)
    with torch.inference_mode():
        pctx, ppooled = pipe._encode(
            torch.from_numpy(sdxl_ref["ids"]).long())
    m = sdxl_ref["cfg"].models
    assert pctx.shape[-1] == m.clip_text.hidden_size \
        + m.clip_text_2.hidden_size == m.unet.context_dim
    assert_rel(pctx, np.asarray(ctx), 1e-4)
    assert_rel(ppooled, np.asarray(pooled), 1e-4)
    if projected:                     # the projection changes the output
        _, raw = JSDXL._encode(*_ref_pipe(sdxl_ref),
                               jnp.asarray(sdxl_ref["ids"]))
        assert np.abs(np.asarray(raw) - ppooled.numpy()).max() > 1e-2


@pytest.mark.parametrize("uncond", ["given", "zeros"])
def test_cfg_denoiser_with_additions(sdxl_ref, uncond):
    """One CFG step with the micro-conditioning stacked unconditional
    first like the context; an absent unconditional addition is zeros
    on both sides. fp32, within 1e-4."""
    m = sdxl_ref["cfg"].models
    rng = np.random.default_rng(47)
    x = sdxl_ref["x_t"]
    ctx, uctx = (randn(rng, 2, 16, m.unet.context_dim) for _ in range(2))
    add, uadd = (randn(rng, 2, m.unet.addition_embed_dim)
                 for _ in range(2))
    uadd_j = jnp.asarray(uadd) if uncond == "given" else None
    uadd_t = torch.from_numpy(uadd) if uncond == "given" else None
    ref_unet = JUNet(m.unet)
    denoise = jax_cfg_denoiser(ref_unet.apply, sdxl_ref["params"]["unet"],
                               jnp.asarray(ctx), jnp.asarray(uctx), 7.5,
                               addition_embeds=jnp.asarray(add),
                               uncond_addition_embeds=uadd_j)
    ref = np.asarray(denoise(jnp.asarray(x), 501))
    unet = load(UNet(port_test_sdxl_config().models.unet),
                sdxl_ref["params"]["unet"], "unet_xl")
    port = make_cfg_denoiser(unet, torch.from_numpy(ctx),
                             torch.from_numpy(uctx), 7.5,
                             addition_embeds=torch.from_numpy(add),
                             uncond_addition_embeds=uadd_t)
    with torch.inference_mode():
        out = port(torch.from_numpy(x),
                   torch.tensor([501], dtype=torch.int32))
    assert_rel(out, ref, 1e-4)


def test_sdxl_slice_images_match_reference(sdxl_ref):
    """Both towers -> micro-conditioned CFG DDIM -> VAE (0.13025) ->
    uint8 through the port's SDXLPipeline on the reference's x_T, against
    the reference built from its modules and functions: within 2 levels
    everywhere, mean |diff| <= 0.5."""
    cfg = sdxl_ref["cfg"]
    m, s = cfg.models, cfg.sampler
    ns, params = _ref_pipe(sdxl_ref)
    ids, uids = jnp.asarray(sdxl_ref["ids"]), jnp.asarray(sdxl_ref["uids"])
    ctx, pooled = JSDXL._encode(ns, params, ids)
    uctx, upooled = JSDXL._encode(ns, params, uids)
    time_ids = JSDXL._time_ids(ns, len(PROMPTS))
    unet, vae = JUNet(m.unet), JVAE(m.vae)
    denoise = jax_cfg_denoiser(
        unet.apply, params["unet"], ctx, uctx, s.guidance_scale,
        addition_embeds=jnp.concatenate([pooled, time_ids], axis=-1),
        uncond_addition_embeds=jnp.concatenate([upooled, time_ids],
                                               axis=-1))
    final = jax_ddim_sample(denoise, jnp.asarray(sdxl_ref["x_t"]),
                            JSchedule.create(s.num_steps))
    ref = np.asarray(jax_postprocess(vae.apply(params["vae"], final)))

    pipe = _port_pipe(sdxl_ref)
    images = pipe.generate(PROMPTS,
                           latents=torch.from_numpy(sdxl_ref["x_t"]))
    assert images.dtype == np.uint8 and images.shape == ref.shape
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()
    assert pipe.last_decoded_finite
    assert set(pipe.last_stage_seconds) == {"clip", "denoise", "vae"}


def test_backend_selects_sdxl_pipeline():
    """A config with a second text tower serves its image through
    SDXLPipeline (as the reference's TPUContentBackend does), SD1.5's
    through Text2ImagePipeline; a round's content comes back at the
    configured size."""
    sdxl = TorchContentBackend(port_test_sdxl_config(), device="cpu")
    assert isinstance(sdxl.t2i, SDXLPipeline)
    sd15 = TorchContentBackend(port_test_config(), device="cpu")
    assert type(sd15.t2i) is Text2ImagePipeline
    svc = InferenceService(port_test_sdxl_config(), device="cpu",
                           table=None)
    rc = asyncio.run(svc.generate_content("The Night the Trains Sang"))
    assert rc.image.shape == (64, 64, 3) and rc.image.dtype == np.uint8
    assert svc.backend.t2i.last_decoded_finite


def test_sdxl_config_matches_reference():
    """The port's copies of sdxl_config() and test_sdxl_config() agree
    with the reference's on every field the port keeps."""
    for port_cfg, jax_cfg in ((port_sdxl_config(), jax_sdxl_config()),
                              (port_test_sdxl_config(),
                               jax_test_sdxl_config())):
        pm, jm = port_cfg.models, jax_cfg.models
        for name in ("clip_text", "clip_text_2", "unet", "vae"):
            port_c, jax_c = getattr(pm, name), getattr(jm, name)
            for f in dataclasses.fields(port_c):
                assert getattr(port_c, f.name) == getattr(jax_c, f.name), \
                    (name, f.name)
        for f in dataclasses.fields(port_cfg.sampler):
            assert getattr(port_cfg.sampler, f.name) \
                == getattr(jax_cfg.sampler, f.name), f.name
        assert pm.param_dtype == jm.param_dtype
    cfg = port_sdxl_config()
    assert cfg.sampler.image_size == 1024
    assert cfg.models.unet.context_dim == 768 + 1280
    assert (cfg.models.unet.addition_embed_dim - 1280) // 6 == 256


def test_sdxl_kinds_and_seeds():
    """from_jax takes SDXL's kinds (the add_fc leaves as Dense kernels,
    transposed); the bigG tower's init seed is the reference's 11; the
    fused-conv and W8A8 SDXL UNets build (their parity:
    tests/test_torch_port_sdxl_quant.py); a config without bigG raises."""
    assert {"clip_text_2", "unet_xl", "vae_xl"} <= set(KINDS)
    assert INIT_SEEDS["clip_text_2"] == 11
    _, params, port, _ = _unet_case(4)
    sd = from_jax("unet_xl", params)
    k = np.asarray(params["params"]["add_fc1"]["kernel"])
    np.testing.assert_array_equal(sd["add_fc1.weight"].numpy(), k.T)
    assert set(sd) == set(port.state_dict())
    base = port_test_sdxl_config()
    for unet_kw, model_kw in (({"fused_conv": True}, {}),
                              ({"fused_conv": True}, {"unet_w8a8": True,
                                                      "w8a8_min_size": 0})):
        cfg = base.replace(models=dataclasses.replace(
            base.models, unet=dataclasses.replace(base.models.unet,
                                                  **unet_kw), **model_kw))
        pipe = SDXLPipeline(cfg, device="cpu")
        assert pipe.cfg.models.unet.fused_conv
        assert (quant.w8a8_site_count(pipe.unet) > 0) == \
            bool(model_kw.get("unet_w8a8"))
    with pytest.raises(ValueError):
        SDXLPipeline(port_test_config(), device="cpu")


def test_prompts_pad_within_both_towers():
    """One tokenization feeds both towers: prompts pad to the sampler's
    length, cut to the shorter tower's positions (77 and 77 at SDXL)."""
    base = port_test_sdxl_config()
    short = dataclasses.replace(base.models.clip_text_2, max_positions=12)
    cfg = base.replace(models=dataclasses.replace(base.models,
                                                  clip_text_2=short))
    pipe = SDXLPipeline(cfg, device="cpu")
    assert pipe.pad_len == 12
    assert pipe._tokenize(PROMPTS).shape == (2, 12)
    with torch.inference_mode():
        cond = pipe.encode(PROMPTS)
    assert cond["context"].shape == (2, 12, cfg.models.unet.context_dim)
