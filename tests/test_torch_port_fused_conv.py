"""Port parity of the fused GroupNorm -> SiLU -> conv3x3 path on the CPU,
where ``ops.fused_conv.gn_silu_conv3x3`` runs its plain version.

Inputs and reference parameter trees are made with numpy from a seed and
fed to both sides, in fp32. The reference's Pallas kernel cannot run here
(its interpret mode raises under the installed jax), so the reference side
of the module tests runs with ``CASSMANTLE_NO_FUSED_CONV=1``: its fused
sites then take ``gn_silu_conv3x3_reference``, the same function in lax,
which in fp32 has the kernel's arithmetic (affine and SiLU in fp32).
Tolerance: max |port - ref| <= 1e-4 * max |ref| (summation order of fp32
convolutions), images within the slice tests' 2 levels.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models import layers as jl
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import ResBlock as JResBlock
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.ops.fused_conv import gn_silu_conv3x3_reference
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch.config import (
    UNetConfig,
    fusedconv_serving_config,
    test_config as port_test_config,
)
from cassmantle_tpu_torch.models import layers as tl
from cassmantle_tpu_torch.models.unet import ResBlock, UNet
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import _igemm, fused_conv
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

from _torch_port_common import assert_rel, jax_params, load, randn

REL = 1e-4
PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]


@contextlib.contextmanager
def reference_lax_path():
    """The reference's fused sites through its lax reference (set while
    its modules are traced, init included)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CASSMANTLE_NO_FUSED_CONV", "1")
        yield


def fused(cfg):
    """``cfg`` with the fused-conv preset's UNet flags."""
    m = cfg.models
    return cfg.replace(models=dataclasses.replace(m, unet=dataclasses.replace(
        m.unet, fused_conv=True, conv_pad_to=128)))


def _conv_inputs(seed, b, h, w, c, f):
    rng = np.random.default_rng(seed)
    return (randn(rng, b, h, w, c), randn(rng, b, c) * 0.5 + 1.0,
            randn(rng, b, c) * 0.5, randn(rng, 3, 3, c, f) / np.sqrt(9 * c),
            randn(rng, f) * 0.1)


@pytest.mark.parametrize("b,h,w,c,f,pad_to", [
    (2, 8, 8, 16, 24, 0),       # nonzero shift b: the border is 0, not silu(b)
    (2, 6, 6, 40, 24, 128),     # pad_to: C and F padded, outputs sliced off
    (1, 5, 7, 8, 12, 0),        # odd height and width
    (2, 4, 4, 96, 64, 32),      # skip-concat width, pad_to a divisor of C
    (1, 3, 128, 16, 24, 0),     # W = 128: the VAE's stretch-tiled widths
    (1, 2, 100, 8, 16, 0),      # W = 100: a ragged last stretch
])
def test_plain_matches_reference(b, h, w, c, f, pad_to):
    args = _conv_inputs(b * h + c, b, h, w, c, f)
    ref = gn_silu_conv3x3_reference(*map(jnp.asarray, args))
    port = fused_conv.gn_silu_conv3x3(*map(torch.from_numpy, args),
                                      pad_to=pad_to)
    assert port.dtype == torch.float32
    assert_rel(port, ref, 1e-5)


def test_padding_is_exact_at_the_border():
    """A one-pixel image edge: with the border activated as silu(b) the
    result would differ from the reference by about silu(b) * w at every
    edge pixel."""
    x, a, b, k, bias = _conv_inputs(3, 1, 3, 3, 8, 8)
    b = np.full_like(b, 3.0)                       # silu(3) ~ 2.86
    ref = gn_silu_conv3x3_reference(*map(jnp.asarray, (x, a, b, k, bias)))
    port = fused_conv.gn_silu_conv3x3(*map(torch.from_numpy,
                                           (x, a, b, k, bias)))
    assert_rel(port, ref, 1e-5)


def test_gn_silu_conv3x3_on_the_cpu_counts_no_launch():
    fused_conv.reset_counters()
    fused_conv.gn_silu_conv3x3(*map(torch.from_numpy,
                                    _conv_inputs(0, 1, 4, 4, 8, 8)))
    assert fused_conv.gn_silu_conv3x3.launches == 0


@pytest.mark.parametrize("eps,channels_last", [(1e-5, False), (1e-6, True)])
def test_groupnorm_return_affine(eps, channels_last):
    x = randn(np.random.default_rng(1), 2, 6, 5, 64) * 3 + 1      # NHWC
    mod = jl.GroupNorm32(epsilon=eps)
    params = jax_params(mod, 1, jnp.asarray(x))
    ref_a, ref_b = mod.apply(params, jnp.asarray(x), return_affine=True)
    port = load(tl.GroupNorm32(64, eps=eps), params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if not channels_last:
        xt = xt.contiguous()
    a, b = port(xt, return_affine=True)
    assert a.dtype == b.dtype == torch.float32 and a.shape == (2, 64)
    assert_rel(a, ref_a, 1e-5)
    assert_rel(b, ref_b, 1e-5)


def test_conv3x3_params_is_conv_layout():
    """``Conv3x3Params`` keeps ``Conv``'s parameters: one state dict."""
    assert set(tl.Conv3x3Params(8, 4).state_dict()) == \
        set(tl.Conv(8, 4, 3).state_dict())


def _resblock_case(seed, c_in, c_out):
    rng = np.random.default_rng(seed)
    x, temb = randn(rng, 2, 8, 8, c_in), randn(rng, 2, 32)
    mod = JResBlock(c_out, jnp.float32, fused_conv=True, conv_pad_to=128)
    with reference_lax_path():
        params = jax_params(mod, seed, jnp.asarray(x), jnp.asarray(temb))
        ref = mod.apply(params, jnp.asarray(x), jnp.asarray(temb))
    return x, temb, ref, params


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (64, 32)])
def test_fused_resblock_matches_reference(c_in, c_out, monkeypatch):
    x, temb, ref, params = _resblock_case(2, c_in, c_out)
    port = load(ResBlock(c_in, c_out, 32, torch.float32, fused_conv=True,
                         conv_pad_to=128), params)
    calls = []
    real = tl.gn_silu_conv3x3
    monkeypatch.setattr(tl, "gn_silu_conv3x3",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(temb))
    assert len(calls) == 2                 # both convs took the fused op
    assert_rel(out.permute(0, 2, 3, 1), ref, REL)


def test_kill_switch_takes_the_unfused_path(monkeypatch):
    """CASSMANTLE_NO_FUSED_CONV selects the unfused module code (the same
    as fused_conv=False), never the fused op's plain version."""
    x, temb, _, params = _resblock_case(3, 32, 32)
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(temb))
    unfused = load(ResBlock(32, 32, 32, torch.float32), params)(*args)
    port = load(ResBlock(32, 32, 32, torch.float32, fused_conv=True), params)
    monkeypatch.setenv("CASSMANTLE_NO_FUSED_CONV", "1")
    monkeypatch.setattr(tl, "gn_silu_conv3x3", None)      # must not be called
    assert fused_conv.kill_switch_set()
    assert "kill-switched" in fused_conv.describe(
        fusedconv_serving_config().models.unet)
    assert torch.equal(port(*args), unfused)


def test_presets_and_arch():
    unet = fusedconv_serving_config().models.unet
    assert unet.fused_conv and unet.conv_pad_to == 128
    assert unet.arch() == UNetConfig()
    assert fused_conv.describe(UNetConfig()) == ""


@pytest.fixture(scope="module")
def tiny_unet_case():
    jm = fused(jax_test_config()).models
    rng = np.random.default_rng(7)
    lat, ctx = randn(rng, 2, 8, 8, 4), randn(rng, 2, 16, jm.unet.context_dim)
    t = np.array([981, 21], dtype=np.int32)
    mod = JUNet(jm.unet)
    args = (jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    with reference_lax_path():
        params = jax_params(mod, 7, *args)
        ref = mod.apply(params, *args)
    return lat, t, ctx, ref, params


def test_fused_unet_matches_reference(tiny_unet_case):
    lat, t, ctx, ref, params = tiny_unet_case
    port = load(UNet(fused(port_test_config()).models.unet), params, "unet")
    # the fused UNet runs channels-last: every ResBlock gets NHWC memory
    # (the card's kernels take it without a copy)
    layouts = []
    for m in port.modules():
        if isinstance(m, ResBlock):
            m.register_forward_pre_hook(lambda _, a: layouts.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    out = port(torch.from_numpy(lat), torch.from_numpy(t),
               torch.from_numpy(ctx))
    assert layouts and all(layouts), layouts
    assert_rel(out, ref, REL)


@pytest.fixture(scope="module")
def fused_slice_ref():
    """The reference's tiny slice on the fused-conv tree: parameters, x_T
    and the uint8 images (fused sites through the lax reference)."""
    with reference_lax_path():
        cfg = fused(jax_test_config())
        m, s = cfg.models, cfg.sampler
        tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
        pad = min(s.prompt_pad_len, m.clip_text.max_positions)
        ids = jnp.asarray(jax_tok(tok, PROMPTS, pad, m.clip_text.vocab_size))
        uids = jnp.asarray(jax_tok(tok, [s.negative_prompt] * len(PROMPTS),
                                   pad, m.clip_text.vocab_size))
        hw = s.image_size // 2 ** (len(m.vae.channel_mults) - 1)
        x_t = randn(np.random.default_rng(11), len(PROMPTS), hw, hw, 4)
        clip, unet, vae = JClip(m.clip_text), JUNet(m.unet), JVAE(m.vae)
        params = {
            "clip_text": jax_params(clip, 12, ids),
            "unet": jax_params(unet, 13, jnp.asarray(x_t),
                               jnp.zeros((len(PROMPTS),), jnp.int32),
                               jnp.zeros((len(PROMPTS), pad,
                                          m.unet.context_dim))),
            "vae": jax_params(vae, 14, jnp.asarray(x_t)),
        }
        ctx = clip.apply(params["clip_text"], ids)["hidden"]
        uctx = clip.apply(params["clip_text"], uids)["hidden"]
        denoise = jax_cfg_denoiser(unet.apply, params["unet"], ctx, uctx,
                                   s.guidance_scale)
        final = jax_ddim_sample(denoise, jnp.asarray(x_t),
                                JSchedule.create(s.num_steps))
        images = np.array(jax_postprocess(vae.apply(params["vae"], final)))
    return {"params": params, "x_t": x_t, "images": images}


def test_fused_slice_images_match_reference(fused_slice_ref):
    """CLIP -> CFG DDIM -> VAE -> uint8 on the fused-conv preset's tiny
    twin: within 2 levels everywhere, mean |diff| <= 0.5 (the slice
    tests' limits: fp32 on both sides)."""
    sd = {k: from_jax(k, v) for k, v in fused_slice_ref["params"].items()}
    pipe = Text2ImagePipeline(fused(port_test_config()), device="cpu",
                              state_dicts=sd)
    images = pipe.generate(PROMPTS,
                           latents=torch.from_numpy(fused_slice_ref["x_t"]))
    ref = fused_slice_ref["images"]
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    assert images.shape == ref.shape and diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


@pytest.mark.parametrize("sms", [132, 114])
def test_split_k_follows_the_cards_sm_count(sms):
    """The int8 conv splits K, over a thread-block cluster, only while
    its output tiles leave SMs idle, sized by the card at hand: clusters
    above 2 blocks take at most half of its SMs."""
    # 2 x 64 x 64 pixels: 128 tiles of 128 pixels x 160 filters fill
    # either card, unsplit (a persistent grid where they outnumber it)
    plan = _igemm.int8_conv_plan(2, 64, 64, 320, 320, sms)
    assert (plan.tiles, plan.slices) == (128, 1)
    assert plan.grid == min(128, sms)
    # 2 x 8 x 8 pixels: 8 tiles; 8 slices are 64 blocks, half of 132 SMs
    # but more than half of 114, which takes 4
    plan = _igemm.int8_conv_plan(2, 8, 8, 2560, 1280, sms)
    assert (plan.tiles, plan.slices) == (8, 8 if sms == 132 else 4)
    # 2 x 16 x 16 pixels: 64-pixel tiles in pairs of slices fill 132
    # SMs; on 114 the pairs would not fit, so 128-pixel tiles split in 2
    plan = _igemm.int8_conv_plan(2, 16, 16, 1280, 1280, sms)
    assert (plan.wgs, plan.slices) == ((1, 2) if sms == 132 else (2, 2))
    assert plan.tiles * plan.slices <= sms
