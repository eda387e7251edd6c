"""img2img and the VAE encoder of the port against the reference, on the
CPU at ``test_config()`` sizes, fp32.

The encoder is held against the Flax ``VAEEncoder`` on one seeded numpy
tree carried by ``from_jax("vae_enc", ...)``: the sampled latents within
1e-4 of the reference's largest value, its sample drawn from the same
``jax.random`` key (``utils/jax_random.py``). ``generate_img2img(images,
prompts, strength, seed)`` is held seed for seed against the reference's
own ``Text2ImagePipeline._img2img_impl`` (CLIP, the encoder at
``split(PRNGKey(seed))[0]``, the noise at ``[1]``, the configured kind's
schedule tail, the VAE) on the same trees: uint8 images within 2 levels
(mean 0.5), in ``test_torch_port_img2img_reference.py``. The fused
encoder (the plain version of kernel 2 at every ResBlock) is held to the
reference's unfused one. The tail's graph (:class:`EagerStep` for the
CUDA graph) equals its eager loop bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.vae import VAEEncoder as JEncoder
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.vae import VAEEncoder, VAEResBlock
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import ddim as port_ddim
from cassmantle_tpu_torch.ops import fused_conv
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
from cassmantle_tpu_torch.utils import jax_random

from _torch_port_common import EagerStep, assert_rel, jax_params, load
from _torch_port_img2img import PROMPTS, reference_trees
from _torch_port_img2img import configs as _configs
from _torch_port_img2img import images as _images

REL = 1e-4


# -- the encoder ---------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_case():
    cfg = jax_test_config().models.vae
    img = np.random.default_rng(101).uniform(
        -1, 1, (2, 16, 16, 3)).astype(np.float32)
    params = jax_params(JEncoder(cfg), 102, jnp.asarray(img),
                        jax.random.PRNGKey(0))
    return cfg, img, params


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 7])
def test_vae_encoder_matches_reference(encoder_case, fused, seed):
    """Sampled, scaled latents within 1e-4 under the same key; the fused
    encoder (channels-last, the plain version of kernel 2 at each of its
    ResBlock convs) on the same tree."""
    cfg, img, params = encoder_case
    ref = np.asarray(JEncoder(cfg).apply(params, jnp.asarray(img),
                                         jax.random.PRNGKey(seed)))
    port_cfg = dataclasses.replace(port_config.test_config().models.vae,
                                   fused_conv=fused)
    port = load(VAEEncoder(port_cfg), params, "vae_enc")
    calls = []
    real = fused_conv.gn_silu_conv3x3

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    layouts = []
    for m in port.modules():
        if isinstance(m, VAEResBlock):
            m.register_forward_pre_hook(lambda _, a: layouts.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr("cassmantle_tpu_torch.models.layers.gn_silu_conv3x3",
                   counting)
        got = port(torch.from_numpy(img), jax_random.PRNGKey(seed))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_rel(got, ref, REL)
    # 2 levels x 1 ResBlock + the mid block's 2, two convs each
    assert len(calls) == (8 if fused else 0)
    assert layouts and (all(layouts) or not fused)


def test_vae_encoder_state_dict_names_are_the_references(encoder_case):
    cfg, _, params = encoder_case
    sd = from_jax("vae_enc", params)
    port = VAEEncoder(port_config.test_config().models.vae)
    assert set(sd) == set(port.state_dict())
    assert "down_0_downsample.weight" in sd and "quant_conv.bias" in sd
    assert port.down_0_downsample.stride == 2


# -- generate_img2img's graphs and validation -----------------------------------

@pytest.fixture(scope="module")
def img2img_trees():
    """Seeded reference trees of CLIP, the UNet, the decoder and the
    encoder at test_config() sizes."""
    return reference_trees()


def test_img2img_tail_graph_equals_eager(img2img_trees, monkeypatch):
    """The tail as one captured step graph per (k, latent shape)
    (:class:`EagerStep` for the graph) equals the eager tail bit for bit;
    a second strength captures its own graph."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    _, cfg = _configs(kind="dpmpp_2m", num_steps=10)
    sd = {k: from_jax(k, v) for k, v in img2img_trees.items()}
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
    images = _images(108)
    for strength in (0.6, 0.6, 0.3):
        eager = pipe.generate_img2img(images, PROMPTS, strength, 4,
                                      graphed=False)
        graphed = pipe.generate_img2img(images, PROMPTS, strength, 4,
                                        graphed=True)
        np.testing.assert_array_equal(graphed, eager)
    lat = (2, 32, 32, 4)
    assert sorted(pipe.img2img_graphs) == [(3, lat), (6, lat)]
    assert pipe.img2img_graphs[6, lat].graph.replays == 2 * 6
    assert len(pipe.img2img_graphs[6, lat].carry) == 2


def test_img2img_tail_graph_per_image_size(img2img_trees, monkeypatch):
    """Images of another size at the same batch and strength capture a
    tail graph of their own (the reference's jit retraces per shape),
    each equal to the eager tail bit for bit."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    _, cfg = _configs(kind="dpmpp_2m", num_steps=10)
    sd = {k: from_jax(k, v) for k, v in img2img_trees.items()}
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
    for size in (64, 32, 64):
        images = _images(110, size=size)
        eager = pipe.generate_img2img(images, PROMPTS, 0.3, 5,
                                      graphed=False)
        graphed = pipe.generate_img2img(images, PROMPTS, 0.3, 5,
                                        graphed=True)
        assert graphed.shape == images.shape
        np.testing.assert_array_equal(graphed, eager)
    assert sorted(pipe.img2img_graphs) == [(3, (2, 16, 16, 4)),
                                           (3, (2, 32, 32, 4))]
    assert pipe.img2img_graphs[3, (2, 32, 32, 4)].graph.replays == 2 * 3


@pytest.mark.parametrize("strength,k", [(0.6, 6), (0.05, 1), (0.25, 2),
                                        (0.35, 4), (1.0, 10)])
def test_img2img_strength_steps(img2img_trees, strength, k, monkeypatch):
    """k = round(strength * steps) clamped to [1, steps], as the
    reference (Python's round: 0.25 * 10 -> 2)."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    _, cfg = _configs(num_steps=10)
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts={
        "vae_enc": from_jax("vae_enc", img2img_trees["vae_enc"])})
    pipe.generate_img2img(_images(109, b=1), PROMPTS[:1], strength, 0,
                          graphed=True)
    assert list(pipe.img2img_graphs) == [(k, (1, 32, 32, 4))]


@pytest.mark.parametrize("sampler_kw,error,match", [
    (dict(deepcache=True), NotImplementedError, "deepcache"),
    (dict(encprop=True, encprop_dense_steps=1), NotImplementedError,
     "encoder propagation"),
    (dict(consistency=True, num_steps=4), NotImplementedError,
     "consistency"),
    (dict(eta=0.5), ValueError, "eta > 0 requires an rng key"),
])
def test_img2img_refusals_match_reference(sampler_kw, error, match):
    _, cfg = _configs(**sampler_kw)
    pipe = Text2ImagePipeline(cfg, device="cpu")
    with pytest.raises(error, match=match):
        pipe.generate_img2img(_images(110, b=1), PROMPTS[:1], 0.6, 0)
    assert pipe.vae_enc is None


def test_img2img_strength_and_sdxl_refusals():
    pipe = Text2ImagePipeline(port_config.test_config(), device="cpu")
    for strength in (0.0, 1.5):
        with pytest.raises(AssertionError, match="strength"):
            pipe.generate_img2img(_images(111, b=1), PROMPTS[:1], strength)
    sdxl = SDXLPipeline(port_config.test_sdxl_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="SDXL"):
        sdxl.generate_img2img(_images(111, b=1), PROMPTS[:1])


def test_encoder_conv_shapes_follow_the_encoder(monkeypatch):
    """chip_smoke's table of the SD1.5 encoder's fused ResBlock convs
    (img2img's kernel-2 launches at 512²), counted on the full-width
    encoder (base 128, mults 1, 2, 4, 4) at a 64² image: the same (C, F)
    at each level, W scaled by 8."""
    import collections

    import chip_smoke

    cfg = dataclasses.replace(port_config.VAEConfig(), fused_conv=True,
                              dtype="float32")
    enc = VAEEncoder(cfg).eval()
    torch.manual_seed(0)
    for prm in enc.parameters():
        torch.nn.init.normal_(prm, std=0.02)
    calls = collections.Counter()
    real = fused_conv.gn_silu_conv3x3

    def recording(x, a, b, kernel, bias, **kw):
        n, h, w, c = x.shape
        calls[(n, 8 * h, 8 * w, c, kernel.shape[-1])] += 1
        return real(x, a, b, kernel, bias, **kw)

    monkeypatch.setattr("cassmantle_tpu_torch.models.layers.gn_silu_conv3x3",
                        recording)
    with torch.inference_mode():
        enc(torch.zeros(1, 64, 64, 3), jax_random.PRNGKey(0))
    assert dict(calls) == chip_smoke.VAE_CONV_SHAPES["sd15_enc"]
    assert sum(calls.values()) == 20
