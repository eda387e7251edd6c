"""Port parity, module by module: each layer and model of
``cassmantle_tpu_torch`` against its Flax counterpart in fp32 on the CPU.

Parameter trees come from the Flax module's ``init`` with seeded numpy
values (``_torch_port_common.jax_params``) and cross over with
``from_jax``. Inputs are made with numpy from a seed
and fed to both sides. Tolerance: max |port - ref| <= 1e-4 * max |ref|
(fp32 on both sides; the difference is summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models import layers as jl
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.minilm import MiniLMEncoder as JMiniLM
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models import layers as tl
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.minilm import MiniLMEncoder
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.vae import VAEDecoder
from cassmantle_tpu_torch.models.weights import from_jax

import _torch_port_common as common
from _torch_port_common import jax_params, load, randn

REL = 1e-4


def assert_rel(port, ref, tol=REL):
    common.assert_rel(port, ref, tol)


# -- layers -------------------------------------------------------------------

def test_timestep_embedding_and_upsample():
    t = np.array([0, 7, 999], dtype=np.int32)
    assert_rel(tl.timestep_embedding(torch.from_numpy(t), 33),
               jl.timestep_embedding(jnp.asarray(t), 33))
    x = randn(np.random.default_rng(0), 2, 3, 5, 4)          # NHWC
    port = tl.nearest_upsample_2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_rel(port.permute(0, 2, 3, 1),
               jl.nearest_upsample_2x(jnp.asarray(x)), 0.0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm32(eps):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 6, 5, 64) * 3 + 1                     # NHWC
    mod = jl.GroupNorm32(epsilon=eps)
    params = jax_params(mod, 1, jnp.asarray(x))
    ref = mod.apply(params, jnp.asarray(x))
    port = load(tl.GroupNorm32(64, eps=eps), params)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_rel(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("which", ["LayerNorm32", "LayerNorm"])
def test_layernorms(which):
    rng = np.random.default_rng(2)
    x = randn(rng, 3, 7, 48) * 2 - 1
    if which == "LayerNorm32":
        mod, port = jl.LayerNorm32(), tl.LayerNorm32(48)
    else:
        import flax.linen as nn

        mod, port = nn.LayerNorm(epsilon=1e-5, dtype=jnp.float32), \
            tl.LayerNorm(48)
    params = jax_params(mod, 2, jnp.asarray(x))
    assert_rel(load(port, params)(torch.from_numpy(x)),
               mod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("fused,cross,masked", [
    (True, False, False),     # UNet self attention
    (True, True, False),      # UNet cross attention
    (False, False, True),     # GPT-2 / VAE style projections, masked
    (True, False, True),      # CLIP / MiniLM: fused and masked
])
def test_multi_head_attention(fused, cross, masked):
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 24, 32)
    ctx = randn(rng, 2, 7, 16) if cross else None
    mask = None
    if masked:
        mask = np.tril(np.ones((24, 24), dtype=bool))[None, None]
    mod = jl.MultiHeadAttention(num_heads=4, fused_qkv=fused,
                                use_bias=not fused, out_bias=True)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    params = jax_params(mod, 3, *args)
    ref = mod.apply(params, *args,
                    mask=None if mask is None else jnp.asarray(mask))
    port = load(tl.MultiHeadAttention(
        32, 4, context_dim=16 if cross else None, use_bias=not fused,
        out_bias=True, fused_qkv=fused), params)
    out = port(torch.from_numpy(x),
               context=None if ctx is None else torch.from_numpy(ctx),
               mask=None if mask is None else torch.from_numpy(mask))
    assert_rel(out, ref)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu", "exact_gelu"])
def test_transformer_mlp(act):
    import flax.linen as nn

    jact = {"gelu": nn.gelu, "quick_gelu": jl.quick_gelu,
            "exact_gelu": jl.exact_gelu}[act]
    tact = {"gelu": tl.gelu, "quick_gelu": tl.quick_gelu,
            "exact_gelu": tl.exact_gelu}[act]
    x = randn(np.random.default_rng(4), 2, 5, 32) * 2
    mod = jl.TransformerMLP(intermediate=64, activation=jact)
    params = jax_params(mod, 4, jnp.asarray(x))
    port = load(tl.TransformerMLP(32, 64, activation=tact), params)
    assert_rel(port(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x)))


def test_geglu():
    x = randn(np.random.default_rng(5), 2, 5, 32)
    mod = jl.GEGLU(intermediate=48)
    params = jax_params(mod, 5, jnp.asarray(x))
    port = load(tl.GEGLU(32, 48), params)
    assert_rel(port(torch.from_numpy(x)), mod.apply(params, jnp.asarray(x)))


# -- models -------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return jax_test_config().models, port_test_config().models


def test_clip_text(models):
    jm, tm = models
    ids = np.random.default_rng(6).integers(
        0, jm.clip_text.vocab_size, (2, 16)).astype(np.int32)
    mod = JClip(jm.clip_text)
    params = jax_params(mod, 6, jnp.asarray(ids))
    ref = mod.apply(params, jnp.asarray(ids))
    port = load(ClipTextEncoder(tm.clip_text), params, "clip_text")
    out = port(torch.from_numpy(ids).long())
    assert_rel(out["hidden"], ref["hidden"])
    assert_rel(out["pooled"], ref["pooled"])


def test_unet(models):
    jm, tm = models
    rng = np.random.default_rng(7)
    lat = randn(rng, 2, 8, 8, 4)
    t = np.array([981, 21], dtype=np.int32)
    ctx = randn(rng, 2, 16, jm.unet.context_dim)
    mod = JUNet(jm.unet)
    args = (jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    params = jax_params(mod, 7, *args)
    ref = mod.apply(params, *args)
    port = load(UNet(tm.unet), params, "unet")
    out = port(torch.from_numpy(lat), torch.from_numpy(t),
               torch.from_numpy(ctx))
    assert_rel(out, ref)


def test_vae_decoder(models):
    jm, tm = models
    lat = randn(np.random.default_rng(8), 1, 8, 8, 4)
    mod = JVAE(jm.vae)
    params = jax_params(mod, 8, jnp.asarray(lat))
    ref = mod.apply(params, jnp.asarray(lat))
    port = load(VAEDecoder(tm.vae), params, "vae")
    assert_rel(port(torch.from_numpy(lat)), ref)


def test_gpt2_forward_prefill_and_decode_step(models):
    jm, tm = models
    rng = np.random.default_rng(9)
    ids = rng.integers(0, jm.gpt2.vocab_size, (2, 12)).astype(np.int32)
    plen = np.array([12, 7], dtype=np.int32)
    mod = JGPT2(jm.gpt2)
    params = jax_params(mod, 9, jnp.asarray(ids))
    port = load(GPT2LM(tm.gpt2), params, "gpt2")
    tids = torch.from_numpy(ids).long()
    assert_rel(port(tids), mod.apply(params, jnp.asarray(ids)))

    last, cache = mod.apply(params, jnp.asarray(ids), jnp.asarray(plen), 16,
                            method=JGPT2.prefill)
    tlast, tcache = port.prefill(tids, torch.from_numpy(plen).long(), 16)
    assert_rel(tlast, last)
    assert_rel(tcache[1][0], cache[1][0])

    tok = np.array([3, 200], dtype=np.int32)
    valid = np.arange(16)[None, :] < plen[:, None]
    valid[:, 12] = True
    logits, _ = mod.apply(params, jnp.asarray(tok), 12, cache,
                          jnp.asarray(valid), method=JGPT2.decode_step)
    tlogits, _ = port.decode_step(torch.from_numpy(tok).long(), 12, tcache,
                                  torch.from_numpy(valid))
    assert_rel(tlogits, logits)


def test_minilm(models):
    jm, tm = models
    rng = np.random.default_rng(10)
    ids = rng.integers(0, jm.minilm.vocab_size, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), dtype=np.int32)
    mask[1, 6:] = 0
    mask[2, 2:] = 0
    mod = JMiniLM(jm.minilm)
    args = (jnp.asarray(ids), jnp.asarray(mask))
    params = jax_params(mod, 10, *args)
    port = load(MiniLMEncoder(tm.minilm), params, "minilm")
    out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert_rel(out, mod.apply(params, *args))


def test_from_jax_layouts():
    """Dense kernels transpose, conv kernels go HWIO -> OIHW, norms and
    embeddings rename; an unknown kind is refused."""
    tree = {"params": {
        "d": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
              "bias": np.zeros(3, np.float32)},
        "c": {"kernel": np.zeros((3, 3, 4, 5), np.float32)},
        "n": {"norm": {"scale": np.ones(4, np.float32)}},
        "e": {"embedding": np.zeros((7, 2), np.float32)},
        "position_embedding": np.zeros((3, 2), np.float32),
    }}
    sd = from_jax("unet", tree)
    assert sd["d.weight"].shape == (3, 2)
    assert sd["d.weight"][2, 1] == 5
    assert sd["c.weight"].shape == (5, 4, 3, 3)
    assert set(sd) == {"d.weight", "d.bias", "c.weight", "n.norm.weight",
                       "e.weight", "position_embedding"}
    with pytest.raises(ValueError):
        from_jax("moe", tree)
