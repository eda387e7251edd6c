"""Port parity of W8A8 serving on the CPU, where the int8 wrappers run
their plain versions.

Inputs and reference parameter trees are made with numpy from a seed and
fed to both sides. The reference side takes its lax references
(``int8_matmul_ok`` and ``int8_conv_ok`` patched to False, and its fused
sites traced under ``CASSMANTLE_NO_FUSED_CONV``, since its Pallas
interpret mode raises under the installed jax).

Tolerances, each with its reason:
- weight quantization, activation quantization, the int8 matmul and conv
  on the same int8 inputs, and the W8A8 transform are bit-identical:
  the same fp32 divides, half-to-even rounding and exact int32 sums;
- functions that quantize an activation computed by each framework
  (``w8a8_dense``, ``gn_silu_conv3x3_w8a8``, the models) may see one int8
  value flip by one step where the activation lands within an fp32 ulp
  of a rounding boundary; each flip moves an output by at most one
  quantization step of one product, well below 1e-3 * max |output| at
  these sizes (measured: 0 to 2e-6);
- the models are held site by site: every W8A8 site call of a whole
  forward (its inputs and output recorded on the port) against the
  reference's own site function on the same inputs, with the reference's
  quantized leaf of that site and its scale mode (per tensor over the
  whole CFG batch for the UNet, per token for GPT-2), within the flip
  limit above; and the set of sites called must be the reference's.
  Measured: 0 to 1.6e-7 of max |output| per site. A site quantized per
  sample or per token where the reference scales per tensor misses the
  limit by 7x or more (7.5e-3 to 3e-2), and an unquantized site leaves
  the site set; the control tests show each of these fails;
- the model outputs themselves are chaotic at the size of the
  quantization error: one int8 value that flips moves its element by
  1/127 of the site's absmax, and at these widths (32 to 64 channels) a
  change of 1e-6 of the input moves the reference's own output by 1 to
  3 %. So the outputs are also held within twice that spread of the
  reference (at least 1e-3 of the output; 2 levels, mean 0.5 for
  images). That bound cannot tell W8A8 from fp at this size (they differ
  by about 3 %), so it catches gross faults only; the site checks carry
  the precision. The UNet runs with dynamic scales (the serving
  preset's), the images with static scales calibrated on the
  reference's fp forward.
"""

import contextlib
import dataclasses
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops import quant as jq
from cassmantle_tpu.parallel import calibrate as jax_calibrate
from cassmantle_tpu.ops import quant_matmul as jqm
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch.config import (
    test_config as port_test_config,
    w8a8_serving_config,
)
from cassmantle_tpu_torch.models import layers
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import quant, quant_matmul
from cassmantle_tpu_torch.serving import pipeline as port_pipeline
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    Text2ImagePipeline,
)

from _torch_port_common import assert_rel, jax_params, load, randn

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]
FLIP_REL = 1e-3


def w8a8(cfg, lm=True):
    """``cfg`` with the W8A8 preset's flags at w8a8_min_size=0."""
    m = cfg.models
    return cfg.replace(models=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, fused_conv=True, conv_pad_to=128),
        unet_w8a8=True, lm_w8a8=lm, w8a8_min_size=0))


@contextlib.contextmanager
def reference_lax_path():
    """The reference's int8 sites through its lax references and its
    fused fp sites through the lax fused reference."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CASSMANTLE_NO_FUSED_CONV", "1")
        mp.setattr(jqm, "int8_matmul_ok", lambda *a: False)
        mp.setattr(jqm, "int8_conv_ok", lambda *a: False)
        yield


def calibrate(mod, params, *args):
    """Per-site activation absmax of the reference's fp forward (its
    calibration recorder), the static scales of the model tests."""
    with reference_lax_path(), jq.collect_act_stats() as sink:
        mod.apply(params, *args)
    return dict(sink)


def spread(fn, x, n=4, eps=1e-6):
    """(max, mean) |fn(x') - fn(x)| over ``n`` inputs x' = x (1 + eps z):
    how far the reference strays from itself under a perturbation the
    size of fp32 summation-order differences."""
    base = np.asarray(fn(x), dtype=np.float64)
    worst_max = worst_mean = 0.0
    for seed in range(n):
        z = np.random.default_rng(100 + seed).standard_normal(x.shape)
        d = np.abs(np.asarray(fn((x * (1 + eps * z)).astype(np.float32)),
                              dtype=np.float64) - base)
        worst_max, worst_mean = max(worst_max, d.max()), max(worst_mean,
                                                             d.mean())
    return worst_max, worst_mean


def assert_within_spread(port, ref, ref_spread, floor_rel=FLIP_REL):
    """max and mean |port - ref| within twice the reference's own spread
    (at least ``floor_rel`` of max |ref|)."""
    d = np.abs(np_(port).astype(np.float64) - ref)
    floor = floor_rel * np.abs(ref).max()
    assert d.max() <= max(2 * ref_spread[0], floor), (d.max(), ref_spread)
    assert d.mean() <= max(2 * ref_spread[1], floor), (d.mean(), ref_spread)


def jax_w8a8_tree(params, act_scales=None):
    pred = partial(jq.w8a8_default_predicate, min_size=0)
    return jq.w8a8_tree_host(params, act_scales=act_scales, predicate=pred)


@contextlib.contextmanager
def record_sites(model, mutate=None):
    """Record every W8A8 site call of ``model`` as (kind, site name, args,
    kwargs, output). ``mutate`` = (site name, wrap), where ``wrap(kind,
    fn)`` returns the function that site runs instead (the controls)."""
    names = {m.weight_q.data_ptr(): name for name, m in model.named_modules()
             if quant.quantized_weight(m) is not None}
    calls = []

    def wrap(kind, fn):
        def site(*args, **kw):
            q = next(a for a in args if isinstance(a, quant.ActQTensor))
            name = names[q.data.data_ptr()]
            run = (mutate[1](kind, fn) if mutate and mutate[0] == name
                   else fn)
            out = run(*args, **kw)
            calls.append((kind, name, args, kw, out))
            return out
        return site

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "w8a8_dense", wrap("dense", layers.w8a8_dense))
        mp.setattr(layers, "gn_silu_conv3x3_w8a8",
                   wrap("conv", layers.gn_silu_conv3x3_w8a8))
        yield calls


def reference_sites(tree):
    """{'.'-joined module path: its quantized leaf's module dict} of a
    reference W8A8 tree."""
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, jq.ActQTensor):
                out[".".join(path)] = node
            elif isinstance(value, dict):
                walk(value, path + (key,))

    walk(tree["params"], ())
    return out


def check_sites(calls, tree, per_token):
    """Every recorded site call against the reference's site function on
    the same inputs with that site's quantized leaf (and ``per_token``
    scales for dense sites), within FLIP_REL of max |output|; and the
    sites called are the reference's quantized sites."""
    ref_sites = reference_sites(tree)
    called = {name for _, name, *_ in calls}
    assert called == set(ref_sites), sorted(called ^ set(ref_sites))
    with reference_lax_path():
        for kind, name, args, _, out in calls:
            leaf = ref_sites[name]
            bias = None if leaf.get("bias") is None else jnp.asarray(
                leaf["bias"])
            if kind == "dense":
                ref = jqm.w8a8_dense(jnp.asarray(np_(args[0])),
                                     leaf["kernel"], bias,
                                     per_token=per_token)
            else:
                x, a, b = (jnp.asarray(np_(t)) for t in args[:3])
                ref = jqm.gn_silu_conv3x3_w8a8(x, a, b, leaf["kernel"], bias)
            ref = np.asarray(ref, dtype=np.float64)
            err = np.abs(np_(out) - ref).max() / np.abs(ref).max()
            assert err <= FLIP_REL, f"site {name}: relative error {err:.3g}"


def per_sample(kind, fn):
    """The site run on each sample alone: per-sample dynamic scales where
    the reference scales the whole CFG batch at once."""
    def run(x, *args, **kw):
        return torch.cat([
            fn(x[i:i + 1], *(t[i:i + 1] if kind == "conv" and j < 2 else t
                             for j, t in enumerate(args)), **kw)
            for i in range(x.shape[0])])
    return run


def with_per_token(flag):
    """The dense site run with per-token scales on (or off)."""
    def wrap(kind, fn):
        return lambda *args, **kw: fn(*args, **{**kw, "per_token": flag})
    return wrap


def to_port_q(q):
    """A reference ActQTensor as the port's, same (reference) layout."""
    act = None if q.act_scale is None else torch.tensor(
        np.asarray(q.act_scale))
    return quant.ActQTensor(torch.from_numpy(np.array(q.data)),
                            torch.from_numpy(np.array(q.scale)), act)


def np_(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# -- quantization -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 16, 24), (5, 7)])
def test_quantize_tensor_is_bit_identical(shape):
    w = randn(np.random.default_rng(sum(shape)), *shape) * 0.1
    w[..., 2] = 0.0                          # an all-zero channel: scale 1
    ref = jq.quantize_tensor(jnp.asarray(w))
    data, scale = quant.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(np_(data), np.asarray(ref.data))
    np.testing.assert_array_equal(np_(scale), np.asarray(ref.scale))
    assert float(scale.reshape(-1)[2]) == 1.0


@pytest.mark.parametrize("per_token", [False, True])
def test_quantize_act_is_bit_identical(per_token):
    x = randn(np.random.default_rng(4), 6, 40) * 3
    x[1] = 0.0                               # a zero row: the eps floor
    ref_scale = jq.act_scale_from_absmax(
        jq.act_absmax(jnp.asarray(x), per_token=per_token))
    scale = quant.act_scale_from_absmax(
        quant.act_absmax(torch.from_numpy(x), per_token=per_token))
    np.testing.assert_array_equal(np_(scale), np.asarray(ref_scale))
    np.testing.assert_array_equal(
        np_(quant.quantize_act(torch.from_numpy(x), scale)),
        np.asarray(jq.quantize_act(jnp.asarray(x), ref_scale)))
    static = np.float32(0.02)                # clips at +-127
    np.testing.assert_array_equal(
        np_(quant.quantize_act(torch.from_numpy(x), torch.tensor(static))),
        np.asarray(jq.quantize_act(jnp.asarray(x), static)))


# -- the int8 kernels' plain versions against the lax references --------------

def _int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n,per_token,bias", [
    (8, 64, 128, False, True),
    (5, 80, 33, True, True),        # odd rows and columns
    (1, 64, 48, True, False),       # a decode row, no bias
])
def test_int8_matmul_plain_matches_reference(m, k, n, per_token, bias):
    rng = np.random.default_rng(m * n)
    x_q, w_q = _int8(rng, m, k), _int8(rng, k, n)
    row = (rng.uniform(0.01, 0.2, (m, 1)) if per_token
           else rng.uniform(0.01, 0.2, ())).astype(np.float32)
    col = rng.uniform(0.001, 0.05, (1, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    ref = jqm.int8_matmul_reference(
        jnp.asarray(x_q), jnp.asarray(w_q),
        jnp.broadcast_to(jnp.asarray(row), (m, 1)), jnp.asarray(col),
        jnp.zeros((1, n)) if b is None else jnp.asarray(b).reshape(1, n))
    port = quant_matmul.int8_matmul(
        torch.from_numpy(x_q), torch.from_numpy(w_q), torch.from_numpy(row),
        torch.from_numpy(col), None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(np_(port), np.asarray(ref))


def test_int8_conv3x3_plain_matches_reference():
    rng = np.random.default_rng(7)
    x_q, kern = _int8(rng, 2, 8, 8, 16), _int8(rng, 3, 3, 16, 32)
    col = rng.uniform(0.001, 0.05, (32,)).astype(np.float32)
    bias = rng.standard_normal((32,)).astype(np.float32)
    ref = jqm.int8_conv3x3_reference(jnp.asarray(x_q), jnp.asarray(kern),
                                     jnp.asarray(col).reshape(1, 32),
                                     jnp.asarray(bias).reshape(1, 32))
    port = quant_matmul.int8_conv3x3(*map(torch.from_numpy,
                                          (x_q, kern, col, bias)))
    np.testing.assert_array_equal(np_(port), np.asarray(ref))


@pytest.mark.parametrize("static,pad_to", [(False, 0), (True, 0),
                                           (False, 128)])
def test_gn_silu_conv3x3_w8a8_matches_reference(static, pad_to):
    rng = np.random.default_rng(5)
    x = randn(rng, 2, 8, 8, 16)
    a = rng.uniform(0.5, 1.5, (2, 16)).astype(np.float32)
    b = randn(rng, 2, 16) * 0.1
    w = randn(rng, 3, 3, 16, 32) * 0.1
    bias = randn(rng, 32)
    q = jq.quantize_tensor_act(jnp.asarray(w),
                               act_scale=0.02 if static else None)
    ref = jqm.gn_silu_conv3x3_w8a8_reference(
        *map(jnp.asarray, (x, a, b)), q, jnp.asarray(bias))
    quant_matmul.reset_counters()
    port = quant_matmul.gn_silu_conv3x3_w8a8(
        *map(torch.from_numpy, (x, a, b)), to_port_q(q),
        torch.from_numpy(bias), pad_to=pad_to)
    assert port.shape == (2, 8, 8, 32) and port.dtype == torch.float32
    assert quant_matmul.int8_conv3x3.launches == 0        # the CPU: plain
    assert_rel(port, ref, FLIP_REL)


@pytest.mark.parametrize("mode", ["dynamic", "static", "per_token"])
def test_w8a8_dense_matches_reference(mode):
    rng = np.random.default_rng(3)
    x, w = randn(rng, 2, 6, 64), randn(rng, 64, 48) * 0.1
    bias = randn(rng, 48)
    q = jq.quantize_tensor_act(jnp.asarray(w),
                               act_scale=0.03 if mode == "static" else None)
    with reference_lax_path():
        ref = jqm.w8a8_dense(jnp.asarray(x), q, jnp.asarray(bias),
                             per_token=mode == "per_token")
    port = quant_matmul.w8a8_dense(torch.from_numpy(x), to_port_q(q),
                                   torch.from_numpy(bias),
                                   per_token=mode == "per_token")
    assert port.shape == (2, 6, 48)
    assert_rel(port, ref, FLIP_REL)


# -- the transform ------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_case():
    """The reference's tiny W8A8 UNet: fp parameters, inputs, its output."""
    jm = w8a8(jax_test_config()).models
    rng = np.random.default_rng(7)
    lat, ctx = randn(rng, 2, 8, 8, 4), randn(rng, 2, 16, jm.unet.context_dim)
    t = np.array([981, 21], dtype=np.int32)
    mod = JUNet(jm.unet)
    args = (jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    with reference_lax_path():
        params = jax_params(mod, 7, *args)
        tree = jax_w8a8_tree(params)

        def fn(x):
            return mod.apply(tree, jnp.asarray(x), *args[1:])

        ref = np.asarray(fn(lat), dtype=np.float64)
        ref_spread = spread(fn, lat)
    return dict(lat=lat, t=t, ctx=ctx, params=params, ref=ref,
                spread=ref_spread)


def test_transform_matches_w8a8_tree_host(unet_case):
    """The port's transform on the port's UNet against the reference's
    ``w8a8_tree_host`` carried over by ``from_jax``: the same sites, with
    identical int8 data, weight scales and static activation scales."""
    act_scales = {"down_0_res_0/conv1": 2.5,
                  "mid_attn/block_0/self_attn/qkv": 4.0}
    params = unet_case["params"]
    ref_sd = from_jax("unet", jax_w8a8_tree(params, act_scales))
    port = load(UNet(w8a8(port_test_config()).models.unet), params, "unet")
    sites = quant.w8a8_modules(port, act_scales, partial(
        quant.w8a8_default_predicate, min_size=0))
    sd = port.state_dict()
    assert set(sd) == set(ref_sd)
    for key, value in sd.items():
        assert value.dtype == ref_sd[key].dtype, key
        assert torch.equal(value, ref_sd[key]), key
    assert sites == quant.w8a8_site_count(port) == sum(
        k.endswith("weight_q") for k in sd)
    assert sites == jq.w8a8_site_count(jax_w8a8_tree(params))
    assert sum(k.endswith("act_scale") for k in sd) == 2
    assert quant.w8a8_calibrated(port)


def w8a8_unet(unet_case, skip=None):
    """The port's tiny UNet quantized at every site (but ``skip``)."""
    port = load(UNet(w8a8(port_test_config()).models.unet),
                unet_case["params"], "unet")
    quant.w8a8_modules(port, predicate=lambda path, w: (
        ".".join(path) != skip
        and quant.w8a8_default_predicate(path, w, min_size=0)))
    return port


def unet_sites(unet_case, port, mutate=None):
    """The port's forward on the case's inputs with its site calls."""
    with torch.no_grad(), record_sites(port, mutate) as calls:
        out = port(*map(torch.from_numpy,
                        (unet_case["lat"], unet_case["t"], unet_case["ctx"])))
    return out, calls


def test_w8a8_unet_matches_reference(unet_case):
    port = w8a8_unet(unet_case)
    assert not quant.w8a8_calibrated(port)
    out, calls = unet_sites(unet_case, port)
    assert len(calls) == quant.w8a8_site_count(port)     # each site once
    check_sites(calls, jax_w8a8_tree(unet_case["params"]), per_token=False)
    assert_within_spread(out, unet_case["ref"], unet_case["spread"])


@pytest.mark.parametrize("site,fault", [
    ("mid_res_0.conv1", "per_sample"),
    ("mid_attn.block_0.cross_attn.q", "per_sample"),
    ("mid_attn.block_0.self_attn.qkv", "per_token"),
    ("up_1_res_0.conv2", "unquantized"),
])
def test_w8a8_unet_site_check_catches(unet_case, site, fault):
    """Controls: one site scaled per sample or per token where the
    reference scales per tensor, or left unquantized, fails the site
    check, at that site."""
    mutate = {"per_sample": (site, per_sample),
              "per_token": (site, with_per_token(True))}.get(fault)
    port = w8a8_unet(unet_case, skip=site if fault == "unquantized" else None)
    _, calls = unet_sites(unet_case, port, mutate)
    with pytest.raises(AssertionError, match=re.escape(site)):
        check_sites(calls, jax_w8a8_tree(unet_case["params"]),
                    per_token=False)


@pytest.fixture(scope="module")
def gpt2_case():
    """The tiny GPT-2's reference parameters and inputs: ids, prompt
    lengths, one decode token and its cache mask."""
    jm = jax_test_config().models.gpt2
    rng = np.random.default_rng(9)
    ids = rng.integers(0, jm.vocab_size, (2, 12)).astype(np.int32)
    plen = np.array([12, 7], dtype=np.int32)
    tok = np.array([3, 200], dtype=np.int32)
    valid = np.arange(16)[None, :] < plen[:, None]
    valid[:, 12] = True
    params = jax_params(JGPT2(jm), 9, jnp.asarray(ids))
    return dict(ids=ids, plen=plen, tok=tok, valid=valid, params=params)


def gpt2_sites(case, mutate=None):
    """The port's W8A8 GPT-2: its logits, prefill and one decode step,
    flattened, with its site calls."""
    port = load(GPT2LM(port_test_config().models.gpt2), case["params"],
                "gpt2")
    sites = quant.w8a8_modules(port, predicate=partial(
        quant.w8a8_default_predicate, min_size=0))
    tids = torch.from_numpy(case["ids"]).long()
    with torch.no_grad(), record_sites(port, mutate) as calls:
        logits = port(tids)
        last, cache = port.prefill(tids, torch.from_numpy(case["plen"]).long(),
                                   16)
        step, _ = port.decode_step(torch.from_numpy(case["tok"]).long(), 12,
                                   cache, torch.from_numpy(case["valid"]))
    out = torch.cat([logits.reshape(-1), last.reshape(-1), step.reshape(-1)])
    return port, sites, out, calls


def test_w8a8_gpt2_matches_reference(gpt2_case):
    """GPT-2 W8A8 (per-token scales) against the reference's: every site
    call of the full forward, a prefill and one cached decode step, and
    the logits within the reference's own spread (its token embeddings
    changed by 1e-6)."""
    jm = jax_test_config().models.gpt2
    ids, plen, tok, valid = (gpt2_case[k] for k in ("ids", "plen", "tok",
                                                    "valid"))
    mod = JGPT2(jm)
    params = gpt2_case["params"]
    wte = np.asarray(params["params"]["wte"]["embedding"])

    def reference(embedding):
        tree = jax.tree_util.tree_map(lambda x: x, params)
        tree["params"]["wte"]["embedding"] = jnp.asarray(embedding)
        tree = jax_w8a8_tree(tree)
        logits = mod.apply(tree, jnp.asarray(ids))
        last, cache = mod.apply(tree, jnp.asarray(ids), jnp.asarray(plen),
                                16, method=JGPT2.prefill)
        step, _ = mod.apply(tree, jnp.asarray(tok), 12, cache,
                            jnp.asarray(valid), method=JGPT2.decode_step)
        return np.concatenate([np.asarray(logits).reshape(-1),
                               np.asarray(last).reshape(-1),
                               np.asarray(step).reshape(-1)])

    with reference_lax_path():
        ref = reference(wte).astype(np.float64)
        ref_spread = spread(reference, wte, n=2)
    port, sites, out, calls = gpt2_sites(gpt2_case)
    assert sites == 6 * jm.num_layers          # q, k, v, out, fc1, fc2
    assert all(m.act_per_token for m in port.modules()
               if quant.quantized_weight(m) is not None)
    assert len(calls) == 3 * sites             # forward, prefill, decode
    check_sites(calls, jax_w8a8_tree(params), per_token=True)
    assert_within_spread(out, ref, ref_spread)


@pytest.mark.parametrize("site", ["block_0.attn.q", "block_1.mlp.fc2"])
def test_w8a8_gpt2_site_check_catches_per_tensor_scales(gpt2_case, site):
    """Control: one GPT-2 site scaled per tensor where the reference
    scales per token fails the site check, at that site."""
    *_, calls = gpt2_sites(gpt2_case, (site, with_per_token(False)))
    with pytest.raises(AssertionError, match=re.escape(site)):
        check_sites(calls, jax_w8a8_tree(gpt2_case["params"]),
                    per_token=True)


# -- the pipelines ------------------------------------------------------------

@pytest.fixture(scope="module")
def w8a8_slice_ref():
    """The reference's tiny slice with a W8A8 UNet (static scales from
    one calibrating forward at the first step): fp parameters, x_T, the
    scales and the uint8 images."""
    with reference_lax_path():
        cfg = w8a8(jax_test_config())
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
        sched = JSchedule.create(s.num_steps)
        t0 = jnp.full((2 * len(PROMPTS),), int(sched.timesteps[0]), jnp.int32)
        scales = calibrate(unet, params["unet"],
                           jnp.concatenate([x_t, x_t]), t0,
                           jnp.concatenate([uctx, ctx]))
        denoise = jax_cfg_denoiser(
            unet.apply, jax_w8a8_tree(params["unet"], scales), ctx, uctx,
            s.guidance_scale)

        def images_of(x):
            final = jax_ddim_sample(denoise, jnp.asarray(x), sched)
            return np.array(jax_postprocess(vae.apply(params["vae"], final)))

        images = images_of(x_t)
        ref_spread = spread(images_of, x_t, n=2)
    return {"params": params, "x_t": x_t, "scales": scales,
            "images": images, "spread": ref_spread}


def test_w8a8_slice_images_match_reference(w8a8_slice_ref):
    """The W8A8 preset's tiny twin against the reference on the same x_T.
    The preset's pipeline quantizes the reference's sites at build, with
    the static scales of the committed calibration entry, which matches
    this geometry (as the reference's ``w8a8_unet_tools`` folds them in).
    The images take the reference's static scales: the
    fused fp pipeline's UNet quantized with them, from the same fp
    weights. Every site call of the first denoise step against the
    reference's; the images within twice the reference's own spread, and
    at least 2 levels (mean 0.5)."""
    sd = {k: from_jax(k, v) for k, v in w8a8_slice_ref["params"].items()}
    cfg = w8a8(port_test_config())
    ref_tree = jax_w8a8_tree(w8a8_slice_ref["params"]["unet"],
                             w8a8_slice_ref["scales"])
    armed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
    assert quant.w8a8_site_count(armed.unet) == jq.w8a8_site_count(ref_tree)
    assert quant.w8a8_calibrated(armed.unet)
    committed = from_jax("unet", jax_w8a8_tree(
        w8a8_slice_ref["params"]["unet"],
        jax_calibrate.load_act_scales(w8a8(jax_test_config()).models)))
    built = armed.unet.state_dict()
    assert {k for k in built if k.endswith("act_scale")} == \
        {k for k in committed if k.endswith("act_scale")}
    for key, value in committed.items():
        assert torch.equal(built[key], value), key
    pipe = Text2ImagePipeline(cfg.replace(models=dataclasses.replace(
        cfg.models, unet_w8a8=False, lm_w8a8=False)), device="cpu",
        state_dicts=sd)
    quant.w8a8_modules(pipe.unet, w8a8_slice_ref["scales"], partial(
        quant.w8a8_default_predicate, min_size=0))
    assert quant.w8a8_calibrated(pipe.unet)
    with record_sites(pipe.unet) as calls:
        images = pipe.generate(PROMPTS,
                               latents=torch.from_numpy(w8a8_slice_ref["x_t"]))
    sites = quant.w8a8_site_count(pipe.unet)
    assert len(calls) == sites * cfg.sampler.num_steps
    check_sites(calls[:sites], ref_tree, per_token=False)
    ref = w8a8_slice_ref["images"]
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    max_spread, mean_spread = w8a8_slice_ref["spread"]
    assert images.shape == ref.shape
    assert diff.max() <= max(2, 2 * max_spread), (diff.max(), max_spread)
    assert diff.mean() <= max(0.5, 2 * mean_spread), (diff.mean(),
                                                      mean_spread)


def test_kill_switch_never_quantizes(w8a8_slice_ref, monkeypatch):
    """CASSMANTLE_NO_W8A8, read at build: no site quantizes and the images
    equal the fused fp pipeline's bit for bit."""
    sd = {k: from_jax(k, v) for k, v in w8a8_slice_ref["params"].items()}
    cfg = w8a8(port_test_config())
    fp_cfg = cfg.replace(models=dataclasses.replace(
        cfg.models, unet_w8a8=False, lm_w8a8=False))
    x_t = torch.from_numpy(w8a8_slice_ref["x_t"])
    ref = Text2ImagePipeline(fp_cfg, device="cpu",
                             state_dicts=sd).generate(PROMPTS, latents=x_t)
    monkeypatch.setenv("CASSMANTLE_NO_W8A8", "1")
    assert quant_matmul.w8a8_disabled()
    killed = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd)
    assert quant.w8a8_site_count(killed.unet) == 0
    gen = PromptGenerator(cfg, device="cpu")
    assert quant.w8a8_site_count(gen.model) == 0
    np.testing.assert_array_equal(killed.generate(PROMPTS, latents=x_t), ref)


def test_lm_w8a8_prompt_generator_quantizes_at_build():
    """PromptGenerator under lm_w8a8: every projection quantized from the
    given weights at build, per-token, and the greedy decode runs through
    the W8A8 path (no launch on the CPU)."""
    cfg = w8a8(port_test_config())
    jm = jax_test_config().models.gpt2
    params = jax_params(JGPT2(jm), 16, jnp.zeros((1, 8), jnp.int32))
    gen = PromptGenerator(cfg, device="cpu",
                          state_dict=from_jax("gpt2", params))
    assert quant.w8a8_site_count(gen.model) == 6 * jm.num_layers
    quant_matmul.reset_counters()
    tokens, lengths = gen.decode_ids_batch(["the storm rolled"],
                                           max_new_tokens=4)
    assert tokens.shape == (1, 4) and 1 <= lengths[0] <= 4
    assert quant_matmul.int8_matmul.launches == 0


def test_w8a8_unet_tools_assertions_and_presets():
    cfg = w8a8(port_test_config())
    assert port_pipeline.w8a8_unet_tools(cfg.models) is not None
    unfused = dataclasses.replace(cfg.models, unet=dataclasses.replace(
        cfg.models.unet, fused_conv=False))
    with pytest.raises(ValueError, match="fused_conv"):
        port_pipeline.w8a8_unet_tools(unfused)
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_pipeline.w8a8_unet_tools(dataclasses.replace(
            cfg.models, unet_int8=True))
    # weights-only int8 alone is int8_unet_tools' (tests/test_torch_port_int8)
    int8_only = dataclasses.replace(cfg.models, unet_int8=True,
                                    unet_w8a8=False)
    assert port_pipeline.w8a8_unet_tools(int8_only) is None
    assert port_pipeline.int8_unet_tools(int8_only) is not None
    m = w8a8_serving_config().models
    assert m.unet_w8a8 and m.lm_w8a8 and m.unet.fused_conv
    assert m.unet.conv_pad_to == 128 and m.w8a8_min_size == 1 << 16
    assert "dynamic absmax" in quant_matmul.describe(False, 156)
