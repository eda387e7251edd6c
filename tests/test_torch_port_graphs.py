"""The port's compiled loops on the CPU: the device-resident DDIM step and
greedy decode step (the functions the CUDA graphs capture, run eagerly
here) against the reference's ``lax.scan`` loops, and the bookkeeping of
``ops/graphs.py::CapturedStep``.

At ``test_config()`` / ``test_sdxl_config()`` sizes, with reference
parameter trees and inputs made with numpy from a seed and fed to both
sides (``_torch_port_common``). Tolerances are the slice's: fp32 final
latents within 1e-4 of the reference's largest value, uint8 images within
2 levels (mean 0.5); greedy tokens and lengths exactly equal.

A CUDA graph cannot be captured here. Where a test runs a graphed path
(``SpecGraph``, ``greedy_decode(graphed=True)``), ``CapturedStep`` is
swapped for :class:`EagerStep`, which keeps every piece of it but the
graph: the warm-up runs the step once, the "capture" records nothing and
a replay calls the step. That holds the static-buffer logic (inputs
copied in, counters reset after the warm-up, a graph kept per key) to
the eager loop.
"""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.config import test_sdxl_config as jax_test_sdxl_config
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.ops.ddim import DDIMSchedule as JSchedule
from cassmantle_tpu.ops.ddim import ddim_sample as jax_ddim_sample
from cassmantle_tpu.ops.ddim import make_cfg_denoiser as jax_cfg_denoiser
from cassmantle_tpu.ops.decode import greedy_decode as jax_greedy
from cassmantle_tpu.ops.decode import make_apply_pair
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.config import (
    test_sdxl_config as port_test_sdxl_config,
)
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.vae import postprocess_images
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import ddim as port_ddim
from cassmantle_tpu_torch.ops import decode as port_decode
from cassmantle_tpu_torch.ops import flash_attention as fa
from cassmantle_tpu_torch.ops import fused_conv, graphs, quant_matmul
from cassmantle_tpu_torch.ops.ddim import (
    DDIMSchedule,
    cfg_denoiser,
    cfg_inputs,
    ddim_sample,
    ddim_spec,
    spec_step,
)
from cassmantle_tpu_torch.ops.decode import greedy_decode
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

from _torch_port_common import EagerStep, assert_rel, jax_params, load, randn

CTX_LEN = 16


# -- the DDIM step ------------------------------------------------------------

def _unet_case(which):
    """Reference UNet parameters, CFG conditioning (random CLIP-like
    states, and SDXL's addition embeds) and x_T, with the reference's
    final latents of the CFG DDIM scan."""
    sdxl = which == "sdxl"
    cfg = jax_test_sdxl_config() if sdxl else jax_test_config()
    m, s = cfg.models, cfg.sampler
    rng = np.random.default_rng(61 if sdxl else 62)
    hw = s.image_size // 2 ** (len(m.vae.channel_mults) - 1)
    x_t = randn(rng, 2, hw, hw, 4)
    ctx, uctx = (randn(rng, 2, CTX_LEN, m.unet.context_dim)
                 for _ in range(2))
    extra = ()
    cond = {"context": ctx, "uncond_context": uctx}
    if sdxl:
        cond["addition_embeds"] = randn(rng, 2, m.unet.addition_embed_dim)
        cond["uncond_addition_embeds"] = randn(
            rng, 2, m.unet.addition_embed_dim)
        extra = (jnp.zeros((2, m.unet.addition_embed_dim)),)
    unet = JUNet(m.unet)
    params = jax_params(unet, 63, jnp.asarray(x_t), jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, CTX_LEN, m.unet.context_dim)), *extra)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    denoise = jax_cfg_denoiser(unet.apply, params, guidance_scale=7.5,
                               **jcond)
    final = jax_ddim_sample(denoise, jnp.asarray(x_t),
                            JSchedule.create(s.num_steps))
    port_cfg = port_test_sdxl_config() if sdxl else port_test_config()
    port = load(UNet(port_cfg.models.unet), params,
                "unet_xl" if sdxl else "unet")
    return dict(cfg=cfg, port_cfg=port_cfg, params=params, x_t=x_t,
                cond={k: torch.from_numpy(v) for k, v in cond.items()},
                final=np.asarray(final), unet=port)


@pytest.fixture(scope="module", params=["sd15", "sdxl"])
def unet_case(request):
    return _unet_case(request.param)


def test_device_ddim_step_loop_matches_reference_scan(unet_case):
    """The step the graph captures (:func:`spec_step` over DDIM's spec:
    timestep and coefficients gathered at a device step counter,
    advanced in place), looped eagerly, lands on the reference's
    ``lax.scan`` (fp32; 1e-4 of the largest latent); the counter ends at
    T."""
    c = unet_case
    sched = DDIMSchedule.create(c["port_cfg"].sampler.num_steps)
    spec = ddim_spec(sched.coefficients("cpu"))
    denoise = cfg_denoiser(c["unet"], guidance_scale=7.5,
                           **cfg_inputs(**c["cond"]))
    step = torch.zeros((1,), dtype=torch.long)
    carry = (torch.from_numpy(c["x_t"]),)
    with torch.inference_mode():
        for _ in range(len(sched.timesteps)):
            carry = spec_step(spec, denoise, carry, step)
    assert int(step) == len(sched.timesteps)
    assert_rel(carry[0], c["final"], 1e-4)


def test_schedule_coefficients_are_the_reference_values():
    """Uploaded once: timesteps equal the reference's, and each step's
    (c_eps, c_x, c_x0, c_dir) are the fp32 square roots of its
    ᾱ_t / ᾱ_{t-1} bit for bit (numpy's fp32 sqrt is correctly rounded)."""
    sched = DDIMSchedule.create(50)
    ref = JSchedule.create(50)
    coeffs = sched.coefficients("cpu")
    np.testing.assert_array_equal(coeffs.timesteps.numpy(),
                                  np.asarray(ref.timesteps))
    a_t = np.asarray(ref.alpha_bars, dtype=np.float32)
    a_prev = np.asarray(ref.alpha_bars_prev, dtype=np.float32)
    one = np.float32(1.0)
    want = np.stack([np.sqrt(one - a_t), np.sqrt(a_t), np.sqrt(a_prev),
                     np.sqrt(np.maximum(one - a_prev, np.float32(0)))], 1)
    np.testing.assert_array_equal(coeffs.table.numpy(), want)
    assert coeffs.table.dtype == torch.float32
    assert coeffs.timesteps.dtype == torch.int32


def test_ddim_update_divides_like_the_reference():
    """The update divides by the device tensor c_x: on the CPU the same
    IEEE divide as a division by the host value, bit for bit."""
    rng = np.random.default_rng(64)
    x, eps = (torch.from_numpy(randn(rng, 2, 8, 8, 4)) for _ in range(2))
    c = [torch.tensor(v, dtype=torch.float32)
         for v in (0.3, 0.7, 0.9, 0.2)]
    out = port_ddim.ddim_update(x, eps, *c)
    c_eps, c_x, c_x0, c_dir = (float(v) for v in c)
    want = c_x0 * ((x - c_eps * eps) / c_x) + c_dir * eps
    assert torch.equal(out, want)


def test_graphed_sampler_matches_eager_and_reference(unet_case,
                                                     monkeypatch):
    """``SpecGraph`` over DDIM (static x_T, conditioning and counter, one
    step replayed T times; :class:`EagerStep` in place of the graph) equals
    :func:`ddim_sample` bit for bit, also on a second call with other
    inputs after the warm-up moved its buffers, and the reference within
    1e-4."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    c = unet_case
    sched = DDIMSchedule.create(c["port_cfg"].sampler.num_steps)
    make = lambda **kw: cfg_denoiser(c["unet"], guidance_scale=7.5, **kw)
    inputs = cfg_inputs(**c["cond"])
    x_t = torch.from_numpy(c["x_t"])
    with torch.inference_mode():
        graph = port_ddim.SpecGraph(make, sched, x_t, **inputs)
        got = graph(x_t, **inputs)
        eager = ddim_sample(make(**inputs), x_t, sched)
        assert torch.equal(got, eager)
        assert graph.graph.replays == len(sched.timesteps)
        other = {k: None if v is None else v.flip(0)
                 for k, v in inputs.items()}
        got2 = graph(x_t * 0.5, **other)
        eager2 = ddim_sample(make(**other), x_t * 0.5, sched)
    assert torch.equal(got2, eager2)
    assert not torch.equal(got2, got)
    assert_rel(got, c["final"], 1e-4)


def test_pipeline_graphed_denoise_and_image(monkeypatch):
    """``Text2ImagePipeline.denoise``, graphed (one step graph per batch
    size, kept and reused; :class:`EagerStep` for the graph) and eager,
    on the reference's x_T and conditioning: equal latents, within 1e-4
    of the reference's scan, and its VAE image within 2 levels of the
    reference's (mean 0.5)."""
    monkeypatch.setattr(port_ddim, "CapturedStep", EagerStep)
    c = _unet_case("sd15")
    m = c["cfg"].models
    vae_params = jax_params(JVAE(m.vae), 65, jnp.asarray(c["final"]))
    ref_img = np.asarray(jax_postprocess(
        JVAE(m.vae).apply(vae_params, jnp.asarray(c["final"]))))
    pipe = Text2ImagePipeline(c["port_cfg"], device="cpu", state_dicts={
        "unet": c["unet"].state_dict(),
        "vae": from_jax("vae", vae_params)})
    x_t = torch.from_numpy(c["x_t"])
    with torch.inference_mode():
        eager = pipe.denoise(x_t, c["cond"], graphed=False)
        got = pipe.denoise(x_t, c["cond"], graphed=True)
        again = pipe.denoise(x_t, c["cond"], graphed=True)
        img = postprocess_images(pipe.vae(got)).numpy()
    assert list(pipe.full_variant.step_graphs) == [2]
    assert pipe.full_variant.step_graphs[2].graph.replays == 2 * len(
        pipe.full_variant.schedule.timesteps)
    assert torch.equal(got, eager) and torch.equal(again, eager)
    assert_rel(got, c["final"], 1e-4)
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32))
    assert diff.max() <= 2 and diff.mean() <= 0.5


# -- the decode step ----------------------------------------------------------

@pytest.fixture(scope="module")
def gpt2_case():
    jm = jax_test_config().models.gpt2
    rng = np.random.default_rng(67)
    ids = rng.integers(0, jm.vocab_size, (2, 32)).astype(np.int32)
    model = JGPT2(jm)
    params = jax_params(model, 68, jnp.asarray(ids))
    port = load(GPT2LM(port_test_config().models.gpt2), params, "gpt2")
    return dict(jm=jm, ids=ids, model=model, params=params, port=port)


def _jax_greedy(case, ids, lens, max_new, eos):
    toks, n = jax_greedy(make_apply_pair(case["model"]), case["params"],
                         jnp.asarray(ids), jnp.asarray(lens),
                         jax.random.PRNGKey(0), max_new, eos, 0.0, 40)
    return np.asarray(toks), np.asarray(n)


@pytest.mark.parametrize("bucket", [16, 32])
@pytest.mark.parametrize("eos_mode", ["unreachable", "early_stop"])
def test_device_index_greedy_decode_matches_reference(gpt2_case, bucket,
                                                      eos_mode, monkeypatch):
    """The device-index greedy decode (valid mask, position and token
    column from the device step counter) against the reference's
    ``greedy_decode`` at two prompt buckets, with an EOS the model never
    emits and with one it does: tokens and lengths exactly equal. Run
    eagerly and through the kept state with :class:`EagerStep` as its
    graph, twice (the state resets between calls)."""
    monkeypatch.setattr(port_decode, "CapturedStep", EagerStep)
    c = gpt2_case
    ids = c["ids"][:, :bucket]
    lens = np.array([bucket, bucket // 2 + 3], dtype=np.int32)
    eos = c["jm"].vocab_size
    ref_toks, ref_len = _jax_greedy(c, ids, lens, 8, eos)
    if eos_mode == "early_stop":
        eos = int(ref_toks[0, 3])
        ref_toks, ref_len = _jax_greedy(c, ids, lens, 8, eos)
        assert ref_len[0] <= 3
    args = (c["port"], torch.from_numpy(ids).long(),
            torch.from_numpy(lens).long(), 8, eos)
    states = {}
    with torch.inference_mode():
        runs = [greedy_decode(*args),
                greedy_decode(*args, graphs=states, graphed=True),
                greedy_decode(*args, graphs=states, graphed=True)]
    for toks, n in runs:
        np.testing.assert_array_equal(toks.numpy(), ref_toks)
        np.testing.assert_array_equal(n.numpy(), ref_len)
    (state,) = states.values()
    assert state.graph.replays == 2 * 7


def test_decode_step_device_index_matches_int_index(gpt2_case):
    """``decode_step`` at a device index (position embedding and cache
    write at a one-element int64 tensor) equals the Python-int form bit
    for bit: logits and both caches."""
    c = gpt2_case
    port = c["port"]
    ids = torch.from_numpy(c["ids"][:, :12]).long()
    plen = torch.tensor([12, 7])
    tok = torch.tensor([3, 200])
    valid = torch.arange(16)[None, :] < plen[:, None]
    valid[:, 12] = True
    outs = []
    with torch.inference_mode():
        for index in (12, torch.tensor([12])):
            _, cache = port.prefill(ids, plen, 16)
            logits, cache = port.decode_step(tok, index, cache, valid)
            outs.append((logits, cache))
    (l_int, c_int), (l_dev, c_dev) = outs
    assert torch.equal(l_int, l_dev)
    for (ki, vi), (kd, vd) in zip(c_int, c_dev):
        assert torch.equal(ki, kd) and torch.equal(vi, vd)


def test_prefill_into_a_given_cache(gpt2_case):
    """Prefill writes a given cache in place (a decode graph reads that
    buffer) and zeroes it past the prompt, equal to a fresh one."""
    port = gpt2_case["port"]
    ids = torch.from_numpy(gpt2_case["ids"][:, :12]).long()
    plen = torch.tensor([12, 7])
    cache = port.new_cache(2, 16)
    for k, v in cache:
        k.fill_(7.0)
        v.fill_(7.0)
    with torch.inference_mode():
        l_new, fresh = port.prefill(ids, plen, 16)
        l_in, kept = port.prefill(ids, plen, 16, cache)
    assert kept is cache and torch.equal(l_new, l_in)
    for (kf, vf), (kk, vk) in zip(fresh, kept):
        assert torch.equal(kf, kk) and torch.equal(vf, vk)


# -- CapturedStep's launch tallies -------------------------------------------

FLASH_SHAPE = (2, 64, 64, 8, 40)
CONV_SHAPE = (2, 8, 8, 320, 320)


def _fake_launches():
    """What one step of a stub model counts: two flash launches, one
    fused conv, three int8 matmuls."""
    f = fa.flash_attention
    f.launches += 2
    f.shapes[FLASH_SHAPE] += 2
    f.paths["wgmma"] += 2
    f.shape_paths[FLASH_SHAPE, "wgmma"] += 2
    fused_conv.gn_silu_conv3x3.launches += 1
    fused_conv.gn_silu_conv3x3.shapes[CONV_SHAPE] += 1
    quant_matmul.int8_matmul.launches += 3
    quant_matmul.int8_matmul.shapes[(128, 320, 960)] += 3


def _reset():
    fa.reset_counters()
    fused_conv.reset_counters()
    quant_matmul.reset_counters()


def test_captured_step_tally_counts_replays_not_warmup():
    """On a stub graph: the capture's tally (what the step counted once)
    is added on each replay, the warm-up's and the capture's counts are
    taken off, counts made before the capture stay, and
    ``reset_counters`` clears the counters as before."""
    _reset()
    fa.flash_attention.launches = 5
    fa.flash_attention.shapes[(1, 4096, 4096, 1, 512)] = 5
    step = EagerStep(_fake_launches)
    assert fa.flash_attention.launches == 5
    assert fa.flash_attention.shapes == {(1, 4096, 4096, 1, 512): 5}
    assert fused_conv.gn_silu_conv3x3.launches == 0
    assert dict(fused_conv.gn_silu_conv3x3.shapes) == {}
    assert dict(quant_matmul.int8_matmul.shapes) == {}
    step.graph = types.SimpleNamespace(replay=lambda: None)   # no Python
    for _ in range(3):
        step.replay()
    f = fa.flash_attention
    assert f.launches == 5 + 6
    assert dict(f.shapes) == {(1, 4096, 4096, 1, 512): 5, FLASH_SHAPE: 6}
    assert dict(f.paths) == {"wgmma": 6}
    assert dict(f.shape_paths) == {(FLASH_SHAPE, "wgmma"): 6}
    assert fused_conv.gn_silu_conv3x3.launches == 3
    assert dict(fused_conv.gn_silu_conv3x3.shapes) == {CONV_SHAPE: 3}
    assert quant_matmul.int8_matmul.launches == 9
    assert dict(quant_matmul.int8_matmul.shapes) == {(128, 320, 960): 9}
    assert quant_matmul.int8_conv3x3.launches == 0
    _reset()
    assert f.launches == 0 and not f.shapes and not f.shape_paths
    assert fused_conv.gn_silu_conv3x3.launches == 0
    assert quant_matmul.int8_matmul.launches == 0
    assert not quant_matmul.int8_matmul.shapes


def test_captured_step_failure_raises_and_restores_counters():
    """A capture that raises propagates its error (no eager fallback),
    and the counters are as they were before it."""

    class Failing(EagerStep):
        def _capture(self):
            self.fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    _reset()
    before = graphs.snapshot()
    with pytest.raises(RuntimeError, match="capturing"):
        Failing(_fake_launches)
    assert graphs.snapshot() == before
    _reset()


def test_tally_difference_and_add_drop_zero_keys():
    """``difference`` keeps only changed keys; ``add`` with -1 undoes
    ``add`` and drops keys that reach 0 (so a round's per-shape dict
    compares equal to its expectation)."""
    _reset()
    before = graphs.snapshot()
    _fake_launches()
    delta = graphs.difference(graphs.snapshot(), before)
    assert delta[fa.flash_attention, "shapes"] == collections.Counter(
        {FLASH_SHAPE: 2})
    assert delta[quant_matmul.int8_conv3x3, "launches"] == 0
    graphs.add(delta, -1)
    assert graphs.snapshot() == before
    assert FLASH_SHAPE not in fa.flash_attention.shapes
    _reset()
