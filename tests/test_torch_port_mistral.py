"""Mistral-7B-class prompt LM of the port against the reference, on the CPU
at ``MistralConfig.tiny()`` (2 layers, 4 query and 2 KV heads of 16, a
sliding window of 16 positions, shorter than the sequences here).

The reference's parameter tree is filled with seeded numpy values and
carried across with ``from_jax("mistral", ...)``; the same numpy inputs
feed both sides. Tolerances: the building blocks (RoPE tables and
rotation, RMSNorm) within 1e-6 of the largest reference value, masks and
head repetition exactly; ``forward``, ``prefill``, ``decode_step`` and
``decode_chunk`` in fp32 within 1e-4 relative (logits and caches);
greedy tokens and lengths exactly equal. Each comparison has a control
that shows it can fail: a perturbed weight, or weights from another seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models import layers as jax_layers
from cassmantle_tpu.models import mistral as jax_mistral
from cassmantle_tpu.ops.decode import greedy_decode as jax_greedy
from cassmantle_tpu.ops.decode import make_apply_fns
from cassmantle_tpu.serving import pipeline as jax_pipeline
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models import mistral as port_mistral
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.layers import chunk_causal_mask
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops.decode import greedy_decode
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    build_model,
    build_streamed,
)

from _torch_port_common import assert_rel, jax_params, load, randn

TINY = jax_config.MistralConfig.tiny()
P, MAX_LEN = 24, 40           # the prompt is longer than the window (16)


def _assert_rel_fails(port, ref, tol):
    with pytest.raises(AssertionError):
        assert_rel(port, ref, tol)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(81)
    ids = rng.integers(0, TINY.vocab_size, (2, P)).astype(np.int32)
    lens = np.array([P, 13], dtype=np.int32)
    model = jax_mistral.MistralLM(TINY)
    params = jax_params(model, 82, jnp.asarray(ids))
    port = load(MistralLM(port_config.MistralConfig.tiny()), params,
                "mistral")
    return dict(ids=ids, lens=lens, model=model, params=params, port=port)


def _perturbed(port):
    """A copy of ``port`` with one attention weight moved: the control."""
    other = MistralLM(port.cfg)
    other.load_state_dict(port.state_dict())
    with torch.no_grad():
        other.block_0.attn.q.weight.mul_(1.5)
    return other.eval()


# -- configuration and tokenizer ----------------------------------------------

def test_configs_match_reference():
    """MistralConfig (7B and tiny), SpecDecodeConfig and the
    spec_decode_serving_config preset: every field the port keeps equals
    the reference's."""
    for port, ref in (
            (port_config.MistralConfig(), jax_config.MistralConfig()),
            (port_config.MistralConfig.tiny(), TINY),
            (port_config.SpecDecodeConfig(), jax_config.SpecDecodeConfig()),
            (port_config.spec_decode_serving_config().spec_decode,
             jax_config.spec_decode_serving_config().spec_decode),
            (port_config.SamplerConfig(), jax_config.SamplerConfig())):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


# -- building blocks ----------------------------------------------------------

@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1e6)])
def test_rope_tables_and_rotation_match_reference(head_dim, theta):
    """cos/sin tables and the split-half rotation, fp32, at positions up
    to 4095 (the 7B window)."""
    pos = np.array([0, 1, 7, 63, 1000, 4095], dtype=np.int32)
    cos, sin = port_mistral.rope_tables(torch.from_numpy(pos).long(),
                                        head_dim, theta)
    rcos, rsin = jax_mistral.rope_tables(jnp.asarray(pos), head_dim, theta)
    assert_rel(cos, np.asarray(rcos), 1e-6)
    assert_rel(sin, np.asarray(rsin), 1e-6)
    x = randn(np.random.default_rng(3), 2, len(pos), 4, head_dim)
    got = port_mistral.apply_rope(torch.from_numpy(x), cos, sin)
    want = np.asarray(jax_mistral.apply_rope(jnp.asarray(x), rcos, rsin))
    assert_rel(got, want, 1e-6)
    # control: the interleaved (GPT-J) convention is another rotation
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = np.asarray(rcos)[:, None, :], np.asarray(rsin)[:, None, :]
    interleaved = np.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           -1).reshape(x.shape)
    _assert_rel_fails(got, interleaved, 1e-6)


def test_band_mask_and_chunk_mask_match_reference():
    """The sliding band and the decode chunk's mask, with and without a
    window, at an int and at a device-tensor index: exactly equal."""
    q, k = np.arange(5, 30), np.arange(40)
    np.testing.assert_array_equal(
        port_mistral.band_mask(torch.from_numpy(q), torch.from_numpy(k),
                               16).numpy(),
        np.asarray(jax_mistral.band_mask(jnp.asarray(q), jnp.asarray(k), 16)))
    rng = np.random.default_rng(4)
    valid = rng.random((3, MAX_LEN)) < 0.7
    for window in (None, 16):
        want = np.asarray(jax_layers.chunk_causal_mask(
            jnp.asarray(valid), jnp.int32(20), 5, window=window))
        for index in (20, torch.tensor([20])):
            got = chunk_causal_mask(torch.from_numpy(valid), index, 5,
                                    window=window)
            assert got.shape == (3, 1, 5, MAX_LEN)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv_matches_reference(n_rep):
    kv = randn(np.random.default_rng(5), 2, 6, 2, 16)
    got = port_mistral.repeat_kv(torch.from_numpy(kv), n_rep)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_mistral.repeat_kv(jnp.asarray(kv),
                                                       n_rep)))


def test_rmsnorm_matches_reference():
    x = randn(np.random.default_rng(6), 2, 5, 64) * 3.0
    ref = jax_mistral.RMSNorm(1e-5)
    params = jax_params(ref, 7, jnp.asarray(x))
    port = load(port_mistral.RMSNorm(64, 1e-5), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_rel(got, np.asarray(ref.apply(params, jnp.asarray(x))), 1e-6)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
def test_forward_matches_reference(case, with_valid):
    """The plain forward over 24 positions (window 16), with and without
    a validity mask; control: one weight perturbed."""
    ids = case["ids"]
    valid = np.arange(P)[None, :] < case["lens"][:, None]
    ref_args = (jnp.asarray(ids),) + ((jnp.asarray(valid),)
                                      if with_valid else ())
    ref = np.asarray(case["model"].apply(case["params"], *ref_args))
    args = (torch.from_numpy(ids).long(),) + ((torch.from_numpy(valid),)
                                              if with_valid else ())
    with torch.no_grad():
        got = case["port"](*args)
        bad = _perturbed(case["port"])(*args)
    assert_rel(got, ref, 1e-4)
    _assert_rel_fails(bad, ref, 1e-4)


def _ref_prefill(case):
    return case["model"].apply(
        case["params"], jnp.asarray(case["ids"]), jnp.asarray(case["lens"]),
        MAX_LEN, method=jax_mistral.MistralLM.prefill)


def _valid_through(lens, last):
    pos = np.arange(MAX_LEN)[None, :]
    return (pos < lens[:, None]) | ((pos >= P) & (pos <= last))


def test_prefill_matches_reference(case):
    """Last-token logits and every layer's RoPE'd k and v caches."""
    ref_last, ref_cache = _ref_prefill(case)
    with torch.no_grad():
        last, cache = case["port"].prefill(
            torch.from_numpy(case["ids"]).long(),
            torch.from_numpy(case["lens"]).long(), MAX_LEN)
    assert_rel(last, np.asarray(ref_last), 1e-4)
    for (k, v), (rk, rv) in zip(cache, ref_cache):
        assert_rel(k, np.asarray(rk), 1e-4)
        assert_rel(v, np.asarray(rv), 1e-4)


@pytest.mark.parametrize("device_index", [False, True])
def test_decode_step_and_chunk_match_reference(case, device_index):
    """Three decode steps, then a 5-token chunk, after the prefill: logits
    and caches against the reference's ``decode_step``/``decode_chunk`` at
    the same positions; the index as an int and as a device tensor."""
    model, params = case["model"], case["params"]
    lens = case["lens"]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, TINY.vocab_size, (2, 8)).astype(np.int32)
    _, ref_cache = _ref_prefill(case)
    port = case["port"]
    with torch.no_grad():
        _, cache = port.prefill(torch.from_numpy(case["ids"]).long(),
                                torch.from_numpy(lens).long(), MAX_LEN)
        for j in range(3):
            idx = P + j
            valid = _valid_through(lens, idx)
            ref_logits, ref_cache = model.apply(
                params, jnp.asarray(toks[:, j]), jnp.int32(idx), ref_cache,
                jnp.asarray(valid), method=jax_mistral.MistralLM.decode_step)
            index = torch.tensor([idx]) if device_index else idx
            logits, cache = port.decode_step(
                torch.from_numpy(toks[:, j]).long(), index, cache,
                torch.from_numpy(valid))
            assert_rel(logits, np.asarray(ref_logits), 1e-4)
        idx = P + 3
        valid = _valid_through(lens, idx + 4)
        ref_logits, ref_cache = model.apply(
            params, jnp.asarray(toks[:, 3:]), jnp.int32(idx), ref_cache,
            jnp.asarray(valid), method=jax_mistral.MistralLM.decode_chunk)
        index = torch.tensor([idx]) if device_index else idx
        logits, cache = port.decode_chunk(
            torch.from_numpy(toks[:, 3:]).long(), index, cache,
            torch.from_numpy(valid))
    assert logits.shape == (2, 5, TINY.vocab_size)
    assert_rel(logits, np.asarray(ref_logits), 1e-4)
    for (k, v), (rk, rv) in zip(cache, ref_cache):
        assert_rel(k, np.asarray(rk), 1e-4)
        assert_rel(v, np.asarray(rv), 1e-4)


def _jax_greedy(case, ids, lens, max_new, eos):
    toks, n = jax_greedy(make_apply_fns(case["model"])[:2], case["params"],
                         jnp.asarray(ids), jnp.asarray(lens),
                         jax.random.PRNGKey(0), max_new, eos, 0.0, 40)
    return np.asarray(toks), np.asarray(n)


@pytest.mark.parametrize("bucket", [16, 24])
def test_greedy_decode_matches_reference(case, bucket):
    """Greedy tokens and lengths at two prompt buckets, with an EOS the
    model emits mid-way in one row; control: a perturbed model's tokens
    differ."""
    ids = case["ids"][:, :bucket]
    lens = np.array([bucket, bucket // 2 + 1], dtype=np.int32)
    ref_toks, _ = _jax_greedy(case, ids, lens, 10, TINY.vocab_size)
    eos = int(ref_toks[0, 5])
    ref_toks, ref_len = _jax_greedy(case, ids, lens, 10, eos)
    assert ref_len[0] <= 5
    args = (torch.from_numpy(ids).long(), torch.from_numpy(lens).long(),
            10, eos)
    with torch.inference_mode():
        toks, n = greedy_decode(case["port"], *args)
        bad, _ = greedy_decode(_perturbed(case["port"]), *args)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(n.numpy(), ref_len)
    assert not np.array_equal(bad.numpy(), ref_toks)


# -- serving ------------------------------------------------------------------

def _mistral_cfg(module):
    cfg = module.test_config()
    return cfg.replace(models=dataclasses.replace(
        cfg.models, mistral=module.MistralConfig.tiny()))


@pytest.fixture(scope="module")
def ref_gen():
    gen = jax_pipeline.PromptGenerator(_mistral_cfg(jax_config))
    return gen, from_jax("mistral", jax.device_get(gen.params))


SEEDS = ["The Night the Trains Sang", "Chapter two: the harbor",
         "a" * 40, "b c d b c d b c d"]


def test_prompt_generator_mistral_matches_reference(ref_gen):
    """PromptGenerator with the Mistral branch (byte tokenizer, EOS past
    the tiny vocab as the unreachable sentinel, pad id modulo the vocab,
    rows over two prompt buckets) on the reference's own weights: tokens,
    lengths and the two-sentence text equal; control: the port's own
    seeded weights give other tokens."""
    ref, sd = ref_gen
    cfg = _mistral_cfg(port_config)
    port = PromptGenerator(cfg, "cpu", sd)
    assert isinstance(port.model, MistralLM)
    toks, lens = port.decode_ids_batch(SEEDS)
    ref_toks, ref_lens = ref.decode_ids_batch(SEEDS)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    assert port.generate(SEEDS[1]) == ref.generate(SEEDS[1])
    own, _ = PromptGenerator(cfg, "cpu").decode_ids_batch(SEEDS)
    assert not np.array_equal(own, np.asarray(ref_toks))


@pytest.mark.parametrize("flag", ["lm_w8a8"])
def test_mistral_refuses_int8(flag):
    """W8A8 is not served for Mistral: the reference's projections are
    plain Dense layers, with no int8 site. (Weights-only int8 is:
    tests/test_torch_port_int8.py.)"""
    cfg = _mistral_cfg(port_config)
    cfg = cfg.replace(models=dataclasses.replace(cfg.models, **{flag: True}))
    with pytest.raises(NotImplementedError, match=flag):
        PromptGenerator(cfg, "cpu")


def test_streamed_build_equals_build_model():
    """``build_streamed`` (meta device, then submodule by submodule) fills
    a model with the same seeded values as ``build_model`` and casts the
    same way; from a state dict it loads every tensor and refuses keys
    the model does not have."""
    gcfg = port_config.test_config().models.gpt2
    dev = torch.device("cpu")
    plain = build_model(GPT2LM(gcfg), "gpt2", dev, 3,
                        storage_dtype=torch.bfloat16)
    streamed = build_streamed(lambda: GPT2LM(gcfg), "gpt2", dev, 3,
                              storage_dtype=torch.bfloat16)
    sd_p, sd_s = plain.state_dict(), streamed.state_dict()
    assert sd_p.keys() == sd_s.keys()
    assert all(torch.equal(sd_p[k], sd_s[k]) for k in sd_p)
    assert all(t.dtype == torch.bfloat16 for t in sd_s.values())
    loaded = build_streamed(lambda: GPT2LM(gcfg), "gpt2", dev, 0, sd_p)
    assert all(torch.equal(sd_p[k].float(), v)
               for k, v in loaded.state_dict().items())
    with pytest.raises(ValueError, match="unexpected"):
        build_streamed(lambda: GPT2LM(gcfg), "gpt2", dev, 0,
                       {**sd_p, "extra.weight": torch.zeros(1)})
