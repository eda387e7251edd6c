"""Top-k sampled text decode of the port (``text_temperature > 0``), on the
CPU at ``test_config()`` sizes.

Torch's random stream is not JAX's, so sampled tokens cannot equal the
reference's draw for draw: parity here is statistical. Held:
- ``top_k`` = 1 decodes greedy's tokens;
- every sampled token lies in its row's top-k of the logits at its step
  (the chain re-fed one step at a time);
- the same seed gives the same tokens, another seed others, graphed (the
  step through the ``EagerStep`` stand-in) or eager;
- ``sample_top_k``'s frequencies over 40,000 seeded draws pass a
  chi-square test against softmax(top-k logits / T) at significance
  1e-3, and a wrong temperature fails it (the control);
- the first sampled token of 2,048 rows of one prompt, drawn by the port
  and by the reference's ``greedy_decode`` on the same weights, each pass
  the same chi-square test against the same distribution;
- ``PromptGenerator`` samples when asked (no longer refused), with a
  seed that advances per call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sp_stats

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.ops.decode import greedy_decode as jax_greedy
from cassmantle_tpu.ops.decode import make_apply_pair
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.ops import decode as port_decode
from cassmantle_tpu_torch.ops.decode import (
    greedy_decode,
    gumbel_,
    sample_top_k,
)
from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

from _torch_port_common import EagerStep, jax_params, load

ALPHA = 1e-3
T, K = 0.8, 4


@pytest.fixture(scope="module")
def lm():
    jm = JGPT2(jax_test_config().models.gpt2)
    params = jax_params(jm, 101, jnp.zeros((1, 8), dtype=jnp.int32))
    port = load(GPT2LM(port_test_config().models.gpt2), params, "gpt2")
    rng = np.random.default_rng(102)
    ids = rng.integers(0, 256, (3, 16))
    lens = np.array([16, 11, 6])
    return dict(jm=jm, params=params, port=port, ids=torch.from_numpy(ids),
                lens=torch.from_numpy(lens))


def _decode(lm, temperature, top_k=K, seed=0, max_new=10, **kw):
    gen = torch.Generator().manual_seed(seed)
    with torch.inference_mode():
        return greedy_decode(lm["port"], lm["ids"], lm["lens"], max_new, 256,
                             temperature=temperature, top_k=top_k,
                             generator=gen, **kw)


def _chi_square_p(counts, probs):
    probs = np.asarray(probs, dtype=np.float64)
    return sp_stats.chisquare(counts, probs / probs.sum()
                              * counts.sum()).pvalue


def test_top_k_one_is_greedy(lm):
    greedy, _ = _decode(lm, 0.0)
    toks, _ = _decode(lm, 0.7, top_k=1)
    assert torch.equal(toks, greedy)


def test_sampled_tokens_lie_in_their_top_k(lm):
    """The chain re-fed one step at a time: each token is among the K
    largest logits of its step; with K = 4 over a vocabulary of 256 the
    chain is not greedy's (it samples)."""
    toks, _ = _decode(lm, T, max_new=12)
    greedy, _ = _decode(lm, 0.0, max_new=12)
    assert not torch.equal(toks, greedy)
    port, ids, lens = lm["port"], lm["ids"], lm["lens"]
    p, max_len = ids.shape[1], ids.shape[1] + 12
    pos = torch.arange(max_len)[None, :]
    with torch.inference_mode():
        logits, cache = port.prefill(ids, lens, max_len)
        for j in range(12):
            top = logits.topk(K, dim=-1).indices
            assert (top == toks[:, j:j + 1].long()).any(dim=1).all(), j
            valid = (pos < lens[:, None]) | ((pos >= p) & (pos <= p + j))
            logits, cache = port.decode_step(toks[:, j].long(), p + j, cache,
                                             valid)


def test_seeds_graphed_and_eager(lm, monkeypatch):
    """The same seed gives the same tokens, eager and through the kept
    state with :class:`EagerStep` as its graph (twice: the noise is drawn
    anew at each start); another seed gives other tokens."""
    monkeypatch.setattr(port_decode, "CapturedStep", EagerStep)
    eager, n = _decode(lm, T, seed=5)
    states = {}
    for _ in range(2):
        toks, m = _decode(lm, T, seed=5, graphs=states, graphed=True)
        assert torch.equal(toks, eager) and torch.equal(m, n)
    other, _ = _decode(lm, T, seed=6)
    assert not torch.equal(other, eager)
    (state,) = states.values()
    assert state.graph.replays == 2 * 9
    with pytest.raises(ValueError, match="Generator"):
        with torch.inference_mode():
            greedy_decode(lm["port"], lm["ids"], lm["lens"], 4, 256,
                          temperature=T)


def test_pick_frequencies_match_softmax():
    """``sample_top_k`` over 40,000 rows of one logits vector: the
    frequencies of the K candidates pass chi-square against
    softmax(top-k / T); the same counts fail against softmax at another
    temperature (control)."""
    n = 40_000
    logits = torch.tensor([1.0, 2.5, 0.3, 2.0, -1.0, 1.7, 0.0, 2.2])
    noise = gumbel_(torch.empty((n, K)), torch.Generator().manual_seed(7))
    picks = sample_top_k(logits.expand(n, -1), noise, torch.tensor(T))
    top = logits.topk(K)
    counts = np.array([(picks == i).sum().item() for i in top.indices])
    assert counts.sum() == n
    assert _chi_square_p(counts, torch.softmax(top.values / T, 0).numpy()) \
        > ALPHA
    assert _chi_square_p(counts, torch.softmax(top.values / 1.3, 0).numpy()) \
        < ALPHA


def test_first_token_distribution_matches_reference(lm):
    """2,048 rows of one prompt, one sampled token each, on the port and on
    the reference's sampled ``greedy_decode`` (same weights): both
    histograms over the prompt's top-K pass chi-square against
    softmax(top-K logits / T) at 1e-3."""
    rows = 2048
    ids = lm["ids"][:1].expand(rows, -1)
    lens = lm["lens"][:1].expand(rows)
    with torch.inference_mode():
        logits, _ = lm["port"].prefill(ids[:1], lens[:1], 16)
        port, _ = greedy_decode(lm["port"], ids, lens, 1, 256,
                                temperature=T, top_k=K,
                                generator=torch.Generator().manual_seed(3))
    ref, _ = jax_greedy(make_apply_pair(lm["jm"]), lm["params"],
                        jnp.asarray(ids.numpy()), jnp.asarray(lens.numpy()),
                        jax.random.PRNGKey(3), 1, 256, T, K)
    top = logits[0].topk(K)
    probs = torch.softmax(top.values / T, 0).numpy()
    for toks in (port.numpy()[:, 0], np.asarray(ref)[:, 0]):
        counts = np.array([(toks == i).sum() for i in top.indices.numpy()])
        assert counts.sum() == rows
        assert _chi_square_p(counts, probs) > ALPHA


def test_prompt_generator_samples_with_advancing_seed():
    """``text_temperature > 0`` is served: a call without a seed takes the
    next count of calls, so two calls sample differently and an explicit
    seed repeats a call."""
    cfg = port_test_config()
    cfg = cfg.replace(sampler=dataclasses.replace(
        cfg.sampler, text_temperature=0.9, text_top_k=8, max_new_tokens=12))
    gen = PromptGenerator(cfg, "cpu")
    seeds = ["The Night the Trains Sang", "Chapter two: the harbor"]
    first, _ = gen.decode_ids_batch(seeds)
    second, _ = gen.decode_ids_batch(seeds)
    assert not np.array_equal(first, second)
    again, _ = gen.decode_ids_batch(seeds, seed=0)
    np.testing.assert_array_equal(again, first)
