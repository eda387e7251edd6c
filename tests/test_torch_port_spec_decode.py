"""Speculative decode of the port against the reference, on the CPU at
``test_config()`` sizes (GPT-2, 2 layers of 64) and ``MistralConfig.tiny()``.

What is held, and how closely:
- ``decode_chunk`` of GPT-2 and Mistral against the same tokens fed one
  ``decode_step`` at a time (logits and caches within 1e-5 of the largest
  value) and against the reference's ``decode_chunk`` (1e-4);
- ``ngram_propose`` exactly equal to the reference's ``_ngram_propose`` on
  seeded contexts;
- ``speculative_decode`` with the n-gram draft and with a model draft:
  tokens, lengths and stats [chunks, drafted, accepted] exactly equal to
  the reference's ``speculative_decode``, and tokens and lengths equal to
  greedy decode; the edge cases of a midstream EOS, EOS at the first
  position, a budget below gamma and the self-draft's full acceptance;
- the chunk body through a stand-in graph (``EagerStep``) against the
  eager body, twice (the capture puts the state back);
- ``PromptGenerator``'s spec path against the reference's at two buckets
  with both drafts and with Mistral, its kill switch, temperature and
  scratch-room fallbacks.

All in fp32, where the verify forward's (B, gamma + 1)-row products and
greedy's (B, 1)-row products round alike enough that no argmax here sits
at a near tie: a case that parts reports the two logits' gap. Controls: a
perturbed target's tokens and stats differ from the reference's, and an
n-gram proposal off by one known token differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models.gpt2 import GPT2LM as JGPT2
from cassmantle_tpu.models.mistral import MistralLM as JMistral
from cassmantle_tpu.ops import decode as jax_decode
from cassmantle_tpu.serving import pipeline as jax_pipeline
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import decode as port_decode
from cassmantle_tpu_torch.ops.decode import (
    ModelDraft,
    NgramDraft,
    greedy_decode,
    ngram_propose,
    speculative_decode,
)
from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

from _torch_port_common import EagerStep, assert_rel, jax_params, load

SMALL_DRAFT = dict(vocab_size=256, hidden_size=32, num_layers=1,
                   num_heads=2, max_positions=128, dtype="float32")


def _lm(jax_module, port_module, seed):
    ids = jnp.zeros((1, 8), dtype=jnp.int32)
    params = jax_params(jax_module, seed, ids)
    return dict(model=jax_module, params=params,
                fns=jax_decode.make_apply_fns(jax_module),
                port=load(port_module, params))


@pytest.fixture(scope="module")
def gpt2():
    cfg = jax_config.test_config().models.gpt2
    return _lm(JGPT2(cfg), GPT2LM(port_config.test_config().models.gpt2), 91)


@pytest.fixture(scope="module")
def small_draft():
    return _lm(JGPT2(jax_config.GPT2Config(**SMALL_DRAFT)),
               GPT2LM(port_config.GPT2Config(**SMALL_DRAFT)), 92)


def _prompt(b, p, vocab, seed=3):
    """Right-padded (B, P) prompt bucket with per-row lengths (the
    reference tests' prompts)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(b, p)).astype(np.int32)
    lens = np.linspace(max(2, p // 2), p, num=b).astype(np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    return ids, lens


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


# -- decode_chunk --------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_decode_chunk_matches_step_sequence_and_reference(gpt2, family):
    """S tokens in one ``decode_chunk`` against the same tokens one
    ``decode_step`` at a time, and against the reference's chunk; the
    Mistral prompt (24) outruns its window (16), so early positions drop
    out of later queries' bands."""
    if family == "gpt2":
        lm, p, s, max_len, vocab = gpt2, 8, 5, 24, 256
    else:
        cfg = jax_config.MistralConfig.tiny()
        lm = _lm(JMistral(cfg), MistralLM(port_config.MistralConfig.tiny()),
                 93)
        p, s, max_len, vocab = 24, 6, 40, cfg.vocab_size
    ids, lens = _prompt(2, p, vocab, seed=7)
    toks = np.random.RandomState(9).randint(0, vocab, (2, s))
    pos = np.arange(max_len)[None, :]
    prompt_valid = pos < lens[:, None]
    port = lm["port"]
    with torch.no_grad():
        _, cache = port.prefill(_t(ids), _t(lens), max_len)
        stepped = []
        for j in range(s):
            valid = prompt_valid | ((pos >= p) & (pos <= p + j))
            logits, cache = port.decode_step(_t(toks[:, j]),
                                             torch.tensor([p + j]), cache,
                                             torch.from_numpy(valid))
            stepped.append(logits)
        _, cache_c = port.prefill(_t(ids), _t(lens), max_len)
        valid = prompt_valid | ((pos >= p) & (pos <= p + s - 1))
        chunked, cache_c = port.decode_chunk(_t(toks), torch.tensor([p]),
                                             cache_c, torch.from_numpy(valid))
    assert_rel(chunked, torch.stack(stepped, dim=1), 1e-5)
    for (ck, cv), (sk, sv) in zip(cache_c, cache):
        assert_rel(ck, sk, 1e-5)
        assert_rel(cv, sv, 1e-5)
    _, ref_cache = lm["fns"][0](lm["params"], jnp.asarray(ids),
                                jnp.asarray(lens), max_len)
    ref, _ = lm["fns"][2](lm["params"], jnp.asarray(toks, jnp.int32),
                          jnp.int32(p), ref_cache, jnp.asarray(valid))
    assert_rel(chunked, np.asarray(ref), 1e-4)


# -- the n-gram draft ----------------------------------------------------------

@pytest.mark.parametrize("k,gamma", [(2, 3), (3, 4)])
def test_ngram_propose_matches_reference(k, gamma):
    """Proposals on seeded contexts over a 4-token alphabet (so matches
    occur, and misses too), at every count of known tokens: exactly the
    reference's; control: one known token fewer proposes otherwise
    somewhere."""
    differs = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        b, p, length = 3, 16, 40
        ctx = rng.integers(0, 4, (b, length)).astype(np.int32)
        lens = np.array([16, 9, 4], dtype=np.int32)
        for n_gen in (1, 5, 12, length - p):
            want = np.asarray(jax_decode._ngram_propose(
                jnp.asarray(ctx), jnp.asarray(lens), p, jnp.int32(n_gen),
                gamma, k))
            args = (torch.from_numpy(ctx), _t(lens), p)
            for n in (n_gen, torch.tensor([n_gen])):
                got = ngram_propose(*args, n, gamma, k)
                np.testing.assert_array_equal(got.numpy(), want)
            off = ngram_propose(*args, n_gen - 1, gamma, k).numpy()
            differs += not np.array_equal(off, want)
    assert differs > 0


# -- speculative_decode against the reference --------------------------------

def _ref_spec(lm, ids, lens, max_new, eos, gamma, draft, draft_params=None):
    toks, n, stats = jax_decode.speculative_decode(
        lm["fns"], lm["params"], jnp.asarray(ids), jnp.asarray(lens),
        max_new, eos, gamma, draft, draft_params)
    return np.asarray(toks), np.asarray(n), np.asarray(stats)


def _drafts(kind, gpt2, small_draft):
    """(reference draft, its params, port draft)."""
    if kind == "ngram":
        return jax_decode.NgramDraft(ngram=2), None, NgramDraft(ngram=2)
    if kind == "self":
        return (jax_decode.ModelDraft(*gpt2["fns"][:2]), gpt2["params"],
                ModelDraft(gpt2["port"]))
    return (jax_decode.ModelDraft(*small_draft["fns"][:2]),
            small_draft["params"], ModelDraft(small_draft["port"]))


def _check_spec(gpt2, small_draft, kind, b, p, max_new, eos, gamma=3):
    """Port spec decode against the reference's (tokens, lengths, stats)
    and against the port's greedy decode; returns the port's stats."""
    ids, lens = _prompt(b, p, 256)
    ref_draft, ref_dparams, draft = _drafts(kind, gpt2, small_draft)
    ref = _ref_spec(gpt2, ids, lens, max_new, eos, gamma, ref_draft,
                    ref_dparams)
    with torch.inference_mode():
        greedy_t, greedy_n = greedy_decode(gpt2["port"], _t(ids), _t(lens),
                                           max_new, eos)
        toks, n, stats = speculative_decode(gpt2["port"], _t(ids), _t(lens),
                                            max_new, eos, gamma, draft)
    if not np.array_equal(toks.numpy(), greedy_t.numpy()):
        pytest.fail("spec decode parts from greedy: " + _gap_report(
            gpt2["port"], ids, lens, greedy_t, toks))
    np.testing.assert_array_equal(n.numpy(), greedy_n.numpy())
    np.testing.assert_array_equal(toks.numpy(), ref[0])
    np.testing.assert_array_equal(n.numpy(), ref[1])
    np.testing.assert_array_equal(stats.numpy(), ref[2])
    return stats.numpy()


def _gap_report(port, ids, lens, greedy_t, toks):
    """Where two decodes part: the row and step, and the greedy chain's
    top-2 logit gap there (its tokens fed one step at a time)."""
    row, col = np.argwhere(greedy_t.numpy() != toks.numpy())[0]
    p = ids.shape[1]
    max_len = p + greedy_t.shape[1]
    pos = torch.arange(max_len)[None, :]
    with torch.inference_mode():
        logits, cache = port.prefill(_t(ids), _t(lens), max_len)
        for j in range(col):
            valid = (pos < _t(lens)[:, None]) | ((pos >= p) & (pos <= p + j))
            logits, cache = port.decode_step(greedy_t[:, j].long(), p + j,
                                             cache, valid)
    top2 = logits[row].topk(2).values
    return (f"row {row}, step {col}: greedy's top-2 gap "
            f"{float(top2[0] - top2[1]):.3g}")


@pytest.mark.parametrize("shape", [(1, 16), (3, 32)])
@pytest.mark.parametrize("kind", ["ngram", "draft_model"])
def test_spec_decode_matches_reference(gpt2, small_draft, kind, shape):
    """Both drafts at two (B, P) shapes, EOS unreachable: every chunk
    commits 1 + accepted tokens, so chunks + accepted = max_new."""
    stats = _check_spec(gpt2, small_draft, kind, *shape, 8, 256)
    chunks, drafted, accepted = stats.tolist()
    assert drafted == 3 * chunks and chunks + accepted == 8


def test_spec_decode_edge_cases(gpt2, small_draft):
    """A midstream EOS at other steps per row (finished rows never hold
    the lockstep back), EOS at the first position (all EOS, length 0), a
    budget below gamma (the commit stops at the budget), and the
    self-draft (every proposal accepted: 8 tokens in 2 chunks of 4)."""
    free = {}
    for b in (1, 3):
        ids, lens = _prompt(b, 16, 256)
        with torch.inference_mode():
            free[b], _ = greedy_decode(gpt2["port"], _t(ids), _t(lens), 8,
                                       256)
    _check_spec(gpt2, small_draft, "ngram", 3, 16, 8, int(free[3][0, 4]))
    _check_spec(gpt2, small_draft, "ngram", 1, 16, 8, int(free[1][0, 0]))
    stats = _check_spec(gpt2, small_draft, "ngram", 1, 16, 2, 256, gamma=4)
    assert stats[0] <= 2
    stats = _check_spec(gpt2, small_draft, "self", 1, 16, 8, 256)
    assert stats.tolist() == [2, 6, 6]


class _SkipSync:
    """A model draft whose cache-sync step (the first of each chunk's
    gamma + 1 calls) does nothing: the control for the stats."""

    def __init__(self, model, gamma):
        self.model, self.cfg, self.gamma, self.calls = (model, model.cfg,
                                                        gamma, 0)

    def new_cache(self, *args):
        return self.model.new_cache(*args)

    def prefill(self, *args):
        return self.model.prefill(*args)

    def decode_step(self, token, index, cache, valid):
        self.calls += 1
        if (self.calls - 1) % (self.gamma + 1) == 0:
            return None, cache
        return self.model.decode_step(token, index, cache, valid)


def test_spec_decode_controls(gpt2):
    """Controls: the comparison catches a target that is not the
    reference's (its tokens differ), and the stats catch a self-draft
    without its cache-sync step (stale k/v at each chunk's last position
    erode the acceptance below the reference's 6 of 6)."""
    ids, lens = _prompt(1, 16, 256)
    ref = _ref_spec(gpt2, ids, lens, 8, 256, 3, jax_decode.NgramDraft(2))
    other = GPT2LM(gpt2["port"].cfg)
    other.load_state_dict(gpt2["port"].state_dict())
    with torch.no_grad():
        other.block_0.attn.q.weight.mul_(1.5)
    with torch.inference_mode():
        toks, _, _ = speculative_decode(other.eval(), _t(ids), _t(lens), 8,
                                        256, 3, NgramDraft(2))
        _, _, stats = speculative_decode(
            gpt2["port"], _t(ids), _t(lens), 8, 256, 3,
            ModelDraft(_SkipSync(gpt2["port"], 3)))
    assert not np.array_equal(toks.numpy(), ref[0])
    assert stats.tolist() != [2, 6, 6]


@pytest.mark.parametrize("kind", ["ngram", "draft_model"])
def test_spec_graph_equals_eager(gpt2, small_draft, kind, monkeypatch):
    """The chunk body through :class:`EagerStep` as its graph, twice with
    the kept state, against the eager body: the capture's warm-up runs a
    chunk, and the state it wrote is put back, so tokens, lengths and
    stats are equal; one replay (and one host read) a chunk."""
    monkeypatch.setattr(port_decode, "CapturedStep", EagerStep)
    ids, lens = _prompt(3, 16, 256, seed=11)
    draft = _drafts(kind, gpt2, small_draft)[2]
    args = (gpt2["port"], _t(ids), _t(lens), 8, 256, 3, draft)
    states = {}
    with torch.inference_mode():
        eager = speculative_decode(*args)
        runs = [speculative_decode(*args, graphs=states, graphed=True)
                for _ in range(2)]
    for run in runs:
        for got, want in zip(run, eager):
            assert torch.equal(got, want)
    (state,) = states.values()
    assert state.graph.replays == 2 * int(eager[2][0])
    assert state.host_reads == int(eager[2][0])


# -- the serving path ----------------------------------------------------------

def _spec_cfg(module, spec, mistral=False, max_positions=64):
    cfg = module.test_config()
    models = dataclasses.replace(cfg.models, gpt2=dataclasses.replace(
        cfg.models.gpt2, max_positions=max_positions))
    if mistral:
        models = dataclasses.replace(models,
                                     mistral=module.MistralConfig.tiny())
    return cfg.replace(models=models, spec_decode=spec)


def _specs(module):
    return {"ngram": module.SpecDecodeConfig(mode="ngram", gamma=4, ngram=2),
            "draft_model": module.SpecDecodeConfig(
                mode="draft_model", gamma=4,
                draft_model=module.GPT2Config(**SMALL_DRAFT))}


@pytest.mark.parametrize("kind", ["ngram", "draft_model"])
def test_prompt_generator_spec_matches_reference(kind):
    """Two prompt buckets (32 and 64, the position table widened to 128
    for the 64 bucket's scratch tail), the first of 3 rows padded with a
    dummy row (``row_mask``): tokens, lengths and the decode's summed stats equal
    the reference's, on its own weights (the draft model's too)."""
    ref = jax_pipeline.PromptGenerator(
        _spec_cfg(jax_config, _specs(jax_config)[kind], max_positions=128))
    sd = {"gpt2": from_jax("gpt2", jax.device_get(ref.params))}
    if kind == "draft_model":
        sd["gpt2_draft"] = from_jax(
            "gpt2", jax.device_get(ref._spec_draft_params))
    port = PromptGenerator(
        _spec_cfg(port_config, _specs(port_config)[kind], max_positions=128),
        "cpu", sd["gpt2"], sd.get("gpt2_draft"))
    texts = ["storm", "y" * 40, "b c d b c d b c d", "the tide"]
    want_t, want_n = ref.decode_ids_batch(texts, max_new_tokens=8, seed=0)
    got_t, got_n = port.decode_ids_batch(texts, max_new_tokens=8)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))
    for key in ("chunks", "drafted", "accepted"):
        assert port.last_spec_stats[key] == ref.last_spec_stats[key], key
    assert port.last_spec_stats["chunks"] >= 2       # both buckets drafted


def test_prompt_generator_spec_mistral_matches_reference():
    """The Mistral branch through the spec path (n-gram draft), the
    sliding window inside the verify chunk: tokens and stats equal the
    reference's."""
    spec = dict(mode="ngram", gamma=3, ngram=2)
    ref = jax_pipeline.PromptGenerator(_spec_cfg(
        jax_config, jax_config.SpecDecodeConfig(**spec), mistral=True))
    port = PromptGenerator(
        _spec_cfg(port_config, port_config.SpecDecodeConfig(**spec),
                  mistral=True),
        "cpu", from_jax("mistral", jax.device_get(ref.params)))
    texts = ["the storm rolled over the", "b c d b c d b c d"]
    want_t, want_n = ref.decode_ids_batch(texts, max_new_tokens=8, seed=0)
    got_t, got_n = port.decode_ids_batch(texts, max_new_tokens=8)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))
    assert port.last_spec_stats == ref.last_spec_stats


def test_prompt_generator_spec_switches(monkeypatch):
    """Where the spec path stands aside, the greedy path serves the same
    tokens and ``last_spec_stats`` stays untouched: a bucket without the
    scratch tail's room (55 + 8 + 5 > 64), CASSMANTLE_NO_SPEC_DECODE, and
    a sampled decode (temperature > 0). A draft of another vocabulary is
    refused."""
    spec = _specs(port_config)["ngram"]
    gen = PromptGenerator(_spec_cfg(port_config, spec), "cpu")
    plain = PromptGenerator(port_config.test_config(), "cpu",
                            gen.model.state_dict())
    assert gen._spec_enabled(32, 8) and not gen._spec_enabled(55, 8)
    got, _ = gen.decode_ids_batch(["z" * 40], max_new_tokens=8)
    want, _ = plain.decode_ids_batch(["z" * 40], max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert gen.last_spec_stats is None
    monkeypatch.setenv("CASSMANTLE_NO_SPEC_DECODE", "1")
    assert not gen._spec_enabled(32, 8)
    got, _ = gen.decode_ids_batch(["the storm rolled"], max_new_tokens=8)
    want, _ = plain.decode_ids_batch(["the storm rolled"], max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    assert gen.last_spec_stats is None
    monkeypatch.delenv("CASSMANTLE_NO_SPEC_DECODE")
    cfg = _spec_cfg(port_config, spec)
    hot = PromptGenerator(cfg.replace(sampler=dataclasses.replace(
        cfg.sampler, text_temperature=0.8)), "cpu")
    assert not hot._spec_enabled(32, 8)
    bad = dataclasses.replace(spec, mode="draft_model",
                              draft_model=port_config.GPT2Config(
                                  **{**SMALL_DRAFT, "vocab_size": 300}))
    with pytest.raises(ValueError, match="vocabulary"):
        PromptGenerator(_spec_cfg(port_config, bad), "cpu")
