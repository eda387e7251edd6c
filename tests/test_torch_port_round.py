"""One round on the port against the reference, on the CPU at
``test_config()`` sizes: the copied configuration, tokenizers and text
helpers, bucketed GPT-2 prompt decode, the content backend's round logic
(sanitize, template fallback, style prompt, per-round image seed) and the
``InferenceService`` entry points.

The reference's ``TPUContentBackend`` gets a recording stand-in for its
image pipeline: the image path itself is held against the reference in
``test_torch_port_slice.py``; here the point is what the backend asks of
it. GPT-2 parameters are the reference ``PromptGenerator``'s own, carried
across with ``from_jax``.
"""

import asyncio
import dataclasses
import random

import jax
import numpy as np
import pytest

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.engine.content import template_text as jax_template
from cassmantle_tpu.server.assets import load_styles as jax_load_styles
from cassmantle_tpu.serving import pipeline as jax_pipeline
from cassmantle_tpu.utils import text as jax_text
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    TorchContentBackend,
)
from cassmantle_tpu_torch.serving.service import InferenceService
from cassmantle_tpu_torch.server import assets as port_assets
from cassmantle_tpu_torch.utils import text as port_text
from cassmantle_tpu_torch.utils.tokenizers import (
    load_tokenizer,
    tokenize_clip_prompts,
)

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

STYLES = ["Watercolor", "Art deco", "Vaporwave"]
SEEDS = ["The Night the Trains Sang", "Chapter two: the harbor",
         "a" * 80, "Ünïcode — seeds, too."]
TEXTS = [
    "The harbor lights were low tonight. The ships came in slowly. Then",
    "  no full stop here\x07 at all ",
    "...",
    "",
    "Wait.. what?! A comet-tail's glow, 3.5 km long. Done",
    "\tTabs\nand newlines. Stay out",
]


def _port_fields(obj):
    return {f.name for f in dataclasses.fields(obj)}


def _assert_same_fields(port, ref, where):
    """Every field the port keeps equals the reference's (recursing into
    nested config dataclasses)."""
    for name in _port_fields(port):
        p, r = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(p):
            _assert_same_fields(p, r, f"{where}.{name}")
        else:
            assert p == r, f"{where}.{name}: port {p!r} != reference {r!r}"


@pytest.mark.parametrize("which", ["default", "test_config"])
def test_config_matches_reference(which):
    """The port's config copy: the serving defaults and the test
    geometry agree with the reference field for field."""
    if which == "default":
        port, ref = port_config.FrameworkConfig(), jax_config.FrameworkConfig()
    else:
        port, ref = port_config.test_config(), jax_config.test_config()
    _assert_same_fields(port, ref, which)


@pytest.mark.parametrize("kind,vocab", [("gpt2", 256), ("clip", 1024),
                                        ("minilm", 30522),
                                        ("mistral", 32000)])
def test_tokenizers_match_reference(kind, vocab):
    port, ref = load_tokenizer(kind, vocab), jax_tokenizer(None, kind, vocab)
    assert (port.vocab_size, port.eos_id, port.pad_id) == \
        (ref.vocab_size, ref.eos_id, ref.pad_id)
    for text in SEEDS + TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids + [port.eos_id]) == ref.decode(ids +
                                                              [ref.eos_id])
    if kind == "clip":
        np.testing.assert_array_equal(
            tokenize_clip_prompts(port, SEEDS, 16, vocab),
            jax_pipeline.tokenize_clip_prompts(ref, SEEDS, 16, vocab))


@pytest.mark.parametrize("text", SEEDS + TEXTS)
def test_text_helpers_match_reference(text):
    words = port_text.tokenize_words(text)
    assert words == jax_text.tokenize_words(text)
    assert [port_text.is_wordlike(w) for w in words] == \
        [jax_text.is_wordlike(w) for w in words]
    assert port_text.sanitize_text(text) == jax_pipeline.sanitize_text(text)
    assert port_text.two_sentences(text) == jax_pipeline.two_sentences(text)
    assert port_text.template_text(text) == jax_template(text)


def test_styles_match_reference():
    assert port_assets.load_styles() == jax_load_styles()


class _Recorder:
    """Image-pipeline stand-in: records (prompts, seed), returns black."""

    def __init__(self, size):
        self.size = size
        self.calls = []

    def generate(self, prompts, seed=0, **_):
        self.calls.append((list(prompts), seed))
        return np.zeros((len(prompts), self.size, self.size, 3), np.uint8)


@pytest.fixture(scope="module")
def ref_backend():
    cfg = jax_config.test_config()
    backend = jax_pipeline.TPUContentBackend(
        cfg, styles=STYLES, rng=random.Random(5),
        t2i=_Recorder(cfg.sampler.image_size))
    gpt2 = from_jax("gpt2", jax.device_get(backend.prompt_gen.params))
    return backend, gpt2


def test_prompt_decode_matches_reference(ref_backend):
    """Bucketed greedy decode: token ids and lengths equal the reference's
    for a batch that spans two prompt buckets, and the two-sentence text
    of a single decode is the same string."""
    ref, gpt2 = ref_backend
    port = PromptGenerator(port_config.test_config(), "cpu", gpt2)
    toks, lens = port.decode_ids_batch(SEEDS)
    ref_toks, ref_lens = ref.prompt_gen.decode_ids_batch(SEEDS)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    assert port.generate(SEEDS[1]) == ref.prompt_gen.generate(SEEDS[1])


def test_round_logic_matches_reference(ref_backend, monkeypatch):
    """generate_sync over several rounds, decoded and injected text:
    the same round text (incl. template fallback on degenerate text), the
    same style prompts from the same rng, the same per-round image seed."""
    ref, gpt2 = ref_backend
    ref.rng, ref._round, ref.t2i.calls = random.Random(5), 0, []
    cfg = port_config.test_config()
    port = TorchContentBackend(cfg, "cpu", styles=STYLES,
                               rng=random.Random(5),
                               state_dicts={"gpt2": gpt2})
    recorder = _Recorder(cfg.sampler.image_size)
    monkeypatch.setattr(port, "t2i", recorder)
    rounds = [(SEEDS[0], None), (SEEDS[1], TEXTS[0]), (SEEDS[2], TEXTS[2]),
              (SEEDS[3], TEXTS[4])]
    for seed, text in rounds:
        got = port.generate_sync(seed, True, text=text)
        want = ref.generate_sync(seed, True, text=text)
        assert got.prompt_text == want.prompt_text
        assert got.image.shape == want.image.shape
    assert recorder.calls == ref.t2i.calls
    assert port.text_fallbacks >= 1          # "..." is degenerate


def test_service_serves_a_round_on_the_cpu():
    """InferenceService on the CPU: a round's text and uint8 image from
    the port's own pipeline (the image the pipeline makes for that style
    prompt and round seed), unit embeddings, scores in [-1, 1], blur;
    ``generate_content`` and ``similarity`` awaited, through the queues
    (no int8 table: the pairs score on the device rung)."""
    cfg = port_config.test_config()
    svc = InferenceService(cfg, device="cpu", table=None)
    backend = svc.backend
    styles_rng = random.Random(cfg.seed)
    rc = asyncio.run(svc.generate_content(SEEDS[0]))
    size = cfg.sampler.image_size
    assert rc.image.shape == (size, size, 3) and rc.image.dtype == np.uint8
    assert rc.prompt_text.strip()
    style = styles_rng.choice(backend.styles)
    again = backend.t2i.generate(
        [f"A {style.lower()} style piece depicting: {rc.prompt_text}"],
        seed=1)
    np.testing.assert_array_equal(rc.image, again[0])

    emb = svc.embed(["lighthouse", "comet", ""])
    assert emb.shape == (3, cfg.models.minilm.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    sims = asyncio.run(svc.similarity([("lighthouse", "lighthouse"),
                                       ("teal", "amber")]))
    assert sims.shape == (2,) and np.all(np.abs(sims) <= 1 + 1e-6)
    assert sims[0] == pytest.approx(1.0, abs=1e-5)
    for radius in (0.0, 5.0, 15.0):
        out = svc.blur(rc.image, radius)
        assert out.shape == rc.image.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(svc.blur(rc.image, 0.0), rc.image)
