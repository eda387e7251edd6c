"""Content backends: the generation seam.

A copy of ``cassmantle_tpu/engine/content.py``. All model compute funnels
through :class:`ContentBackend.generate`: the port's
``InferenceService.content_backend`` in serving, and
:class:`FakeContentBackend` in tests and model-free games. The template
text is the port's own copy (``utils/text.py::template_text``).
"""

from __future__ import annotations

import asyncio
import hashlib

import numpy as np

from cassmantle_tpu_torch.engine.rounds import ContentBackend, RoundContent
from cassmantle_tpu_torch.utils.text import template_text

class FakeContentBackend(ContentBackend):
    """Deterministic, instant content: text from a seed-hash template, image
    = a solid-pattern gradient keyed by the text. Lets the full game run
    with zero model compute."""

    def __init__(self, image_size: int = 64, delay_s: float = 0.0) -> None:
        self.image_size = image_size
        self.delay_s = delay_s
        self.calls = 0

    async def generate(self, seed: str, is_seed: bool) -> RoundContent:
        self.calls += 1
        if self.delay_s:
            await asyncio.sleep(self.delay_s)
        text = template_text(seed)
        digest = hashlib.sha256(seed.encode()).digest()
        size = self.image_size
        # brownout actuation (serving/overload.py): the fake backend
        # honours the resolution-downshift tier like the real pipelines
        # (lazy import: the engine stays importable without serving)
        from cassmantle_tpu_torch.serving.overload import quality_overrides

        tier = quality_overrides()
        if tier is not None and tier.image_size_scale != 1.0:
            size = max(16, int(size * tier.image_size_scale))
        y, x = np.mgrid[0:size, 0:size]
        r = (x * int(digest[5]) // size) % 256
        g = (y * int(digest[6]) // size) % 256
        b = ((x + y) * int(digest[7]) // (2 * size)) % 256
        image = np.stack([r, g, b], axis=-1).astype(np.uint8)
        return RoundContent(prompt_text=text, image=image)


def hash_embed(words, dim: int = 32) -> np.ndarray:
    """Deterministic stub embedding for tests: word -> unit vector derived
    from its sha256. Similar only to itself; stable across runs."""
    out = np.zeros((len(words), dim), dtype=np.float32)
    for i, w in enumerate(words):
        h = hashlib.sha256(w.lower().encode()).digest()
        vec = np.frombuffer((h * ((dim * 4) // len(h) + 1))[: dim * 4],
                            dtype=np.uint32).astype(np.float32)
        vec = (vec / np.float32(2**32)) - 0.5
        out[i] = vec / (np.linalg.norm(vec) + 1e-8)
    return out


async def hash_similarity(pairs) -> np.ndarray:
    """Stub similarity: cosine of hash_embed vectors (≈0 for distinct
    words, 1 for identical)."""
    guesses = hash_embed([g for g, _ in pairs])
    answers = hash_embed([a for _, a in pairs])
    return np.sum(guesses * answers, axis=-1)
