"""Word-level text helpers of the round: tokenization for the degenerate-
text check, the template fallback, sanitizing and two-sentence trimming.

Copies of ``cassmantle_tpu/utils/text.py`` (``tokenize_words``,
``is_wordlike``, ``format_clock``), ``cassmantle_tpu/engine/content.py``
(``template_text``) and ``cassmantle_tpu/serving/pipeline.py``
(``sanitize_text``, ``two_sentences``), kept here because the port
imports nothing of the JAX package. The seeds, styles and guess
vocabulary load in ``server/assets.py``.
"""

from __future__ import annotations

import hashlib
import re
import string
from typing import List

_TOKEN_RE = re.compile(
    r"[A-Za-z]+(?:['’-][A-Za-z]+)*"  # words incl. contractions/hyphens
    r"|\d+(?:\.\d+)?"                      # numbers
    r"|[^\sA-Za-z\d]"                      # single punctuation marks
)


def tokenize_words(text: str) -> List[str]:
    """Split text into word/punctuation tokens."""
    return _TOKEN_RE.findall(text)


def format_clock(seconds: float) -> str:
    """Seconds -> mm:ss, clamped at zero."""
    seconds = max(0, int(seconds))
    minutes, rem = divmod(seconds, 60)
    return f"{minutes:02d}:{rem:02d}"


def is_wordlike(token: str) -> bool:
    return bool(token) and token[0] not in string.punctuation and any(
        c.isalpha() for c in token
    )


_FAKE_SENTENCES = [
    "The {adj} {noun} drifted across the {place} under a {color} sky.",
    "A {adj} {noun} waited near the {place}, humming a {color} tune.",
    "Nobody expected the {adj} {noun} to appear beside the {place} at dusk.",
]
_ADJ = ["ancient", "glowing", "crooked", "silent", "restless", "gilded"]
_NOUN = ["lighthouse", "caravan", "automaton", "orchard", "archive", "comet"]
_PLACE = ["harbor", "observatory", "market", "glacier", "station", "canyon"]
_COLOR = ["crimson", "violet", "amber", "teal", "silver", "emerald"]


def template_text(seed: str) -> str:
    """Deterministic, always-maskable episode text derived from a seed
    hash: the round's fallback when the LM emits degenerate text (random
    weights, for one)."""
    digest = hashlib.sha256(seed.encode()).digest()
    pick = lambda options, i: options[digest[i] % len(options)]  # noqa: E731
    return _FAKE_SENTENCES[digest[0] % len(_FAKE_SENTENCES)].format(
        adj=pick(_ADJ, 1), noun=pick(_NOUN, 2),
        place=pick(_PLACE, 3), color=pick(_COLOR, 4),
    )


def sanitize_text(text: str) -> str:
    """Strip non-printable characters from generated text."""
    return "".join(c for c in text if c.isprintable() or c == " ").strip()


def two_sentences(text: str) -> str:
    """Trim generated text to its first two sentences."""
    parts = [p.strip() for p in text.split(".")]
    keep = [p for p in parts[:2] if p]
    if not keep:
        return text.strip() or "An empty page waited."
    return ". ".join(keep) + "."
