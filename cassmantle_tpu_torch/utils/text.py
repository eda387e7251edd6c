"""Word-level text helpers of the round: tokenization for the degenerate-
text check, the template fallback, sanitizing and two-sentence trimming.

Copies of ``cassmantle_tpu/utils/text.py`` (``tokenize_words``,
``is_wordlike``), ``cassmantle_tpu/engine/content.py`` (``template_text``)
and ``cassmantle_tpu/serving/pipeline.py`` (``sanitize_text``,
``two_sentences``), and ``cassmantle_tpu/server/assets.py``
(``load_seeds``, ``load_wordlist``: the guess vocabulary the scorer's int8
table covers), kept here because the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import string
from typing import List, Tuple

_TOKEN_RE = re.compile(
    r"[A-Za-z]+(?:['’-][A-Za-z]+)*"  # words incl. contractions/hyphens
    r"|\d+(?:\.\d+)?"                      # numbers
    r"|[^\sA-Za-z\d]"                      # single punctuation marks
)


def tokenize_words(text: str) -> List[str]:
    """Split text into word/punctuation tokens."""
    return _TOKEN_RE.findall(text)


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


_DEFAULT_STYLES = [
    "Watercolor",
    "Art deco",
    "Ukiyo-e woodblock",
    "Low-poly 3D render",
    "Charcoal sketch",
    "Stained glass",
    "Vaporwave",
]

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def load_styles() -> List[str]:
    """Art styles from the repository's ``data/styles.txt``, or the
    built-in list when the file is absent or empty."""
    try:
        with open(os.path.join(DATA_DIR, "styles.txt")) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return list(_DEFAULT_STYLES)
    return lines or list(_DEFAULT_STYLES)


_DEFAULT_SEEDS = [
    "The Cartographer of Drowned Cities",
    "A Winter Without Clocks",
    "The Orchard at the Edge of the Map",
    "Letters from the Glass Lighthouse",
    "The Night the Trains Sang",
    "Keeper of the Paper Storms",
    "The Astronomer's Unsent Telegrams",
    "Salt Roads and Silver Rivers",
    "The Museum of Almost-Forgotten Sounds",
    "A Harbor for Runaway Shadows",
    "The Clockmaker's Second Moon",
    "Embers over the Quiet Canyon",
    "The Librarian Who Collected Horizons",
    "Caravan of the Painted Comets",
    "The Garden Below the Ice",
    "Signals from the Tin Observatory",
    "The Last Ferry to the Floating Market",
]


def _load_lines(path: str, fallback: List[str]) -> List[str]:
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return lines or list(fallback)
    except OSError:
        return list(fallback)


def load_seeds() -> List[str]:
    """Story seeds from ``data/seeds.txt``, or the built-in list."""
    return _load_lines(os.path.join(DATA_DIR, "seeds.txt"), _DEFAULT_SEEDS)


@functools.lru_cache(maxsize=1)
def load_wordlist() -> Tuple[str, ...]:
    """The game's guess vocabulary: ``data/wordlist.txt`` in file order,
    then every word of the seeds and styles (whole hyphenated tokens and
    each alphabetic run of two letters or more) not already listed."""
    seen = dict.fromkeys(
        _load_lines(os.path.join(DATA_DIR, "wordlist.txt"), []))
    for line in load_seeds() + load_styles():
        for token in line.lower().split():
            token = token.strip("'-.,;:!?\"")
            if re.fullmatch(r"[a-z]+(?:[-'][a-z]+)*", token) and \
                    len(token) >= 2:
                seen.setdefault(token)
            for part in re.findall(r"[a-z]+", token):
                if len(part) >= 2:
                    seen.setdefault(part)
    return tuple(seen)
