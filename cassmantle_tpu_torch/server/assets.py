"""Story seeds, art styles and the guess vocabulary.

A copy of ``cassmantle_tpu/server/assets.py``: one-line story seed titles
and style names from the repository's ``data/seeds.txt`` and
``data/styles.txt``, with built-ins when the files are absent, and the
guess vocabulary (``data/wordlist.txt`` plus every seed and style word).
"""

from __future__ import annotations

import functools
import os
import re
from typing import List, Tuple

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")

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

_DEFAULT_STYLES = [
    "Watercolor",
    "Art deco",
    "Ukiyo-e woodblock",
    "Low-poly 3D render",
    "Charcoal sketch",
    "Stained glass",
    "Vaporwave",
]


def _load_lines(path: str, fallback: List[str]) -> List[str]:
    try:
        with open(path, "r") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return lines or list(fallback)
    except OSError:
        return list(fallback)


def load_seeds() -> List[str]:
    return _load_lines(os.path.join(DATA_DIR, "seeds.txt"), _DEFAULT_SEEDS)


def load_styles() -> List[str]:
    return _load_lines(os.path.join(DATA_DIR, "styles.txt"), _DEFAULT_STYLES)


@functools.lru_cache(maxsize=1)
def load_wordlist() -> Tuple[str, ...]:
    """The game's guess vocabulary (data/wordlist.txt + every word
    appearing in seeds/styles). FILE ORDER IS PRESERVED: the file is
    most-common-first and spellcheckers rank suggestions by position.
    Seed/style vocabulary appends after the file. The scorer's int8
    table covers these words (ops/scorer.py). Cached: immutable at
    runtime."""
    # one insertion-ordered dict: order is the rank, keys the dedup
    seen = dict.fromkeys(
        _load_lines(os.path.join(DATA_DIR, "wordlist.txt"), []))
    for line in load_seeds() + load_styles():
        for token in line.lower().split():
            token = token.strip("'-.,;:!?\"")
            # whole token (keeps 'ukiyo-e', 'low-poly' checkable exactly)
            if re.fullmatch(r"[a-z]+(?:[-'][a-z]+)*", token) and \
                    len(token) >= 2:
                seen.setdefault(token)
            # plus each alpha run, so the parts are guessable too
            for part in re.findall(r"[a-z]+", token):
                if len(part) >= 2:
                    seen.setdefault(part)
    return tuple(seen)
