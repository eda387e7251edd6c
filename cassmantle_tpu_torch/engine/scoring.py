"""Guess scoring service + reveal (blur) curve.

Reference behavior being kept (backend.py:303-324, server.py:63-89):

- exact (case-insensitive) match scores 1.0;
- otherwise embedding cosine similarity, floored at ``min_score`` (also used
  for unknown words);
- a session's best *mean* score drives the blur radius
  ``min + (1 - score²)·(max - min)``;
- win = every mask solved exactly (mean score == 1.0).

The embedding backend is injectable: a served game uses the port's batched
MiniLM scorer (ops/scorer.py); tests use deterministic stubs. Unlike the
reference's per-word synchronous gensim lookups, `score_pairs` is async and
vectorized so 1k concurrent guesses coalesce into one device batch.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Dict, List, Sequence, Tuple

import numpy as np

# (guess, answer) pairs -> cosine similarities in [-1, 1]
SimilarityFn = Callable[[Sequence[Tuple[str, str]]], Awaitable[np.ndarray]]


class GuessScorer:
    def __init__(self, similarity: SimilarityFn, min_score: float = 0.01):
        self._similarity = similarity
        self.min_score = min_score

    async def score_pairs(
        self, pairs: Dict[str, Dict[str, str]]
    ) -> Dict[str, float]:
        """{mask_idx: {input, answer}} -> {mask_idx: score}.

        Mirrors reference ``compute_scores`` (backend.py:312-317) but in one
        batched similarity call.
        """
        keys: List[str] = []
        todo: List[Tuple[str, str]] = []
        out: Dict[str, float] = {}
        for key, pair in pairs.items():
            guess = pair["input"].strip().lower()
            answer = pair["answer"].strip().lower()
            if guess == answer:
                out[key] = 1.0
            else:
                keys.append(key)
                todo.append((guess, answer))
        if todo:
            sims = np.asarray(await self._similarity(todo), dtype=np.float32)
            for key, sim in zip(keys, sims):
                out[key] = float(max(self.min_score, min(float(sim), 0.999)))
        return out


def score_to_blur(
    score: float, min_blur: float = 0.0, max_blur: float = 15.0
) -> float:
    """Reveal curve (reference backend.py:319-320): quadratic in score."""
    score = float(np.clip(score, 0.0, 1.0))
    return min_blur + (1.0 - score**2) * (max_blur - min_blur)
