"""Descriptive-word mask selection.

A copy of ``cassmantle_tpu/engine/masking.py``. The reference picks the
``num_masked`` most "descriptive" words of the prompt by NLTK POS tags
and word2vec distance from the mean vector. Here:

- candidate filter = the vendored POS classifier (engine/pos.py): word-like
  tokens that are not function words, not verbs, and not mid-sentence
  capitalized proper nouns; its agreement with hand-annotated
  NLTK-convention tags is measured by eval/masking_agreement.py;
- descriptiveness = L2 distance of the word's embedding from the mean
  embedding of all candidates, computed with the injected batched
  embedding (the port's MiniLM ``InferenceService.embed`` when served);
- duplicate words keep their own positions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from cassmantle_tpu_torch.utils.text import is_wordlike, tokenize_words

# Function words & other non-descriptive tokens, lowercased. Compact on
# purpose: the embedding-distance signal does the heavy lifting.
STOPWORDS = frozenset(
    """a an the and or but nor so yet for of in on at by to from with without
    into onto over under above below between among through during before
    after again further then once here there all any both each few more most
    other some such no not only own same than too very can will just should
    now i you he she it we they me him her us them my your his its our their
    this that these those am is are was were be been being have has had
    having do does did doing would could shall may might must ought as if
    while because until about against what which who whom whose when where
    why how out up down off
    """.split()
)

_MIN_WORD_LEN = 3

EmbedFn = Callable[[Sequence[str]], np.ndarray]


def candidate_indices(tokens: Sequence[str]) -> List[int]:
    """Indices of tokens eligible for masking: POS-maskable (JJ*/RB*/
    NN/NNS by the vendored classifier) and not too short to guess."""
    from cassmantle_tpu_torch.engine.pos import is_maskable

    return [
        i for i, tok in enumerate(tokens)
        if len(tok) >= _MIN_WORD_LEN and is_maskable(tokens, i)
    ]


def conservative_candidate_indices(tokens: Sequence[str]) -> List[int]:
    """Mask candidacy for DRIFTED registers (present-tense/imperative
    prose — engine/pos.register_drift): the classifier's positional
    verb disambiguation is untrustworthy there (40-47% agreement), so instead of trusting position, drop EVERY
    verb-homograph surface form. Conservative in the direction that
    matters — the reference's filter never masks verbs; a too-small
    candidate set just falls through to select_masks' longest-word
    backfill."""
    from cassmantle_tpu_torch.engine.pos import could_be_verb

    return [i for i in candidate_indices(tokens)
            if not could_be_verb(tokens[i].lower())]


def select_masks(
    tokens: Sequence[str],
    embed: EmbedFn,
    num_masked: int = 2,
) -> List[int]:
    """Pick ``num_masked`` token indices to mask, sorted ascending.

    ``embed`` maps a list of words to an (n, d) float array — in production
    the MiniLM scorer's embedding function, in tests any deterministic
    stub. Falls back to the longest candidates if fewer than ``num_masked``
    distinct embeddable words exist.

    Runtime register guard: generated prose that
    reads present-tense or imperative — where the vendored POS
    classifier's mask agreement collapses to 40-47% — switches to the
    conservative candidate set (every verb-homograph dropped) instead
    of degrading silently; the swap is counted at
    ``masking.register_drift`` on /metrics.
    """
    from cassmantle_tpu_torch.engine.pos import register_drift

    if register_drift(tokens):
        from cassmantle_tpu_torch.utils.logging import metrics

        metrics.inc("masking.register_drift")
        cands = conservative_candidate_indices(tokens)
    else:
        cands = candidate_indices(tokens)
    if not cands:
        # degenerate prompt: mask the longest word-like tokens
        wordy = [i for i, t in enumerate(tokens) if is_wordlike(t)]
        wordy.sort(key=lambda i: len(tokens[i]), reverse=True)
        return sorted(wordy[:num_masked])
    words = [tokens[i].lower() for i in cands]
    vecs = np.asarray(embed(words), dtype=np.float32)
    if vecs.ndim != 2 or vecs.shape[0] != len(words):
        raise ValueError(
            f"embed returned shape {vecs.shape} for {len(words)} words"
        )
    mean = vecs.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(vecs - mean, axis=1)
    # Prefer distinct words: among duplicates keep the first position so two
    # masks never share an answer.
    order = np.argsort(-dist, kind="stable")
    chosen: List[int] = []
    seen_words = set()
    for j in order:
        w = words[j]
        if w in seen_words:
            continue
        seen_words.add(w)
        chosen.append(cands[j])
        if len(chosen) == num_masked:
            break
    # backfill with duplicates if the prompt had too few distinct words
    for j in order:
        if len(chosen) == num_masked:
            break
        if cands[j] not in chosen:
            chosen.append(cands[j])
    return sorted(chosen)


def build_prompt_state(
    prompt_text: str, embed: EmbedFn, num_masked: int = 2
) -> Dict[str, object]:
    """Prompt text -> the stored round-prompt dict (reference
    ``construct_prompt_dict``, utils.py:106-110): word tokens + mask indices.
    """
    tokens = tokenize_words(prompt_text)
    masks = select_masks(tokens, embed, num_masked)
    return {"tokens": list(tokens), "masks": masks}
