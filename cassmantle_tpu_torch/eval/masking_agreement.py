"""Mask-selection agreement with the reference algorithm.

A copy of ``cassmantle_tpu/eval/masking_agreement.py``. It replays the
original game's selection (the NLTK tag filter, the TF-IDF weight that is
identically 1 on a single sentence, and ``words.index`` first-occurrence
lookup) over a hand-annotated gold corpus (data/pos_gold.txt,
NLTK-convention Penn tags), and compares it with the port's selection
(engine/masking.select_masks with the vendored POS classifier).

Two numbers come out:

- ``tag_accuracy``: per-token agreement of engine/pos.is_maskable with
  the gold tags' maskability (the {JJ*, RB*, NN, NNS} test);
- ``mask_agreement``: fraction of prompts whose selected mask sets
  match the reference algorithm's exactly (plus mean Jaccard).

Run: ``python -m cassmantle_tpu_torch.eval.masking_agreement`` (hash
embedding; ``--minilm`` ranks with the port's MiniLM, on the card unless
``--device cpu``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

# the reference's descriptive_tags, src/utils.py:87
DESCRIPTIVE_TAGS = frozenset(
    ["JJ", "RB", "NN", "NNS", "JJR", "JJS", "RBR", "RBS"]
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLD_PATH = os.path.join(_REPO, "data", "pos_gold.txt")


def load_gold(path: str = GOLD_PATH) -> List[List[Tuple[str, str]]]:
    """[[(token, tag), ...] per prompt]."""
    return [pairs for _, pairs in load_gold_sections(path)]


def load_gold_sections(
    path: str = GOLD_PATH,
) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """[(section, [(token, tag), ...]) per prompt] — sections come from
    ``# section: NAME`` comment lines."""
    prompts = []
    section = "unsectioned"
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("# section:"):
                section = line.split(":", 1)[1].strip()
                continue
            if not line or line.startswith("#"):
                continue
            pairs = []
            for item in line.split():
                word, _, tag = item.rpartition("/")
                assert word and tag, f"malformed gold item {item!r}"
                pairs.append((word, tag))
            prompts.append((section, pairs))
    return prompts


def reference_select(
    tagged: Sequence[Tuple[str, str]],
    embed: Callable[[Sequence[str]], np.ndarray],
    num_masked: int = 2,
) -> List[int]:
    """The reference's ``select_descriptive_words`` replayed over gold
    tags (src/utils.py:81-104): filter by tag + isalpha, score by L2
    distance from the filtered-set mean embedding (IDF factor == 1 on a
    one-sentence fit), take the top ``num_masked`` by ascending-argsort
    tail, map back through first-occurrence ``words.index``."""
    words = [w for w, _ in tagged]
    filtered = [w for w, tag in tagged
                if w.isalpha() and tag in DESCRIPTIVE_TAGS]
    if not filtered:
        return []
    vecs = np.asarray(embed([w.lower() for w in filtered]),
                      dtype=np.float32)
    mean = vecs.mean(axis=0, keepdims=True)
    distances = np.linalg.norm(vecs - mean, axis=1)
    # default (introsort) argsort, matching the reference's np.argsort
    # call — exact-tie ordering follows NumPy's unstable sort in both
    top = np.argsort(distances)[-num_masked:]
    return sorted({words.index(filtered[i]) for i in top})


def framework_select(
    tokens: Sequence[str],
    embed: Callable[[Sequence[str]], np.ndarray],
    num_masked: int = 2,
) -> List[int]:
    from cassmantle_tpu_torch.engine.masking import select_masks

    return select_masks(tokens, embed, num_masked)


def tag_maskable(tag: str) -> bool:
    return tag in DESCRIPTIVE_TAGS


def surface_class(tok: str) -> str:
    """Audit bucket for a token, by SURFACE form only (derivable
    without the classifier, so the per-class error report can be
    checked against the corpus by hand). Buckets mirror the
    classifier's decision families (engine/pos.py)."""
    from cassmantle_tpu_torch.engine.pos import (
        IRREGULAR_PAST,
        PARTICIPLE_ADJ,
        VERB_BASES,
    )

    low = tok.lower()
    if low in VERB_BASES:
        return "bare-verb-base"
    if low in IRREGULAR_PAST or low in PARTICIPLE_ADJ:
        return "irregular-past-or-participle"
    if low.endswith("ing"):
        return "ing-form"
    if low.endswith("ed"):
        return "ed-form"
    if low.endswith("ly"):
        return "ly-form"
    if low.endswith("s") and not low.endswith("ss"):
        return "s-form"
    return "other"


def evaluate(
    embed: Callable[[Sequence[str]], np.ndarray],
    num_masked: int = 2,
    path: str = GOLD_PATH,
) -> Dict[str, object]:
    from cassmantle_tpu_torch.engine.pos import is_maskable
    from cassmantle_tpu_torch.utils.text import is_wordlike

    gold = load_gold_sections(path)
    tag_hits = tag_total = 0
    exact = 0
    jaccards = []
    disagreements = []
    by_class: Dict[str, Dict[str, int]] = {}
    by_section: Dict[str, Dict[str, int]] = {}
    tag_errors = []
    for section, tagged in gold:
        tokens = [w for w, _ in tagged]
        sec = by_section.setdefault(
            section, {"prompts": 0, "tag_total": 0, "tag_errors": 0,
                      "mask_exact": 0})
        sec["prompts"] += 1
        for i, (tok, tag) in enumerate(tagged):
            if not (is_wordlike(tok) and tok.isalpha()):
                continue
            tag_total += 1
            sec["tag_total"] += 1
            cls = by_class.setdefault(surface_class(tok),
                                      {"total": 0, "errors": 0})
            cls["total"] += 1
            if is_maskable(tokens, i) == tag_maskable(tag):
                tag_hits += 1
            else:
                cls["errors"] += 1
                sec["tag_errors"] += 1
                tag_errors.append({
                    "token": tok, "gold_tag": tag,
                    "class": surface_class(tok), "section": section,
                    "context": " ".join(tokens[max(0, i - 3): i + 3]),
                })
        ref = set(reference_select(tagged, embed, num_masked))
        ours = set(framework_select(tokens, embed, num_masked))
        union = ref | ours
        jac = len(ref & ours) / len(union) if union else 1.0
        jaccards.append(jac)
        if ref == ours:
            exact += 1
            sec["mask_exact"] += 1
        else:
            disagreements.append({
                "text": " ".join(tokens),
                "section": section,
                "reference": sorted(ref),
                "framework": sorted(ours),
            })
    return {
        "prompts": len(gold),
        "tag_accuracy": round(tag_hits / max(1, tag_total), 4),
        "mask_agreement": round(exact / max(1, len(gold)), 4),
        "mean_jaccard": round(float(np.mean(jaccards)), 4),
        "by_section": {
            k: {
                "prompts": v["prompts"],
                "tag_accuracy": round(
                    1 - v["tag_errors"] / max(1, v["tag_total"]), 4),
                "mask_agreement": round(
                    v["mask_exact"] / max(1, v["prompts"]), 4),
            }
            for k, v in by_section.items()
        },
        "tag_errors_by_class": {
            k: {**v, "accuracy": round(1 - v["errors"] / v["total"], 4)}
            for k, v in sorted(by_class.items())
        },
        "tag_errors": tag_errors,
        "disagreements": disagreements,
    }


def main() -> None:
    """CLI: deterministic hash embedding by default (isolates the
    filter difference — both selectors rank with the same vectors);
    --minilm ranks with the real scorer embeddings instead."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--minilm", action="store_true",
                    help="rank with MiniLM embeddings (loads the model)")
    ap.add_argument("--device", default="cuda",
                    help="where --minilm runs (cuda, or cpu)")
    ap.add_argument("--num-masked", type=int, default=2)
    ap.add_argument("--verbose", action="store_true",
                    help="print per-prompt disagreements")
    args = ap.parse_args()

    if args.minilm:
        from cassmantle_tpu_torch.config import FrameworkConfig
        from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer

        scorer = EmbeddingScorer(FrameworkConfig().models.minilm,
                                 device=args.device)
        embed = lambda words: scorer.embed(list(words))  # noqa: E731
    else:
        from cassmantle_tpu_torch.engine.content import hash_embed

        embed = hash_embed

    report = evaluate(embed, num_masked=args.num_masked)
    if not args.verbose:
        report = {**report,
                  "disagreements": len(report["disagreements"]),
                  "tag_errors": len(report["tag_errors"])}
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
