"""Lightweight POS classification for mask candidacy.

The reference filters mask candidates by NLTK POS tag: a word is
eligible only when tagged JJ/JJR/JJS, RB/RBR/RBS, or NN/NNS — verbs
(VB*), proper nouns (NNP*), numbers (CD) and function words never mask
(reference src/utils.py:81-88, ``descriptive_tags``). NLTK's perceptron
tagger needs a downloaded model (zero-egress here), so this module
approximates the same decision with a vendored verb lexicon plus
morphology and left-context rules — self-contained, deterministic, no
corpus files.

The only decision that matters downstream is MASKABLE vs NOT (all of
JJ/RB/NN are treated identically by the selector), so the classifier
targets exactly the reference's exclusion classes:

- function words and number words (closed class);
- proper nouns — capitalized tokens that are not sentence-initial;
- verbs, by form class:
  - ``-ing`` forms whose stem is a known verb base are VBG (excluded —
    NLTK tags even attributive participles like "the humming lamp" as
    VBG, and VBG is not in ``descriptive_tags``); ``-ing`` nouns with
    non-verb stems ("railing", "morning") stay maskable;
  - ``-ed`` forms and irregular pasts/participles are verbs EXCEPT in
    attributive position, where NLTK reads them as JJ ("the gilded
    caravan", "under striped awnings", "gathered fallen fruit"):
    attributive = preceded by a determiner/preposition/verb (the start
    of a noun phrase) or sentence-initial;
  - bare verb bases are verbs after infinitive "to" or a modal
    ("to return"), after a plural-noun subject ("Birds sing" — VBP),
    or opening an imperative whose object follows ("Gather the
    fallen branches" — VB); elsewhere the noun reading wins
    ("promised rest", sentence-initial noun subjects like "Rain
    tapped...");
  - ``-s`` forms are treated as plural nouns: in past-tense story
    prose a 3rd-person-singular present verb is rare, while plural
    nouns after adjectives ("black rocks") are everywhere. Known
    gap (quantified per-class by eval/masking_agreement.py): VBZ in
    present-tense prompts ("the light fades") reads as NNS.

Accuracy against hand-annotated NLTK-convention tags and end-to-end
mask-selection agreement with the reference algorithm are measured by
eval/masking_agreement.py over data/pos_gold.txt.

A copy of ``cassmantle_tpu/engine/pos.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from cassmantle_tpu_torch.utils.text import is_wordlike

# Determiners/possessives: a verb-homograph right after one is a noun
# ("the saw", "a rose", "their set"), and an -ed participle right
# after one is attributive ("the gilded caravan").
DETERMINERS = frozenset(
    """a an the this that these those my your his her its our their no
    some any each every either neither another such both all few
    several many most much""".split()
)

# Prepositions absent from masking.STOPWORDS (IN tags — excluded by
# the reference's filter, and the left-context of an attributive
# participle: "under STRIPED awnings", "into CHIPPED cups").
PREPOSITIONS = frozenset(
    """across along around behind beneath beside besides beyond near
    past toward towards upon within despite except like unlike amid
    amidst atop inside outside underneath throughout alongside""".split()
)

# Full preposition class for LEFT-context tests (PREPOSITIONS above
# only lists the ones masking.STOPWORDS lacks; an attributive
# participle can follow any of them: "UNDER striped awnings").
_ALL_PREPOSITIONS = PREPOSITIONS | frozenset(
    """in on at by of to from with without into onto over under above
    below between among through during before after against about
    while until""".split()
)

MODALS = frozenset(
    """will would can could may might must shall should do does did
    to""".split()
)

# Number words: CD tags, not in descriptive_tags.
NUMBERS = frozenset(
    """one two three four five six seven eight nine ten eleven twelve
    twenty thirty forty fifty hundred thousand million""".split()
)

# Sentence terminators: a capitalized token right after one is
# sentence-initial, not a proper noun.
_SENT_END = frozenset({".", "!", "?"})

# Irregular simple-past forms common in narrative prose (VBD).
IRREGULAR_PAST = frozenset(
    """went came saw took gave found left stood told sold became began
    brought built bought caught chose drew drove fell felt fought flew
    forgot grew heard held kept knew laid led lost made meant met paid
    ran rang rose said sang sat sent set shone shook slept spoke spent
    stole swam swept swung taught thought threw understood woke wore
    won wrote blew broke crept dealt dug drank froze hid hung knelt
    lay lent lit rode sought shot shrank slid spun sprang stuck stung
    strode struck swore tore wept wound bent bound bled fled sank
    stank clung leapt shod""".split()
)

# Participle forms that read as adjectives when attributive
# ("the broken clock") — same positional rule as -ed forms.
PARTICIPLE_ADJ = frozenset(
    """broken stolen worn torn hidden frozen woven sunken fallen
    forgotten shrunken swollen molten sworn shaken beaten written
    driven given risen chosen known grown thrown drawn flown borne
    bitten forbidden rotten""".split()
)

# Lexicalized -ed adjectives with no live verb reading in prose.
ED_ADJECTIVES = frozenset(
    """crooked wicked rugged naked sacred jagged wretched aged beloved
    learned dogged ragged blessed gifted fabled storied wooded
    left-handed hundred""".split()
)

# -ing nouns whose stem IS a verb base but whose noun reading
# dominates ("the building", "a painting").
ING_NOUNS = frozenset(
    """building painting drawing meaning feeling beginning ending
    wedding morning evening clothing ceiling railing lightning
    opening crossing landing setting gathering""".split()
)

# Common verb BASES whose inflections appear as main verbs in story
# prose. Bases are listed once; -s/-ed/-ing forms derive
# morphologically. Deliberately excludes heavy noun-homograph bases
# (light, sound, water, place, hand, spring, pass, sail, fish...).
VERB_BASES = frozenset(
    """drift wait hum appear seem remain arrive descend ascend wander
    linger gather scatter tremble shimmer flicker glow fade vanish
    emerge depart return follow carry cross climb crawl float settle
    whisper murmur echo stretch reach travel move turn stir lean
    pause happen begin continue cease expect believe notice watch
    listen stare gaze glance breathe sigh laugh weep smile frown nod
    shrug stumble hurry rush creep slip slide roll spin drip pour
    rain shine burn freeze melt crack shatter bloom wilt wither grow
    rise fall stand sit walk run fly swim sing dance speak talk call
    shout cry ask answer tell say know think feel hear see look come
    go get make take give find keep hold bring send leave meet pay
    play open close start stop end live die sleep wake dream hope
    wish want need try use work rest stay wear bear tear hide rock
    crumble flutter forget remember learn teach understand mean
    build buy catch choose deal dig draw drive eat fight lead lend
    lose read ride seek sell shake shoot show shut sink smell spend
    spread steal stick sting strike swear sweep swing throw wind
    write depict curl cool dry whistle complain calm""".split()
)


def _inflections(base: str) -> List[str]:
    """-s / -ed / -ing / doubled-consonant forms for one verb base."""
    forms = []
    if base.endswith("e"):
        stem = base[:-1]
        forms += [base + "s", stem + "ed", stem + "ing"]
    elif base.endswith("y") and len(base) > 2 and base[-2] not in "aeiou":
        forms += [base[:-1] + "ies", base[:-1] + "ied", base + "ing"]
    else:
        forms += [base + "s", base + "ed", base + "ing"]
        if (len(base) >= 3 and base[-1] not in "aeiouwxy"
                and base[-2] in "aeiou" and base[-3] not in "aeiou"):
            forms += [base + base[-1] + "ed", base + base[-1] + "ing"]
    return forms


_INFLECTED_VERB_FORMS = frozenset(
    form for b in VERB_BASES for form in _inflections(b)
)


def _ing_stems(low: str) -> List[str]:
    """Candidate bases for an -ing form: strip, restore -e, undouble."""
    stem = low[: -len("ing")]
    out = [stem, stem + "e"]
    if len(stem) >= 2 and stem[-1] == stem[-2]:
        out.append(stem[:-1])
    return out


def _is_verb_ing(low: str) -> bool:
    return (low.endswith("ing") and low not in ING_NOUNS
            and any(s in VERB_BASES for s in _ing_stems(low)))


def _is_verbish(low: Optional[str]) -> bool:
    """Loose test used for LEFT context: does this word look like a
    verb form (so the next word starts an object noun phrase)? -ing
    forms route through ``_is_verb_ing`` ONLY, so lexicalized -ing
    nouns that happen to inflect a known base ("the gathering ended")
    don't read as verbs."""
    if low is None:
        return False
    return (low in IRREGULAR_PAST
            or (low in _INFLECTED_VERB_FORMS
                and not low.endswith(("s", "ing")))
            or (low.endswith("ed") and low not in ED_ADJECTIVES)
            or _is_verb_ing(low))


def _prev_word(tokens: Sequence[str], i: int) -> Optional[str]:
    for j in range(i - 1, -1, -1):
        if is_wordlike(tokens[j]):
            return tokens[j].lower()
        if tokens[j] in _SENT_END:
            return None
    return None


def _next_word(tokens: Sequence[str], i: int) -> Optional[str]:
    for j in range(i + 1, len(tokens)):
        if is_wordlike(tokens[j]):
            return tokens[j].lower()
        if tokens[j] in _SENT_END:
            return None
    return None


# -s adverbs/misc that would otherwise pass the plural-noun surface
# test below ("Winters are always cool" must not read "cool" as VBP).
_S_ADVERBS = frozenset(
    """always sometimes perhaps besides towards upwards downwards
    backwards forwards afterwards nowadays indoors outdoors overseas
    alas thus""".split()
)


def _plural_nounish(low: Optional[str]) -> bool:
    """Loose plural-noun test for the VBP rule: an -s word that isn't a
    mass/abstract -ss noun, a function word ("across"), or an -s adverb
    ("always") — leaving "birds", "waves", "sentries"."""
    return (low is not None and len(low) > 3 and low.endswith("s")
            and not low.endswith("ss") and not _is_function_word(low)
            and low not in _S_ADVERBS
            and low not in _INFLECTED_VERB_FORMS)


def _sentence_initial(tokens: Sequence[str], i: int) -> bool:
    for j in range(i - 1, -1, -1):
        if tokens[j] in _SENT_END:
            return True
        if is_wordlike(tokens[j]):
            return False
    return True


def _is_function_word(low: str) -> bool:
    from cassmantle_tpu_torch.engine.masking import STOPWORDS

    return (low in STOPWORDS or low in DETERMINERS
            or low in PREPOSITIONS or low in NUMBERS)


def _attributive(tokens: Sequence[str], i: int) -> bool:
    """True when token i sits at/inside the start of a noun phrase —
    right after a determiner, preposition, or verb, or opening a
    sentence — where NLTK reads a participle as JJ."""
    prev = _prev_word(tokens, i)
    if prev is None:
        return True
    # "to" before a participle is always prepositional ("to tired
    # sailors") — infinitive "to" takes a bare form, never -ed
    return (prev in DETERMINERS or prev in _ALL_PREPOSITIONS
            or _is_verbish(prev))


def is_maskable(tokens: Sequence[str], i: int) -> bool:
    """Approximate ``pos_tag(tokens)[i] in descriptive_tags`` — the
    reference's candidacy test (src/utils.py:86-88) — without NLTK."""
    tok = tokens[i]
    if not is_wordlike(tok):
        return False
    low = tok.lower()
    if _is_function_word(low):
        return False
    # proper noun (NNP): capitalized mid-sentence
    if tok[0].isupper() and not _sentence_initial(tokens, i):
        return False
    # VBG: -ing with a verb stem (NLTK excludes even attributive ones).
    # Verb BASES that merely end in -ing ("sing", "bring", "swing")
    # fall through to the bare-base rules below instead.
    if low.endswith("ing") and low not in VERB_BASES:
        return not _is_verb_ing(low)
    prev = _prev_word(tokens, i)
    # a verb-homograph right after a determiner is a noun ("the rose")
    if prev in DETERMINERS:
        return True
    # -ly adverbs are RB — maskable (as are the few -ly adjectives)
    if low.endswith("ly"):
        return True
    # past/participle forms: JJ in attributive position, else VBD/VBN
    if (low in PARTICIPLE_ADJ or low in IRREGULAR_PAST
            or low.endswith("ed")):
        if low in ED_ADJECTIVES:
            return True
        if low.endswith("ed") and len(low) <= 4:
            # too short to be an inflected verb: "red", "bed", "seed"
            return True
        return _attributive(tokens, i)
    # bare verb base: a verb as an infinitive/modal complement, as a
    # present-tense main verb after a plural-noun subject ("Birds sing
    # at dawn" — VBP), or opening an imperative whose object follows
    # ("Gather the fallen branches" — VB). Elsewhere the noun reading
    # wins ("promised rest", "Rain tapped...").
    if low in VERB_BASES:
        if prev in MODALS:
            return False
        if _plural_nounish(prev):
            return False
        if (_sentence_initial(tokens, i)
                and _next_word(tokens, i) in _IMPERATIVE_OBJECTS):
            return False
        return True
    return True


# What can open an imperative's object: a determiner/possessive or an
# object pronoun ("Gather the branches", "Pay him with dried figs").
_IMPERATIVE_OBJECTS = DETERMINERS | frozenset(
    "them it him her us me you nothing something everything".split()
)


# ---------------------------------------------------------------------------
# Register-drift detection
# ---------------------------------------------------------------------------
# The classifier above is tuned to PAST-NARRATIVE story prose — the
# production register — where mask-selection agreement with the NLTK
# reference measures 100%. On present-tense prose agreement
# collapses to ~40% (3sg -s verbs read as plural nouns) and on
# imperatives to ~47%. Nothing used to consume that documented gap at
# runtime: a drifted LM would degrade mask quality silently. These
# helpers detect the drifted registers so the mask selector
# (engine/masking.py) can fall back to a conservative candidate set
# instead.

# "is/are/seems"-style copulas and auxiliaries that mark present-tense
# predication when followed by a verbal -ing form ("the light is
# fading").
_PRESENT_AUX = frozenset("is are am has have".split())


def _is_verb_s_form(low: str) -> bool:
    """An -s surface form that inflects a known verb base ("fades",
    "hums") — the VBZ shapes the maskability rules above deliberately
    read as plural nouns (the documented present-tense gap)."""
    return (low.endswith("s") and not low.endswith("ss")
            and low in _INFLECTED_VERB_FORMS)


def register_evidence(tokens: Sequence[str]) -> dict:
    """Count per-register verb evidence in a token stream.

    - ``past``: irregular simple pasts and -ed verb inflections — the
      register the classifier is calibrated for;
    - ``present``: 3sg -s verb forms after a singular/dt subject, and
      aux+V-ing progressives;
    - ``imperative``: sentence-initial bare verb bases with a
      determiner/pronoun object following (the existing imperative
      surface rule).
    """
    past = present = imperative = 0
    for i, tok in enumerate(tokens):
        if not is_wordlike(tok):
            continue
        low = tok.lower()
        if low in IRREGULAR_PAST or (
                low.endswith("ed") and len(low) > 4
                and low in _INFLECTED_VERB_FORMS
                and low not in ED_ADJECTIVES):
            past += 1
            continue
        prev = _prev_word(tokens, i)
        if _is_verb_s_form(low) and prev is not None \
                and not _plural_nounish(prev) and prev not in MODALS:
            # "the light fadeS", "she hums" — 3sg present
            present += 1
            continue
        if _is_verb_ing(low) and prev in _PRESENT_AUX:
            # "the tide is riSING" — present progressive
            present += 1
            continue
        if (low in VERB_BASES and _sentence_initial(tokens, i)
                and _next_word(tokens, i) in _IMPERATIVE_OBJECTS):
            imperative += 1
    return {"past": past, "present": present, "imperative": imperative}


def register_drift(tokens: Sequence[str]) -> bool:
    """True when the prose looks present-tense or imperative — the
    registers where mask agreement collapses (40-47%) — so
    the caller should not trust positional verb disambiguation."""
    ev = register_evidence(tokens)
    non_past = ev["present"] + ev["imperative"]
    if non_past == 0:
        return False
    # any imperative opener is decisive (story prose never opens
    # sentences with object-taking bare verbs); present-tense needs to
    # outweigh the past evidence to avoid flagging mixed narration
    return ev["imperative"] > 0 or ev["present"] > ev["past"]


# Surface forms that could be verbs in ANY position — the conservative
# exclusion set used when the register has drifted: with positional
# rules untrustworthy, every verb-homograph is dropped from mask
# candidacy rather than risk masking a verb (the reference's filter
# never masks verbs).
def could_be_verb(low: str) -> bool:
    return (low in VERB_BASES
            or low in IRREGULAR_PAST
            or low in PARTICIPLE_ADJ
            or (low in _INFLECTED_VERB_FORMS and low not in ING_NOUNS)
            or (low.endswith("ed") and len(low) > 4
                and low not in ED_ADJECTIVES)
            or _is_verb_ing(low))
