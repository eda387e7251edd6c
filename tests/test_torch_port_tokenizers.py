"""The port's tokenizers against the reference's, on the CPU.

Synthetic vocabularies in the reference tests' style (greedy BPE merges
over the game's own text; ``tests/_torch_port_weights.py``) are written
as files under the reference's names. Each port tokenizer must give the
reference's ids and decode over every line of ``data/seeds.txt``,
``data/styles.txt`` and ``data/wordlist.txt`` and over hypothesis's
unicode text, and ``load_tokenizer`` must pick the reference's class for
each set of files present.
"""

import os
import shutil

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cassmantle_tpu.utils import tokenizers as jax_tok
from cassmantle_tpu_torch.utils import tokenizers as port_tok

from _torch_port_weights import SEEDS, STYLES, WORDS, write_vocab_files

KINDS = ("gpt2", "clip", "minilm", "mistral")
VOCAB = {"gpt2": 50257, "clip": 49408, "minilm": 30522, "mistral": 32000}
# the files each kind reads
FILES = {"gpt2": ("gpt2_vocab.json", "gpt2_merges.txt"),
         "clip": ("clip_vocab.json", "clip_merges.txt"),
         "minilm": ("minilm_vocab.txt",),
         "mistral": ("mistral_tokenizer.json",)}


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab"))
    write_vocab_files(path)
    return path


@pytest.fixture(scope="module")
def pairs(vocab_dir):
    """{kind: (port tokenizer, reference tokenizer)} from the files."""
    return {k: (port_tok.load_tokenizer(k, VOCAB[k], vocab_dir),
                jax_tok.load_tokenizer(vocab_dir, k, VOCAB[k]))
            for k in KINDS}


def _check(port, ref, texts):
    assert (port.vocab_size, port.eos_id, port.pad_id) == \
        (ref.vocab_size, ref.eos_id, ref.pad_id)
    for text in texts:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids), text


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("corpus", ["seeds+styles", "wordlist"])
def test_ids_and_decode_match_reference_on_the_game_text(pairs, kind,
                                                         corpus):
    port, ref = pairs[kind]
    assert type(port).__name__ == type(ref).__name__
    _check(port, ref, SEEDS + STYLES if corpus == "seeds+styles" else WORDS)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=60, deadline=None)
@given(text=st.text(max_size=40))
def test_ids_and_decode_match_reference_on_unicode(pairs, kind, text):
    port, ref = pairs[kind]
    _check(port, ref, [text, text.upper(), f" {text}\n{text} "])


def test_bpe_merge_and_byte_table_are_the_reference_s():
    assert port_tok._bytes_to_unicode() == jax_tok._bytes_to_unicode()
    ranks = {("l", "o"): 0, ("lo", "w"): 1, ("e", "r"): 2}
    for word in ("lower", "low", "rower", "l", ""):
        assert port_tok._bpe_merge(tuple(word), ranks) == \
            jax_tok._bpe_merge(tuple(word), ranks)


@pytest.mark.parametrize("present", [(), ("gpt2",), ("clip",), ("minilm",),
                                     ("mistral",), KINDS])
def test_load_tokenizer_picks_the_reference_s_class(vocab_dir, tmp_path,
                                                    present):
    """Each kind with its files present, alone or all together, or none:
    the same class as the reference's, the byte fallback without files.
    Half a pair (a vocab without merges) is no pair."""
    for kind in present:
        for name in FILES[kind]:
            shutil.copy(os.path.join(vocab_dir, name), tmp_path / name)
    shutil.copy(os.path.join(vocab_dir, "clip_vocab.json"),
                tmp_path / "clip_vocab.json")
    for kind in KINDS:
        port = port_tok.load_tokenizer(kind, VOCAB[kind], str(tmp_path))
        ref = jax_tok.load_tokenizer(str(tmp_path), kind, VOCAB[kind])
        assert type(port).__name__ == type(ref).__name__, kind
        want = "ByteTokenizer" if kind not in present else type(ref).__name__
        assert type(port).__name__ == want
    assert isinstance(port_tok.load_tokenizer("gpt2", 300),
                      port_tok.ByteTokenizer)
    with pytest.raises(ValueError, match="unknown tokenizer kind"):
        port_tok.load_tokenizer("t5", 300, str(tmp_path))


def test_identity_follows_the_vocabulary_file(vocab_dir, tmp_path):
    """A tokenizer read from files names them by digest: a changed
    vocabulary file gives another identity, the same bytes the same."""
    for name in FILES["minilm"]:
        shutil.copy(os.path.join(vocab_dir, name), tmp_path / name)
    first = port_tok.load_tokenizer("minilm", 30522, str(tmp_path))
    again = port_tok.load_tokenizer("minilm", 30522, str(tmp_path))
    assert port_tok.tokenizer_identity(first) == \
        port_tok.tokenizer_identity(again)
    with open(tmp_path / "minilm_vocab.txt", "a") as f:
        f.write("zyzzyva\n")
    changed = port_tok.load_tokenizer("minilm", 30522, str(tmp_path))
    byte = port_tok.load_tokenizer("minilm", 30522)
    idents = {port_tok.tokenizer_identity(t) for t in (first, changed, byte)}
    assert len(idents) == 3
