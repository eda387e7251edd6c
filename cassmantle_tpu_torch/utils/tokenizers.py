"""Tokenizers of the port: byte-level BPE (GPT-2, CLIP), SentencePiece
BPE (Mistral), WordPiece (MiniLM) and the byte fallback.

A copy of ``cassmantle_tpu/utils/tokenizers.py`` (``:65-411``), written
from scratch there with no tokenizer package. :func:`load_tokenizer`
picks one by the vocabulary files in a weights directory, under the
reference's names: ``{gpt2,clip}_vocab.json`` with ``_merges.txt``,
``minilm_vocab.txt``, ``mistral_tokenizer.json``. With none of a kind's
files present it returns :class:`ByteTokenizer` (UTF-8 bytes as ids),
which runs every model path with the seeded weights. A tokenizer read
from files carries ``source_digest``, a digest of those files, which
:func:`tokenizer_identity` folds into the embed table's signature.
"""

from __future__ import annotations

import hashlib
import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Tokenizer:
    vocab_size: int
    eos_id: int
    pad_id: int
    # sha256 of the vocabulary files it was read from ("" for none)
    source_digest: str = ""

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


def file_digest(*paths: str) -> str:
    """sha256 over the bytes of ``paths``, in order."""
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def tokenizer_identity(tokenizer: Tokenizer) -> str:
    """What makes a tokenizer's ids: its class, its vocabulary size and
    the digest of its vocabulary files."""
    return (f"{type(tokenizer).__name__}:{tokenizer.vocab_size}:"
            f"{tokenizer.source_digest}")


# ---------------------------------------------------------------------------
# Byte fallback
# ---------------------------------------------------------------------------

class ByteTokenizer(Tokenizer):
    """ids 0..255 = bytes; 256 = BOS, 257 = EOS, 258 = PAD."""

    BOS, EOS, PAD = 256, 257, 258

    def __init__(self, vocab_size: int = 259) -> None:
        if vocab_size < 259:
            raise ValueError(f"byte tokenizer needs vocab >= 259, got "
                             f"{vocab_size}")
        self.vocab_size = vocab_size
        self.eos_id = self.EOS
        self.pad_id = self.PAD

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="ignore")


# ---------------------------------------------------------------------------
# Byte-level BPE (GPT-2) and word-level BPE with </w> (CLIP)
# ---------------------------------------------------------------------------

@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _bpe_merge(word: Tuple[str, ...], ranks: Dict[Tuple[str, str], int]
               ) -> Tuple[str, ...]:
    """Apply BPE merges to a symbol tuple until no ranked pair remains."""
    word = list(word)
    while len(word) > 1:
        pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
        if best not in ranks:
            break
        merged, i = [], 0
        while i < len(word):
            if (
                i < len(word) - 1
                and (word[i], word[i + 1]) == best
            ):
                merged.append(word[i] + word[i + 1])
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = merged
    return tuple(word)


class BPETokenizer(Tokenizer):
    """GPT-2-style byte-level BPE (``style='gpt2'``) or CLIP-style
    lowercased word BPE with ``</w>`` end-of-word markers
    (``style='clip'``)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 style: str = "gpt2") -> None:
        import re

        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.style = style
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.vocab_size = max(vocab.values()) + 1
        if style == "clip":
            self.bos_id = vocab.get("<|startoftext|>", 0)
            self.eos_id = vocab.get("<|endoftext|>", self.vocab_size - 1)
            self.pad_id = self.eos_id
        else:
            self.eos_id = vocab.get("<|endoftext|>", self.vocab_size - 1)
            self.pad_id = self.eos_id
        # Authentic split patterns (stdlib-re renderings of the published
        # ones; [^\W\d_] = unicode letter). GPT-2: contractions, space-
        # prefixed letter/digit/punct runs, then whitespace — with the
        # trailing-whitespace lookahead, and NO newline collapsing (the
        # real vocab carries Ġ/Ċ whitespace symbols). CLIP: punctuation
        # splits off words and every digit stands alone — real CLIP
        # tokenizes "depicting:" as depicting</w> :</w>, which the
        # checkpoint's merge table expects; whitespace-splitting would
        # mis-tokenize any word adjacent to punctuation under real
        # weights.
        # the published punct class is [^\s\p{L}\p{N}]+ which INCLUDES
        # '_' ('\w' would exclude it — an unmatched '_' silently
        # vanishes in finditer)
        self._word_re = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+"
            r"| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"
        )
        self._clip_re = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+")
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @staticmethod
    def from_files(vocab_path: str, merges_path: str,
                   style: str = "gpt2") -> "BPETokenizer":
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        tok = BPETokenizer(vocab, merges, style=style)
        tok.source_digest = file_digest(vocab_path, merges_path)
        return tok

    def _encode_word(self, chunk: str) -> List[int]:
        if chunk in self._cache:
            symbols = self._cache[chunk]
        else:
            sym = tuple(self.byte_enc[b] for b in chunk.encode("utf-8"))
            if self.style == "clip":
                # real CLIP byte-encodes the chunk too, then marks the
                # last symbol as word-final before merging
                sym = sym[:-1] + (sym[-1] + "</w>",)
            symbols = _bpe_merge(sym, self.ranks)
            self._cache[chunk] = symbols
        unk = self.vocab.get("<|unk|>", self.eos_id)
        return [self.vocab.get(s, unk) for s in symbols]

    def encode(self, text: str) -> List[int]:
        import re

        if self.style == "clip":
            # whitespace-clean + lowercase, as the published tokenizer
            text = re.sub(r"\s+", " ", text.strip()).lower()
            ids = [self.bos_id]
            for m in self._clip_re.finditer(text):
                ids.extend(self._encode_word(m.group(0)))
            return ids
        ids: List[int] = []
        for m in self._word_re.finditer(text):
            ids.extend(self._encode_word(m.group(0)))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts = [self.inv_vocab.get(int(i), "") for i in ids]
        text = "".join(parts)
        if self.style == "clip":
            for tok in ("<|startoftext|>", "<|endoftext|>"):
                text = text.replace(tok, "")
            # symbols are byte-encoded (mirror of encode), so strip the
            # word marks first, then byte-decode
            text = text.replace("</w>", " ")
        data = bytes(self.byte_dec.get(c, 32) for c in text)
        out = data.decode("utf-8", errors="ignore")
        return out.strip() if self.style == "clip" else out


# ---------------------------------------------------------------------------
# SentencePiece-BPE (Llama/Mistral family)
# ---------------------------------------------------------------------------

class SentencePieceBPETokenizer(Tokenizer):
    """SentencePiece-style BPE: ▁ word-boundary markers + <0xXX> byte
    fallback, loaded from an HF ``tokenizer.json`` (plain JSON — no
    sentencepiece/tokenizers wheel needed). Covers the Mistral/Llama vocab
    format for models/mistral.py."""

    WORD_MARK = "▁"  # ▁

    def __init__(self, vocab: Dict[str, int],
                 merges: List[Tuple[str, str]]) -> None:
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.vocab_size = max(vocab.values()) + 1
        self.unk_id = vocab.get("<unk>", 0)
        self.bos_id = vocab.get("<s>", 1)
        self.eos_id = vocab.get("</s>", 2)
        self.pad_id = self.eos_id
        self._byte_ids = {
            b: vocab[f"<0x{b:02X}>"]
            for b in range(256) if f"<0x{b:02X}>" in vocab
        }
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @staticmethod
    def from_file(tokenizer_json: str) -> "SentencePieceBPETokenizer":
        with open(tokenizer_json) as f:
            spec = json.load(f)
        model = spec["model"]
        vocab = dict(model["vocab"])
        merges = []
        for m in model.get("merges", []):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            if len(pair) == 2:
                merges.append(pair)
        for tok in spec.get("added_tokens", []):
            vocab.setdefault(tok["content"], tok["id"])
        tok = SentencePieceBPETokenizer(vocab, merges)
        tok.source_digest = file_digest(tokenizer_json)
        return tok

    def _encode_word(self, word: str) -> List[int]:
        """word (already ▁-prefixed) -> ids with byte fallback."""
        if word in self._cache:
            symbols = self._cache[word]
        else:
            symbols = _bpe_merge(tuple(word), self.ranks)
            self._cache[word] = symbols
        ids: List[int] = []
        for s in symbols:
            if s in self.vocab:
                ids.append(self.vocab[s])
            elif self._byte_ids:
                ids.extend(
                    self._byte_ids.get(b, self.unk_id)
                    for b in s.encode("utf-8")
                )
            else:
                ids.append(self.unk_id)
        return ids

    def _byte_fallback(self, s: str) -> List[int]:
        return [self._byte_ids.get(b, self.unk_id)
                for b in s.encode("utf-8")] if self._byte_ids \
            else [self.unk_id]

    def encode(self, text: str) -> List[int]:
        import re

        ids = [self.bos_id]
        # words get a ▁ mark when preceded by a space (or start-of-text,
        # SentencePiece's add_dummy_prefix); non-space whitespace
        # (\n, \t, ...) is structure the model saw in training — encode it
        # via byte fallback rather than silently dropping it
        prev_end, prev_char = 0, " "
        for m in re.finditer(r"[^\s]+|[^\S ]", text):
            if m.start() > prev_end:
                prev_char = text[m.start() - 1]
            chunk = m.group(0)
            if chunk.strip():
                marked = prev_char == " " or m.start() == 0
                ids.extend(self._encode_word(
                    (self.WORD_MARK if marked else "") + chunk
                ))
            else:
                ids.extend(self._byte_fallback(chunk))
            prev_end, prev_char = m.end(), chunk[-1]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        pending: List[int] = []  # byte-fallback run

        def flush():
            if pending:
                out.append(bytes(pending).decode("utf-8", errors="ignore"))
                pending.clear()

        for i in ids:
            tok = self.inv_vocab.get(int(i), "")
            if tok.startswith("<0x") and tok.endswith(">") and len(tok) == 6:
                pending.append(int(tok[3:5], 16))
                continue
            flush()
            if tok in ("<s>", "</s>", "<unk>", "<pad>"):
                continue
            out.append(tok.replace(self.WORD_MARK, " "))
        flush()
        return "".join(out).strip()


# ---------------------------------------------------------------------------
# WordPiece (BERT / MiniLM)
# ---------------------------------------------------------------------------

class WordPieceTokenizer(Tokenizer):
    def __init__(self, vocab: Dict[str, int]) -> None:
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.vocab_size = max(vocab.values()) + 1
        self.cls_id = vocab.get("[CLS]", 0)
        self.sep_id = vocab.get("[SEP]", 0)
        self.unk_id = vocab.get("[UNK]", 0)
        self.pad_id = vocab.get("[PAD]", 0)
        self.eos_id = self.sep_id

    @staticmethod
    def from_file(vocab_path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(vocab_path) as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        tok = WordPieceTokenizer(vocab)
        tok.source_digest = file_digest(vocab_path)
        return tok

    def _split_word(self, word: str) -> List[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        import re

        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        ids = [self.cls_id]
        for w in words:
            ids.extend(self._split_word(w))
        ids.append(self.sep_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts = []
        for i in ids:
            tok = self.inv_vocab.get(int(i), "")
            if tok in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if tok.startswith("##") and parts:
                parts[-1] += tok[2:]
            else:
                parts.append(tok)
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

TOKENIZER_KINDS = ("gpt2", "clip", "minilm", "mistral")


def load_tokenizer(kind: str, vocab_size: int,
                   weights_dir: Optional[str] = None) -> Tokenizer:
    """kind in {'gpt2', 'clip', 'minilm', 'mistral'}: the tokenizer the
    vocabulary files in ``weights_dir`` give, as the reference's
    ``load_tokenizer(weights_dir, kind, vocab_size)`` picks it; the byte
    fallback when they are missing."""
    if kind not in TOKENIZER_KINDS:
        raise ValueError(f"unknown tokenizer kind {kind!r}")
    if weights_dir:
        if kind in ("gpt2", "clip"):
            vocab = os.path.join(weights_dir, f"{kind}_vocab.json")
            merges = os.path.join(weights_dir, f"{kind}_merges.txt")
            if os.path.exists(vocab) and os.path.exists(merges):
                return BPETokenizer.from_files(vocab, merges, style=kind)
        if kind == "minilm":
            vocab_txt = os.path.join(weights_dir, "minilm_vocab.txt")
            if os.path.exists(vocab_txt):
                return WordPieceTokenizer.from_file(vocab_txt)
        if kind == "mistral":
            tok_json = os.path.join(weights_dir, "mistral_tokenizer.json")
            if os.path.exists(tok_json):
                return SentencePieceBPETokenizer.from_file(tok_json)
    return ByteTokenizer(max(vocab_size, 259))


def tokenize_clip_prompts(tokenizer: Tokenizer, prompts: Sequence[str],
                          pad_len: int, vocab_size: int) -> np.ndarray:
    """Right-padded CLIP token ids: encode, trim, append EOS, pad (the
    reference's ``serving/pipeline.py::tokenize_clip_prompts``)."""
    out = np.full((len(prompts), pad_len), tokenizer.pad_id, dtype=np.int32)
    for i, p in enumerate(prompts):
        toks = tokenizer.encode(p)[: pad_len - 1] + [tokenizer.eos_id]
        out[i, : len(toks)] = np.asarray(toks) % vocab_size
    return out
