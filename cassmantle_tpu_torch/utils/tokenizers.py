"""Tokenizers of the port.

Copy of the byte fallback of ``cassmantle_tpu/utils/tokenizers.py``: the
repository ships no vocabulary files, so the reference's
``load_tokenizer`` returns :class:`ByteTokenizer` for every model, and so
does this one. The BPE, WordPiece and SentencePiece tokenizers
come with real checkpoints.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Tokenizer:
    vocab_size: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


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


def load_tokenizer(kind: str, vocab_size: int) -> Tokenizer:
    """kind in {'gpt2', 'clip', 'minilm', 'mistral'}: the byte fallback, as
    the reference's ``load_tokenizer`` gives without vocabulary files."""
    if kind not in ("gpt2", "clip", "minilm", "mistral"):
        raise ValueError(f"unknown tokenizer kind {kind!r}")
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
