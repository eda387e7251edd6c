"""Batched embedding similarity scorer (MiniLM on the device).

Port of the device rung of ``cassmantle_tpu/ops/scorer.py::
EmbeddingScorer``: guesses and answers tokenize on the host, pad into one
of a few fixed (batch, seq) buckets, embed in one device call per bucket
chunk and score as a cosine. The reference's int8 wordlist table and
host LRU (rungs above the device) come in a later slice.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.config import MiniLMConfig
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.minilm import MiniLMEncoder
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device
from cassmantle_tpu_torch.utils.tokenizers import load_tokenizer

# Seed offset of the scorer's random init (the reference's init slot).
INIT_SEED = 7


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class EmbeddingScorer:
    """Owns the encoder, its tokenizer and the batch buckets."""

    def __init__(self, cfg: MiniLMConfig, device: DeviceLike = "cuda",
                 seq_len: int = 16,
                 batch_buckets: Sequence[int] = (8, 64, 256, 1024),
                 state_dict: Optional[Mapping] = None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seq_len = min(seq_len, cfg.max_positions)
        self.batch_buckets = tuple(batch_buckets)
        self.tokenizer = load_tokenizer("minilm", cfg.vocab_size)
        with torch.device(self.device):
            self.model = MiniLMEncoder(cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            gen = torch.Generator(self.device).manual_seed(seed + INIT_SEED)
            init_weights(self.model, gen)
        self.model.eval()

    def _tokenize_batch(self, texts: Sequence[str], batch: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((batch, self.seq_len), self.tokenizer.pad_id,
                      dtype=np.int64)
        mask = np.zeros((batch, self.seq_len), dtype=np.int64)
        for i, text in enumerate(texts):
            toks = self.tokenizer.encode(text)[: self.seq_len]
            if not toks:
                toks = [self.tokenizer.pad_id]
            ids[i, : len(toks)] = np.asarray(toks) % self.cfg.vocab_size
            mask[i, : len(toks)] = 1
        return ids, mask

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(n,) texts -> (n, D) unit embeddings, fp32 host array."""
        n = len(texts)
        if n == 0:
            return np.zeros((0, self.cfg.hidden_size), dtype=np.float32)
        batch = pick_bucket(n, self.batch_buckets)
        chunks = []
        for start in range(0, n, batch):
            chunk = texts[start:start + batch]
            ids, mask = self._tokenize_batch(chunk, batch)
            with torch.inference_mode():
                emb = self.model(torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))
            chunks.append(emb[: len(chunk)].cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def similarity(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """[(guess, answer)] -> cosine similarity per pair, one device
        batch for all guesses and answers."""
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        texts = [g for g, _ in pairs] + [a for _, a in pairs]
        emb = self.embed(texts)
        n = len(pairs)
        return np.sum(emb[:n] * emb[n:], axis=-1)
