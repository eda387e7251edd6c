"""GPT-2-class causal LM for the round's prompt text.

Port of ``cassmantle_tpu/models/gpt2.py``: ``prefill`` over the
right-padded prompt bucket seeds a fixed-size KV cache, ``decode_step``
extends it one token at a time (``ops/decode.py`` drives the loop), and
``decode_chunk`` appends several tokens in one forward (speculative
decode's verify). Attention is masked, so it takes the plain path. Under
``lm_w8a8`` the q, k, v, out, fc1 and fc2 projections of every block run
the int8 matmul kernel with per-token activation scales.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from cassmantle_tpu_torch.config import GPT2Config
from cassmantle_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    MultiHeadAttention,
    TransformerMLP,
    chunk_causal_mask,
)
from cassmantle_tpu_torch.utils.device import torch_dtype

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        # per-token activation scales at the W8A8 projections: decode
        # activations carry per-position outliers
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadAttention(d, cfg.num_heads, act_per_token=True,
                                       dtype=dtype)
        self.ln2 = LayerNorm(d)
        self.mlp = TransformerMLP(d, 4 * d, act_per_token=True, dtype=dtype)

    def forward(self, x, mask=None, kv_cache=None, return_kv=False):
        out = self.attn(self.ln1(x), mask=mask, kv_cache=kv_cache,
                        return_kv=return_kv)
        a, kv = out if (kv_cache is not None or return_kv) else (out, None)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv


class GPT2LM(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        self.wpe = Embed(cfg.max_positions, cfg.hidden_size, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", GPT2Block(cfg, dtype))
        self.ln_f = LayerNorm(cfg.hidden_size)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        # weight-tied LM head in fp32 (keeps the greedy argmax stable)
        return hidden.float() @ self.wte.weight.float().T

    def forward(self, input_ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain causal forward: (B, S) [+ (B, S) validity: keys where it
        is False are masked] -> (B, S, V)."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(pos)
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=input_ids.device).tril()[None, None]
        if valid is not None:
            mask = mask & valid[:, None, None, :]
        for block in self.blocks():
            x, _ = block(x, mask=mask)
        return self._logits(self.ln_f(x))

    def new_cache(self, batch: int, max_len: int, device=None) -> Cache:
        """Zeroed per-layer (k, v) caches, each (batch, max_len, H, D) in
        the attention's dtype."""
        c = self.cfg
        shape = (batch, max_len, c.num_heads, c.hidden_size // c.num_heads)
        return [tuple(torch.zeros(shape, dtype=self.dtype, device=device)
                      for _ in range(2)) for _ in range(c.num_layers)]

    def prefill(self, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                max_len: int, cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """input_ids (B, P) right-padded, prompt_len (B,) -> (logits of
        the last real token (B, V), per-layer (k, v) caches, each
        (B, max_len, H, D), zero past P). A given ``cache``
        (:meth:`new_cache`) is written in place, so a decode graph that
        reads it sees the new prompt; else new caches are made."""
        b, p = input_ids.shape
        if p > max_len:
            raise ValueError(f"prompt bucket {p} > cache length {max_len}")
        if cache is None:
            cache = self.new_cache(b, max_len, input_ids.device)
        else:
            for ck, cv in cache:
                ck[:, p:].zero_()
                cv[:, p:].zero_()
        dev = input_ids.device
        positions = torch.arange(p, device=dev)[None, :]
        x = self.wte(input_ids) + self.wpe(positions)
        causal = torch.ones((p, p), dtype=torch.bool, device=dev).tril()
        valid = positions < prompt_len[:, None]
        mask = causal[None, None] & valid[:, None, None, :]
        for block, (ck, cv) in zip(self.blocks(), cache):
            x, (k, v) = block(x, mask=mask, return_kv=True)
            ck[:, :p] = k
            cv[:, :p] = v
        logits = self._logits(self.ln_f(x))
        last = logits[torch.arange(b, device=dev), prompt_len - 1]
        return last, cache

    def decode_step(self, token: torch.Tensor,
                    index: Union[int, torch.Tensor], cache: Cache,
                    valid: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One cached step: token (B,) at position ``index``, an int or
        a one-element int64 tensor on the device (the decode graph's
        form: no host value in the step); ``valid`` (B, max_len) marks the
        cache positions to attend, this one included. The caches update
        in place; returns (logits (B, V), cache)."""
        if isinstance(index, torch.Tensor):
            index = index.reshape(1)
            pos = index.reshape(1, 1)
        else:
            pos = torch.full((1, 1), index, dtype=torch.long,
                             device=token.device)
        x = self.wte(token[:, None]) + self.wpe(pos)
        mask = valid[:, None, None, :]
        new_cache: Cache = []
        for block, (ck, cv) in zip(self.blocks(), cache):
            x, kv = block(x, mask=mask, kv_cache=(ck, cv, index))
            new_cache.append(kv)
        return self._logits(self.ln_f(x))[:, 0], new_cache

    def decode_chunk(self, tokens: torch.Tensor,
                     index: Union[int, torch.Tensor], cache: Cache,
                     valid: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """S cached positions in one forward: tokens (B, S) at cache
        positions ``index .. index + S - 1`` (``index`` an int or a
        one-element int64 tensor on the device; the k/v append there by
        ``index_copy_``); ``valid`` (B, max_len) marks the positions to
        attend, the chunk's included, and query j attends only positions
        ``<= index + j`` (``chunk_causal_mask``), so logits[:, j] are what
        ``decode_step`` gives after tokens[:, :j + 1] one at a time. The
        caches update in place; returns (logits (B, S, V), cache)."""
        s = tokens.shape[1]
        if isinstance(index, torch.Tensor):
            index = index.reshape(1)
        positions = index + torch.arange(s, device=tokens.device)
        x = self.wte(tokens) + self.wpe(positions[None, :])
        mask = chunk_causal_mask(valid, index, s)
        new_cache: Cache = []
        for block, (ck, cv) in zip(self.blocks(), cache):
            x, kv = block(x, mask=mask, kv_cache=(ck, cv, positions))
            new_cache.append(kv)
        return self._logits(self.ln_f(x)), new_cache
