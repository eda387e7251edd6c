"""Mistral-7B-class causal LM: RoPE, grouped-query attention, a sliding
attention window, RMSNorm and a SwiGLU MLP.

Port of ``cassmantle_tpu/models/mistral.py``, with the GPT-2 port's serving
contract (``models/gpt2.py``): ``prefill`` over the right-padded prompt
bucket seeds a fixed-size KV cache (written in place when given), and
``decode_chunk`` appends S tokens at a cache position that may be a device
tensor, so a CUDA graph's step reads it there; ``decode_step`` is its
S = 1 case. The fp32 places are the reference's: RMSNorm statistics,
the RoPE tables and rotation, the attention softmax and the LM head.

- GQA: k and v project to ``num_kv_heads`` heads and the cache holds them
  at that width; they repeat to the query heads only at the attention
  (``repeat_kv``, a broadcast view copied by ``reshape``: no host value,
  so it can be captured).
- RoPE (split-half convention) is applied to q and k before caching.
- The sliding window is a band mask: query position q attends key
  position k iff 0 <= q - k < window.

Attention is always masked, so it takes the plain path
(``ops/attention.py::plain_attention``), as the reference's takes XLA's.
Module names are the Flax ones (``embed``, ``block_{i}/ln1|attn/{q,k,v,out}
|ln2|mlp/{gate,up,down}``, ``ln_f``, ``lm_head``), so ``from_jax`` maps
the tree mechanically. The context-parallel ``positions`` form of the
reference's forward serves only its trainer and is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from cassmantle_tpu_torch.config import MistralConfig
from cassmantle_tpu_torch.models.layers import Dense, Embed, chunk_causal_mask
from cassmantle_tpu_torch.ops.attention import multi_head_attention
from cassmantle_tpu_torch.utils.device import torch_dtype

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean, no bias) in fp32, returned in the
    input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + self.eps)
        return (out * self.weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, fp32: positions (..., S) ->
    two (..., S, head_dim / 2)."""
    half = head_dim // 2
    # in fp64, divided by a device tensor, then rounded: the correctly
    # rounded fp32 frequencies on every device (fp32 pow is an ulp off at
    # times on the CPU, and the error grows with the position)
    steps = torch.arange(half, dtype=torch.float64, device=positions.device)
    freqs = steps.new_full((), theta).pow(
        -steps / steps.new_full((), half)).float()
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotary embedding, split-half (GPT-NeoX, Mistral/Llama) convention,
    in fp32: x (..., S, H, D); cos/sin (..., S, D/2) broadcast over the
    heads."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., S, KVH, D) -> (..., S, KVH * n_rep, D), each head repeated
    n_rep times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return kv
    *lead, kvh, d = kv.shape
    return kv[..., None, :].expand(*lead, kvh, n_rep, d).reshape(
        *lead, kvh * n_rep, d)


def band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int
              ) -> torch.Tensor:
    """Causal sliding-window mask: (Sq, Sk) bool, True iff
    0 <= q - k < window."""
    diff = q_pos[:, None] - k_pos[None, :]
    return (diff >= 0) & (diff < window)


class MistralAttention(nn.Module):
    def __init__(self, cfg: MistralConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, hidden = cfg.head_dim, cfg.hidden_size
        self.q = Dense(hidden, cfg.num_heads * d, False, dtype)
        self.k = Dense(hidden, cfg.num_kv_heads * d, False, dtype)
        self.v = Dense(hidden, cfg.num_kv_heads * d, False, dtype)
        self.out = Dense(cfg.num_heads * d, hidden, False, dtype)

    def forward(self, x, cos, sin, mask, kv_cache=None,
                return_kv: bool = False):
        """Full mode returns out, or (out, (k, v)) with ``return_kv``.
        Decode mode (``kv_cache=(cache_k, cache_v, positions)``, the
        caches (B, max_len, KVH, D) and ``positions`` an int64 tensor of
        this call's cache positions) writes the RoPE'd k and v there IN
        PLACE and attends over the whole cache under ``mask``; returns
        (out, (cache_k, cache_v))."""
        c = self.cfg
        q = apply_rope(self.q(x).unflatten(-1, (c.num_heads, c.head_dim)),
                       cos, sin)
        k = apply_rope(self.k(x).unflatten(-1, (c.num_kv_heads, c.head_dim)),
                       cos, sin)
        v = self.v(x).unflatten(-1, (c.num_kv_heads, c.head_dim))
        kv_out = None
        if kv_cache is not None:
            cache_k, cache_v, positions = kv_cache
            cache_k.index_copy_(1, positions, k.to(cache_k.dtype))
            cache_v.index_copy_(1, positions, v.to(cache_v.dtype))
            k, v = cache_k, cache_v
            kv_out = (cache_k, cache_v)
        elif return_kv:
            kv_out = (k, v)
        n_rep = c.num_heads // c.num_kv_heads
        out = multi_head_attention(q, repeat_kv(k, n_rep),
                                   repeat_kv(v, n_rep), mask=mask)
        out = self.out(out.flatten(-2))
        return out if kv_out is None else (out, kv_out)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, features: int, intermediate: int, dtype: torch.dtype):
        super().__init__()
        self.gate = Dense(features, intermediate, False, dtype)
        self.up = Dense(features, intermediate, False, dtype)
        self.down = Dense(intermediate, features, False, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class MistralBlock(nn.Module):
    def __init__(self, cfg: MistralConfig, dtype: torch.dtype):
        super().__init__()
        self.ln1 = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.attn = MistralAttention(cfg, dtype)
        self.ln2 = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype)

    def forward(self, x, cos, sin, mask, kv_cache=None, return_kv=False):
        out = self.attn(self.ln1(x), cos, sin, mask, kv_cache=kv_cache,
                        return_kv=return_kv)
        a, kv = out if (kv_cache is not None or return_kv) else (out, None)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv


class MistralLM(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", MistralBlock(cfg, dtype))
        self.ln_f = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        # fp32 head: keeps the greedy argmax stable under bf16 activations
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, False,
                             torch.float32)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    def _rope(self, positions: torch.Tensor):
        return rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden.float())

    def forward(self, input_ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain forward: (B, S) [+ (B, S) validity] -> (B, S, V)."""
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)
        mask = band_mask(positions, positions,
                         self.cfg.sliding_window)[None, None]
        if valid is not None:
            mask = mask & valid[:, None, None, :]
        cos, sin = self._rope(positions)
        x = self.embed(input_ids)
        for block in self.blocks():
            x, _ = block(x, cos, sin, mask)
        return self._logits(self.ln_f(x))

    def new_cache(self, batch: int, max_len: int, device=None) -> Cache:
        """Zeroed per-layer (k, v) caches, each (batch, max_len, KVH, D) in
        the attention's dtype."""
        c = self.cfg
        shape = (batch, max_len, c.num_kv_heads, c.head_dim)
        return [tuple(torch.zeros(shape, dtype=self.dtype, device=device)
                      for _ in range(2)) for _ in range(c.num_layers)]

    def prefill(self, input_ids: torch.Tensor, prompt_len: torch.Tensor,
                max_len: int, cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """input_ids (B, P) right-padded, prompt_len (B,) -> (logits of
        the last real token (B, V), per-layer (k, v) caches, each
        (B, max_len, KVH, D) with RoPE applied to k, zero past P). A given
        ``cache`` (:meth:`new_cache`) is written in place."""
        b, p = input_ids.shape
        if p > max_len:
            raise ValueError(f"prompt bucket {p} > cache length {max_len}")
        dev = input_ids.device
        if cache is None:
            cache = self.new_cache(b, max_len, dev)
        else:
            for ck, cv in cache:
                ck[:, p:].zero_()
                cv[:, p:].zero_()
        positions = torch.arange(p, device=dev)
        band = band_mask(positions, positions, self.cfg.sliding_window)
        valid = positions[None, :] < prompt_len[:, None]
        mask = band[None, None] & valid[:, None, None, :]
        cos, sin = self._rope(positions)
        x = self.embed(input_ids)
        for block, (ck, cv) in zip(self.blocks(), cache):
            x, (k, v) = block(x, cos, sin, mask, return_kv=True)
            ck[:, :p] = k
            cv[:, :p] = v
        logits = self._logits(self.ln_f(x))
        return logits[torch.arange(b, device=dev), prompt_len - 1], cache

    def decode_chunk(self, tokens: torch.Tensor,
                     index: Union[int, torch.Tensor], cache: Cache,
                     valid: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """S cached positions in one forward: tokens (B, S) at cache
        positions ``index .. index + S - 1`` (``index`` an int or a
        one-element int64 tensor on the device); ``valid`` (B, max_len)
        marks the positions to attend, the chunk's included. RoPE follows
        the true positions and each query keeps its own sliding window
        (``chunk_causal_mask``). The caches update in place; returns
        (logits (B, S, V), cache)."""
        s = tokens.shape[1]
        if isinstance(index, torch.Tensor):
            index = index.reshape(1)
        mask = chunk_causal_mask(valid, index, s,
                                 window=self.cfg.sliding_window)
        positions = index + torch.arange(s, device=tokens.device)
        cos, sin = self._rope(positions[None, :])
        x = self.embed(tokens)
        new_cache: Cache = []
        for block, (ck, cv) in zip(self.blocks(), cache):
            x, kv = block(x, cos, sin, mask, kv_cache=(ck, cv, positions))
            new_cache.append(kv)
        return self._logits(self.ln_f(x)), new_cache

    def decode_step(self, token: torch.Tensor,
                    index: Union[int, torch.Tensor], cache: Cache,
                    valid: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One cached step, the S = 1 case of :meth:`decode_chunk`:
        token (B,) -> (logits (B, V), cache)."""
        logits, cache = self.decode_chunk(token[:, None], index, cache, valid)
        return logits[:, 0], cache
