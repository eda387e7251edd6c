"""MiniLM-class sentence encoder for guess scoring.

Port of ``cassmantle_tpu/models/minilm.py``: BERT-style post-LN encoder,
masked mean pooling and L2 normalisation (the all-MiniLM-L6-v2 recipe),
fp32 throughout. Padding-masked attention takes the plain path.
"""

from __future__ import annotations

import torch
from torch import nn

from cassmantle_tpu_torch.config import MiniLMConfig
from cassmantle_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    MultiHeadAttention,
    TransformerMLP,
    exact_gelu,
)
from cassmantle_tpu_torch.utils.device import torch_dtype


class BertBlock(nn.Module):
    """Post-LN transformer block (BERT convention)."""

    def __init__(self, cfg: MiniLMConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.attn = MultiHeadAttention(d, cfg.num_heads, fused_qkv=True,
                                       dtype=dtype)
        self.ln1 = LayerNorm(d, eps=1e-12)
        self.mlp = TransformerMLP(d, cfg.intermediate_size,
                                  activation=exact_gelu, dtype=dtype)
        self.ln2 = LayerNorm(d, eps=1e-12)

    def forward(self, x, mask):
        x = self.ln1(x + self.attn(x, mask=mask))
        return self.ln2(x + self.mlp(x))


class MiniLMEncoder(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_positions, cfg.hidden_size))
        self.embed_ln = LayerNorm(cfg.hidden_size, eps=1e-12)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", BertBlock(cfg, dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.position_embeddings.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, S) ids + (B, S) 0/1 mask -> (B, D) unit-norm embeddings."""
        s = input_ids.shape[1]
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings[None, :s].to(self.dtype)
        x = self.embed_ln(x)
        attend = attention_mask.bool()[:, None, None, :]
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, attend)
        weights = attention_mask.float()[..., None]
        pooled = (x.float() * weights).sum(dim=1) / (
            weights.sum(dim=1) + 1e-9)
        return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)
