"""CLIP text encoder (SD's text tower).

Port of ``cassmantle_tpu/models/clip_text.py``: pre-LN causal transformer
with learned positions and quick-GELU (CLIP ViT-L/14's text model). SDXL's
second tower (OpenCLIP bigG, exact GELU) is the same module at
``ClipTextConfig.sdxl_big()`` dimensions. The reference's pipelines run it
in fp32 over parameters stored in ``param_dtype``; so do the port's.
"""

from __future__ import annotations

import torch
from torch import nn

from cassmantle_tpu_torch.config import ClipTextConfig
from cassmantle_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    MultiHeadAttention,
    TransformerMLP,
    exact_gelu,
    quick_gelu,
)

_ACTS = {"quick_gelu": quick_gelu, "gelu": exact_gelu}


class ClipBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadAttention(d, cfg.num_heads, fused_qkv=True,
                                       dtype=dtype)
        self.ln2 = LayerNorm(d)
        self.mlp = TransformerMLP(d, cfg.intermediate_size,
                                  activation=_ACTS[cfg.hidden_act],
                                  dtype=dtype)

    def forward(self, x, mask):
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.mlp(self.ln2(x))


class ClipTextEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_positions, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ClipBlock(cfg, dtype))
        self.ln_final = LayerNorm(cfg.hidden_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, input_ids: torch.Tensor) -> dict:
        """input_ids (B, S) -> {hidden: (B, S, D), pooled: (B, D),
        penultimate: (B, S, D)}. ``penultimate`` is the state after block
        ``num_layers - 2``, without the final LayerNorm: SDXL conditions
        its UNet on it (diffusers' ``hidden_states[-2]``)."""
        seq = input_ids.shape[1]
        x = self.token_embedding(input_ids) \
            + self.position_embedding[None, :seq].to(self.dtype)
        causal = torch.ones((seq, seq), dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        penultimate = x
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, causal)
            if i == self.cfg.num_layers - 2:
                penultimate = x
        hidden = self.ln_final(x)
        # CLIP pools at the EOT token, the highest id of each row
        eot = input_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0]), eot]
        return {"hidden": hidden.to(self.dtype),
                "pooled": pooled.to(self.dtype),
                "penultimate": penultimate.to(self.dtype)}
