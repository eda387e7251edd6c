"""Attention dispatch: the plain masked path and the flash kernel.

Port of ``cassmantle_tpu/ops/attention.py``. Every attention site of the
model zoo goes through :func:`multi_head_attention`:

- no mask (the UNet's self and cross attention, the VAE mid block), any
  sequence length, head dim up to 512 -> :func:`flash_attention` (the CUDA
  kernel on the card, its plain version on the CPU). The TPU module's
  1024-block shape gates existed for the TPU's tiles and are not copied;
- a mask (CLIP causal, GPT-2 causal with the KV cache, MiniLM padding) ->
  :func:`plain_attention`, the counterpart of ``xla_attention``: einsum,
  fp32 softmax, einsum.

``CASSMANTLE_NO_FLASH_CROSS=1`` sends cross attention (Sq != Sk) to the
plain path, as in the reference.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from cassmantle_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (..., Sq, H, D), k/v (..., Sk, H, D). ``mask`` broadcasts against
    (..., H, Sq, Sk); True = attend. Logits in the input dtype, softmax in
    fp32, weights cast to v's dtype — as ``xla_attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", weights, v)


def flash_cross_disabled() -> bool:
    return os.environ.get("CASSMANTLE_NO_FLASH_CROSS", "").lower() \
        not in ("", "0", "false", "no", "off")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention entry point of every model. q (..., Sq, H, D); k, v
    (..., Sk, H, D); returns (..., Sq, H, D)."""
    s_q, s_k = q.shape[-3], k.shape[-3]
    if (mask is None and q.ndim == 4 and q.shape[-1] <= MAX_HEAD_DIM
            and not (s_q != s_k and flash_cross_disabled())):
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, mask=mask, scale=scale)
