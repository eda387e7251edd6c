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

Two more routes to the plain path, on every device:

- inside :func:`plain_only` (the counterpart of the reference's
  ``xla_only()``), every attention takes :func:`plain_attention`. The
  trainers enter it around each forward they differentiate: the flash
  kernel has no backward (``flash_attention`` raises on a CUDA input that
  requires grad), and the reference's trainers take XLA's attention too;
- on the card, unmasked attention whose inputs are not bf16 (the fp32 CLIP
  vision tower) takes :func:`plain_attention`, as the reference's TPU gates
  send such shapes to XLA: the kernel takes bf16 only. CPU tensors keep
  their route, the kernel's plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Iterator, Optional

import torch

from cassmantle_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
)


# Set inside plain_only(): every attention site takes plain_attention.
_PLAIN_ONLY = contextvars.ContextVar("cassmantle_plain_only", default=False)


@contextlib.contextmanager
def plain_only() -> Iterator[None]:
    """Route every attention in this context (this thread's, or a task's
    copied context) to :func:`plain_attention`: the counterpart of the
    reference's ``xla_only()``."""
    token = _PLAIN_ONLY.set(True)
    try:
        yield
    finally:
        _PLAIN_ONLY.reset(token)


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


def takes_flash(q_shape, k_shape, masked: bool, device_type: str,
                dtype: torch.dtype) -> bool:
    """The route of one attention: True for :func:`flash_attention` (the
    kernel on the card, its plain version on the CPU), False for
    :func:`plain_attention`."""
    if masked or len(q_shape) != 4 or q_shape[-1] > MAX_HEAD_DIM:
        return False
    if q_shape[-3] != k_shape[-3] and flash_cross_disabled():
        return False
    if _PLAIN_ONLY.get():
        return False
    # the kernel takes bf16; the CPU keeps its route (the plain version)
    return device_type != "cuda" or dtype == torch.bfloat16


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention entry point of every model. q (..., Sq, H, D); k, v
    (..., Sk, H, D); returns (..., Sq, H, D)."""
    if takes_flash(q.shape, k.shape, mask is not None, q.device.type,
                   q.dtype):
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, mask=mask, scale=scale)
