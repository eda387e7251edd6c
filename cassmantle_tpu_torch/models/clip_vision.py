"""CLIP vision tower (ViT), for the CLIP-similarity quality gate.

Port of ``cassmantle_tpu/models/clip_vision.py``: patch embedding without
bias, a class token, learned positions, pre-LN transformer blocks with
quick-GELU, the class token's final LayerNorm and a projection into the
shared text-image space; the output is unit-norm (``/ (norm + 1e-8)``).
The full size is ViT-L/14 at 224x224 (24 layers, width 1024, 16 heads,
projection 768), in fp32 as the reference runs it. On the card its
attention takes the plain path: the flash kernel takes bf16 only
(``ops/attention.py``). Submodules and parameters carry the Flax names
(``patch_embed``, ``class_embedding``, ``position_embedding``, ``pre_ln``,
``block_i``, ``post_ln``, ``projection``), so ``models/weights.py::
from_jax("clip_vision", ...)`` maps the reference's tree.

:func:`preprocess_for_clip` resizes with the reference's own filter:
``jax.image.resize(..., "cubic")`` is the Keys cubic kernel (a = -0.5),
widened by the scale when it shrinks (antialiased), normalized per output
pixel; :func:`resize_weights` builds that (in, out) matrix per axis in
float32 as JAX does, and the resize is two products.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cassmantle_tpu_torch.models.layers import (
    LayerNorm,
    MultiHeadAttention,
    TransformerMLP,
    quick_gelu,
)
from cassmantle_tpu_torch.utils.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    dtype: str = "float32"

    @staticmethod
    def tiny() -> "ClipVisionConfig":
        return ClipVisionConfig(
            image_size=32, patch_size=8, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            projection_dim=64)


class PatchEmbed(nn.Module):
    """Flax ``nn.Conv(hidden, (p, p), strides=p, use_bias=False)`` on an
    image whose side is a multiple of p: weight (hidden, 3, p, p)."""

    def __init__(self, channels: int, patch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(channels, 3, patch, patch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight[0].numel() ** -0.5,
                                generator=generator)

    def forward(self, images_nchw: torch.Tensor) -> torch.Tensor:
        return F.conv2d(images_nchw.to(self.dtype),
                        self.weight.to(self.dtype), stride=self.patch)


class ClipVisionBlock(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadAttention(d, cfg.num_heads, fused_qkv=True,
                                       dtype=dtype)
        self.ln2 = LayerNorm(d)
        self.mlp = TransformerMLP(d, cfg.intermediate_size,
                                  activation=quick_gelu, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ClipVisionEncoder(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        d = cfg.hidden_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(d, cfg.patch_size, dtype)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(torch.empty(n_pos, d))
        self.pre_ln = LayerNorm(d)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ClipVisionBlock(cfg, dtype))
        self.post_ln = LayerNorm(d)
        self.projection = nn.Parameter(torch.empty(d, cfg.projection_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.class_embedding, self.position_embedding,
                      self.projection):
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images normalized to CLIP's statistics -> (B, P)
        unit embeddings in the shared text-image space (fp32)."""
        cfg, dtype = self.cfg, self.dtype
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
        cls = self.class_embedding.to(dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None].to(
            dtype)
        x = self.pre_ln(x)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        pooled = self.post_ln(x[:, 0])
        emb = pooled @ self.projection.float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                      + 1e-8)


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    one, f = np.float32(1.0), np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + one
    out = np.where(x >= one, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= f(2.0), f(0.0), out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(...,
    "cubic", antialias=True)`` along one axis (JAX's
    ``compute_weight_mat`` at translation 0)."""
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + f(0.5)) * inv_scale
                - f(0.0) * inv_scale - f(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)
               [:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > f(1000.0) * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample_f >= f(-0.5)) & (sample_f <= f(in_size) - f(0.5))
    return np.where(inside[None, :], weights, f(0.0)).astype(np.float32)


def preprocess_for_clip(images_u8: torch.Tensor,
                        size: int = 224) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> resized to ``size`` x ``size``, clamped to
    [0, 1] (the published transform resizes uint8) and CLIP-normalized,
    float32, on the images' device."""
    x = images_u8.float() / 255.0
    _, h, w, _ = x.shape
    dev = x.device
    if h != size:
        x = torch.einsum("bhwc,hi->biwc", x, torch.from_numpy(
            resize_weights(h, size)).to(dev))
    if w != size:
        x = torch.einsum("bhwc,wj->bhjc", x, torch.from_numpy(
            resize_weights(w, size)).to(dev))
    x = x.clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=dev)
    return (x - mean) / std
