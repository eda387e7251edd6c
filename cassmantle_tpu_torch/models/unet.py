"""Diffusion UNet at SD1.5 and SDXL geometry.

Port of ``cassmantle_tpu/models/unet.py``: the plain forward and the
reference's two feature-reuse mode pairs, DeepCache (``return_deep`` /
``deep_cache``) and encoder propagation (``return_skips`` /
``skips_cache``). The public layout is the reference's: latents
(B, H, W, 4) NHWC in, eps (B, H, W, 4) fp32 out; inside, activations are
NCHW, and the caches the modes hand out are those NCHW activations (the
reference's NHWC ones, permuted). bf16 parameters and
activations, fp32 GroupNorm/LayerNorm statistics, fp32 softmax, fp32
``conv_out``. Every attention site (16 transformer blocks at SD1.5, 70 at
SDXL, one self and one cross attention each) runs the flash kernel on the
card. With ``addition_embed_dim`` (SDXL) the micro-conditioning vector
(pooled text ++ size/crop time ids) goes through ``add_fc1`` -> SiLU ->
``add_fc2`` into the time embedding.

With ``UNetConfig.fused_conv`` every ResBlock's GroupNorm -> SiLU ->
conv3x3 runs as one fused kernel (``layers.fused_gn_silu_conv3x3``), or as
the int8 conv once the W8A8 transform quantized it; the parameters are
the same. That UNet runs channels-last (NHWC memory under NCHW shapes),
which the fused kernels read without a copy; the default path is as it
was.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cassmantle_tpu_torch.config import UNetConfig
from cassmantle_tpu_torch.ops.fused_conv import kill_switch_set
from cassmantle_tpu_torch.ops.quant import quantized_weight
from cassmantle_tpu_torch.models.layers import (
    GEGLU,
    Conv,
    Conv3x3Params,
    Dense,
    GroupNorm32,
    LayerNorm32,
    MultiHeadAttention,
    fused_gn_silu_conv3x3,
    nearest_upsample_2x,
    timestep_embedding,
)
from cassmantle_tpu_torch.utils.device import torch_dtype


class ResBlock(nn.Module):
    """GN/SiLU/conv3x3 x2 + time injection + skip.

    ``fused_conv`` runs each GN/SiLU/conv3x3 as one fused kernel (W8A8
    sites as the int8 conv); CASSMANTLE_NO_FUSED_CONV, read per call,
    sends plain weights down the unfused path instead."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 dtype: torch.dtype, fused_conv: bool = False,
                 conv_pad_to: int = 0):
        super().__init__()
        self.fused_conv = fused_conv
        self.conv_pad_to = conv_pad_to
        conv3 = (Conv3x3Params if fused_conv
                 else lambda i, o, dtype: Conv(i, o, 3, dtype=dtype))
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = conv3(in_channels, out_channels, dtype=dtype)
        self.time_proj = Dense(temb_dim, out_channels, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = conv3(out_channels, out_channels, dtype=dtype)
        self.skip = (Conv(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def _gn_silu_conv(self, x, norm, conv):
        if self.fused_conv and (quantized_weight(conv) is not None
                                or not kill_switch_set()):
            return fused_gn_silu_conv3x3(x, norm, conv, self.conv_pad_to)
        return conv(F.silu(norm(x)))

    def forward(self, x, temb):
        h = self._gn_silu_conv(x, self.norm1, self.conv1)
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = self._gn_silu_conv(h, self.norm2, self.conv2)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class BasicTransformerBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        # bias-free q/k/v, biased out projection (the published layout)
        self.ln1 = LayerNorm32(channels)
        self.self_attn = MultiHeadAttention(
            channels, num_heads, use_bias=False, out_bias=True,
            fused_qkv=True, dtype=dtype)
        self.ln2 = LayerNorm32(channels)
        self.cross_attn = MultiHeadAttention(
            channels, num_heads, context_dim=context_dim, use_bias=False,
            out_bias=True, fused_qkv=True, dtype=dtype)
        self.ln3 = LayerNorm32(channels)
        self.ff = GEGLU(channels, 4 * channels, dtype=dtype)

    def forward(self, x, context):
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), context=context)
        return x + self.ff(self.ln3(x))


class SpatialTransformer(nn.Module):
    """Flatten HW into tokens, run the transformer blocks, fold back."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 context_dim: int, dtype: torch.dtype):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Dense(channels, channels, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                channels, num_heads, context_dim, dtype))
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context)
        x = self.proj_out(x)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        base, temb_dim = cfg.base_channels, cfg.time_embed_dim
        levels = len(cfg.channel_mults)

        def attn_at(lvl: int) -> bool:
            return bool(cfg.attention_levels[lvl]
                        and cfg.transformer_depth[lvl])

        def transformer(ch: int, depth: int) -> SpatialTransformer:
            return SpatialTransformer(ch, self._heads(ch), depth,
                                      cfg.context_dim, dtype)

        def res(c_in: int, c_out: int) -> ResBlock:
            return ResBlock(c_in, c_out, temb_dim, dtype, cfg.fused_conv,
                            cfg.conv_pad_to)

        self.time_fc1 = Dense(base, temb_dim, dtype=dtype)
        self.time_fc2 = Dense(temb_dim, temb_dim, dtype=dtype)
        if cfg.addition_embed_dim:
            self.add_fc1 = Dense(cfg.addition_embed_dim, temb_dim,
                                 dtype=dtype)
            self.add_fc2 = Dense(temb_dim, temb_dim, dtype=dtype)
        self.conv_in = Conv(cfg.sample_channels, base, 3, dtype=dtype)

        ch_in = base
        skip_channels: List[int] = [base]
        for lvl in range(levels):
            ch = base * cfg.channel_mults[lvl]
            for blk in range(cfg.blocks_per_level):
                self.add_module(f"down_{lvl}_res_{blk}", res(ch_in, ch))
                ch_in = ch
                if attn_at(lvl):
                    self.add_module(f"down_{lvl}_attn_{blk}",
                                    transformer(ch, cfg.transformer_depth[lvl]))
                skip_channels.append(ch)
            if lvl != levels - 1:
                self.add_module(f"down_{lvl}_downsample",
                                Conv(ch, ch, 3, stride=2, dtype=dtype))
                skip_channels.append(ch)

        mid_ch = base * cfg.channel_mults[-1]
        mid_depth = max([d for lvl, d in enumerate(cfg.transformer_depth)
                         if cfg.attention_levels[lvl]] or [1])
        self.mid_res_0 = res(ch_in, mid_ch)
        self.mid_attn = transformer(mid_ch, mid_depth)
        self.mid_res_1 = res(mid_ch, mid_ch)
        ch_in = mid_ch

        for lvl in reversed(range(levels)):
            ch = base * cfg.channel_mults[lvl]
            for blk in range(cfg.blocks_per_level + 1):
                self.add_module(f"up_{lvl}_res_{blk}",
                                res(ch_in + skip_channels.pop(), ch))
                ch_in = ch
                if attn_at(lvl):
                    self.add_module(f"up_{lvl}_attn_{blk}",
                                    transformer(ch, cfg.transformer_depth[lvl]))
            if lvl != 0:
                self.add_module(f"up_{lvl}_upsample",
                                Conv(ch, ch, 3, dtype=dtype))

        self.norm_out = GroupNorm32(ch_in)
        self.conv_out = Conv(ch_in, cfg.sample_channels, 3,
                             dtype=torch.float32)
        if cfg.fused_conv:
            self.to(memory_format=torch.channels_last)

    def _heads(self, channels: int) -> int:
        if self.cfg.num_heads is not None:
            return self.cfg.num_heads
        return max(1, channels // 64)

    def forward(self, latents: Optional[torch.Tensor],
                timesteps: torch.Tensor, context: torch.Tensor,
                addition_embeds: Optional[torch.Tensor] = None,
                deep_cache: Optional[torch.Tensor] = None,
                return_deep: bool = False,
                skips_cache: Optional[Tuple[Sequence[torch.Tensor],
                                            torch.Tensor]] = None,
                return_skips: bool = False):
        """latents (B, H, W, 4), timesteps (B,), context (B, S, Dc),
        addition_embeds (B, A) or None -> eps (B, H, W, 4) fp32. The
        additions count only where the config has ``addition_embed_dim``,
        as in the reference.

        Feature reuse, as the reference's forward:
        - ``return_deep``: also return the activation entering level 0 of
          the up path (after level 1's upsample conv); ``deep_cache=``
          that activation runs conv_in, the level-0 down blocks, then the
          level-0 up blocks from it, skipping every deeper level and the
          mid block.
        - ``return_skips``: also return ``(skip stack, up-path entry)``,
          the down path's skips and the mid block's output;
          ``skips_cache=`` that pair runs the up path alone against it,
          with a fresh time embedding (``latents`` may be None).
        Both return flags combine (eps, deep, (skips, entry)); the two
        cache inputs exclude each other."""
        cfg, dtype = self.cfg, self.dtype
        levels = len(cfg.channel_mults)
        decoder_only = skips_cache is not None
        shallow_only = deep_cache is not None
        assert not (decoder_only and shallow_only), (
            "deep_cache and skips_cache are mutually exclusive modes")
        assert latents is not None or decoder_only, (
            "latents may be None only with skips_cache")
        assert not (return_skips and (shallow_only or decoder_only)), (
            "return_skips needs the full encoder to have run")
        context = context.to(dtype)
        temb = timestep_embedding(timesteps, cfg.base_channels)
        temb = self.time_fc2(F.silu(self.time_fc1(temb.to(dtype))))
        if cfg.addition_embed_dim and addition_embeds is not None:
            temb = temb + self.add_fc2(F.silu(self.add_fc1(
                addition_embeds.to(dtype))))

        if decoder_only:
            cached_skips, up_entry = skips_cache
            skips = [s.to(dtype) for s in cached_skips]
            x = up_entry.to(dtype)
        else:
            x = latents.to(dtype).permute(0, 3, 1, 2)
            if cfg.fused_conv:
                x = x.contiguous(memory_format=torch.channels_last)
            x = self.conv_in(x)
            skips = [x]
            for lvl in range(1 if shallow_only else levels):
                for blk in range(cfg.blocks_per_level):
                    x = getattr(self, f"down_{lvl}_res_{blk}")(x, temb)
                    attn = getattr(self, f"down_{lvl}_attn_{blk}", None)
                    if attn is not None:
                        x = attn(x, context)
                    skips.append(x)
                if lvl != levels - 1 and not shallow_only:
                    x = getattr(self, f"down_{lvl}_downsample")(x)
                    skips.append(x)
        skips_out = tuple(skips) if return_skips else None

        if not shallow_only and not decoder_only:
            x = self.mid_res_0(x, temb)
            x = self.mid_attn(x, context)
            x = self.mid_res_1(x, temb)
        up_entry_out = x if return_skips else None

        deep_out = None
        if shallow_only:
            x = deep_cache.to(dtype)
        for lvl in [0] if shallow_only else reversed(range(levels)):
            if lvl == 0 and return_deep:
                deep_out = x
            for blk in range(cfg.blocks_per_level + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = getattr(self, f"up_{lvl}_res_{blk}")(x, temb)
                attn = getattr(self, f"up_{lvl}_attn_{blk}", None)
                if attn is not None:
                    x = attn(x, context)
            if lvl != 0:
                x = getattr(self, f"up_{lvl}_upsample")(
                    nearest_upsample_2x(x))

        assert not skips, f"unconsumed skips: {len(skips)}"

        x = self.conv_out(F.silu(self.norm_out(x)))
        eps = x.float().permute(0, 2, 3, 1).contiguous()
        if return_deep and return_skips:
            return eps, deep_out, (skips_out, up_entry_out)
        if return_deep:
            return eps, deep_out
        if return_skips:
            return eps, (skips_out, up_entry_out)
        return eps
