"""SD autoencoder: the decoder, and the encoder of img2img.

Port of ``cassmantle_tpu/models/vae.py``. Decoder: latents (B, h, w, 4)
NHWC in, (B, 8h, 8w, 3) fp32 NHWC out. Encoder: images (B, H, W, 3) in
[-1, 1] in, sampled and scaled latents (B, H/8, W/8, 4) out, the sample
drawn from a ``utils/jax_random`` key as the reference draws it from its
``jax.random`` key. NCHW inside. bf16 compute over fp32-stored
parameters, fp32 GroupNorm statistics (eps 1e-6), fp32 ``conv_out`` (and
the encoder's fp32 ``quant_conv``). Each mid block's single-head
attention over H*W tokens at D = 512 runs the flash kernel.

With ``VAEConfig.fused_conv`` every ResBlock's GroupNorm -> SiLU ->
conv3x3 runs as the fused kernel (``layers.fused_gn_silu_conv3x3``, at
widths 64 to 512 for SD1.5's 512² image); the parameters are the same,
and both halves run channels-last (NHWC memory under NCHW shapes),
converted once on entry, so the kernel reads every level's activation
without a copy. CASSMANTLE_NO_FUSED_CONV, read per call, selects the
unfused path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cassmantle_tpu_torch.config import VAEConfig
from cassmantle_tpu_torch.models.layers import (
    Conv,
    Conv3x3Params,
    GroupNorm32,
    MultiHeadAttention,
    fused_gn_silu_conv3x3,
    nearest_upsample_2x,
)
from cassmantle_tpu_torch.ops.fused_conv import kill_switch_set
from cassmantle_tpu_torch.utils import jax_random
from cassmantle_tpu_torch.utils.device import torch_dtype


def unscale_latents(latents: torch.Tensor, scaling_factor: float
                    ) -> torch.Tensor:
    """latents / scaling_factor, divided by a 0-dim fp32 tensor on the
    latents' device: an IEEE divide on every device, as the reference's
    (CUDA divides by a host scalar as a multiply by its reciprocal)."""
    return latents / latents.new_full((), scaling_factor,
                                      dtype=torch.float32)


class VAEResBlock(nn.Module):
    """GN/SiLU/conv3x3 x2 + skip; ``fused_conv`` runs each GN/SiLU/conv3x3
    as one fused kernel unless CASSMANTLE_NO_FUSED_CONV is set."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype, fused_conv: bool = False):
        super().__init__()
        self.fused_conv = fused_conv
        conv3 = (Conv3x3Params if fused_conv
                 else lambda i, o, dtype: Conv(i, o, 3, dtype=dtype))
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = conv3(in_channels, out_channels, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = conv3(out_channels, out_channels, dtype=dtype)
        self.skip = (Conv(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def _gn_silu_conv(self, x, norm, conv):
        if self.fused_conv and not kill_switch_set():
            return fused_gn_silu_conv3x3(x, norm, conv)
        return conv(F.silu(norm(x)))

    def forward(self, x):
        h = self._gn_silu_conv(x, self.norm1, self.conv1)
        h = self._gn_silu_conv(h, self.norm2, self.conv2)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class VAEAttnBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.attn = MultiHeadAttention(channels, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self.attn(t)
        return x + t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        mults = cfg.channel_mults
        ch = cfg.base_channels * mults[-1]
        def res(c_in: int, c_out: int) -> VAEResBlock:
            return VAEResBlock(c_in, c_out, dtype, cfg.fused_conv)

        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1, dtype=dtype)
        self.conv_in = Conv(cfg.latent_channels, ch, 3, dtype=dtype)
        self.mid_res_0 = res(ch, ch)
        self.mid_attn = VAEAttnBlock(ch, dtype)
        self.mid_res_1 = res(ch, ch)
        ch_in = ch
        for lvl in reversed(range(len(mults))):
            ch = cfg.base_channels * mults[lvl]
            for blk in range(cfg.blocks_per_level + 1):
                self.add_module(f"up_{lvl}_res_{blk}", res(ch_in, ch))
                ch_in = ch
            if lvl != 0:
                self.add_module(f"up_{lvl}_upsample",
                                Conv(ch, ch, 3, dtype=dtype))
        self.norm_out = GroupNorm32(ch_in, eps=1e-6)
        self.conv_out = Conv(ch_in, 3, 3, dtype=torch.float32)
        if cfg.fused_conv:
            self.to(memory_format=torch.channels_last)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 4) scaled latents -> (B, 8h, 8w, 3) in [-1, 1]."""
        cfg = self.cfg
        z = unscale_latents(latents, cfg.scaling_factor)
        z = z.to(self.dtype).permute(0, 3, 1, 2)
        if cfg.fused_conv:
            z = z.contiguous(memory_format=torch.channels_last)
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        for lvl in reversed(range(len(cfg.channel_mults))):
            for blk in range(cfg.blocks_per_level + 1):
                x = getattr(self, f"up_{lvl}_res_{blk}")(x)
            if lvl != 0:
                x = getattr(self, f"up_{lvl}_upsample")(nearest_upsample_2x(x))
        x = self.conv_out(F.silu(self.norm_out(x)))
        return x.float().permute(0, 2, 3, 1).contiguous()


class VAEEncoder(nn.Module):
    """images -> sampled scaled latents; the reference's names
    (``conv_in``, ``down_{l}_res_{b}``, ``down_{l}_downsample`` at
    stride 2, the mid block, ``norm_out``, fp32 ``conv_out`` and
    ``quant_conv``)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        mults = cfg.channel_mults
        ch_in = cfg.base_channels
        self.conv_in = Conv(3, ch_in, 3, dtype=dtype)
        for lvl, mult in enumerate(mults):
            ch = cfg.base_channels * mult
            for blk in range(cfg.blocks_per_level):
                self.add_module(f"down_{lvl}_res_{blk}", VAEResBlock(
                    ch_in, ch, dtype, cfg.fused_conv))
                ch_in = ch
            if lvl != len(mults) - 1:
                self.add_module(f"down_{lvl}_downsample",
                                Conv(ch, ch, 3, stride=2, dtype=dtype))
        self.mid_res_0 = VAEResBlock(ch_in, ch_in, dtype, cfg.fused_conv)
        self.mid_attn = VAEAttnBlock(ch_in, dtype)
        self.mid_res_1 = VAEResBlock(ch_in, ch_in, dtype, cfg.fused_conv)
        self.norm_out = GroupNorm32(ch_in, eps=1e-6)
        moments = 2 * cfg.latent_channels
        self.conv_out = Conv(ch_in, moments, 3, dtype=torch.float32)
        self.quant_conv = Conv(moments, moments, 1, dtype=torch.float32)
        if cfg.fused_conv:
            self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor,
                key: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] and a ``jax_random`` key ->
        (mean + std * normal(key)) * scaling_factor, (B, H/8, W/8, 4)
        fp32, logvar clipped to [-30, 20]."""
        cfg = self.cfg
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if cfg.fused_conv:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.conv_in(x)
        for lvl in range(len(cfg.channel_mults)):
            for blk in range(cfg.blocks_per_level):
                x = getattr(self, f"down_{lvl}_res_{blk}")(x)
            if lvl != len(cfg.channel_mults) - 1:
                x = getattr(self, f"down_{lvl}_downsample")(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(F.silu(self.norm_out(x)))
        moments = self.quant_conv(x).float().permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        noise = jax_random.normal(key.to(mean.device), mean.shape)
        return (mean + std * noise) * cfg.scaling_factor


def postprocess_images(decoded: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8 RGB, on the device."""
    x = torch.clamp(decoded * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)
