"""Shared building blocks of the port's model zoo.

Port of ``cassmantle_tpu/models/layers.py``. Conventions kept from the
reference, so a Flax parameter tree maps onto these modules mechanically
(``models/weights.py::from_jax``):

- submodules carry the Flax module names (``qkv``, ``fc1``, ``norm``...);
- every layer has a compute ``dtype`` and casts its input and parameters
  to it where it uses them, as Flax's ``promote_dtype`` does, so storage
  dtype (``ModelZooConfig.param_dtype``) and compute dtype stay apart;
- norms take fp32 statistics; LayerNorm32/GroupNorm32 apply the affine in
  the activation dtype, ``LayerNorm`` (Flax ``nn.LayerNorm(dtype=fp32)``)
  returns fp32;
- attention goes through ``ops.attention.multi_head_attention``;
- ``Dense`` is also the reference's ``QDense``: after the W8A8 transform
  (``ops/quant.py::w8a8_modules``) its forward runs the int8 kernel;
  inside the calibration recorder (``ops/quant.py::collect_act_stats``)
  it notes its input's absmax, as ``QDense`` does;
- a weights-only int8 ``Dense`` or ``Conv`` (``ops/quant.py::
  int8_modules``) dequantizes its own weight just before its product
  (``ops/quant.py::layer_weight``), which stays a library call;
- ``fused_gn_silu_conv3x3`` is the fused ResBlock GroupNorm -> SiLU ->
  conv3x3 (``ops/fused_conv.py``), on a plain, weights-only int8 or W8A8
  weight; the recorder notes the activation after GroupNorm and SiLU.

Images are NCHW inside the port's modules; the models convert from and to
the reference's NHWC at their public boundary.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from cassmantle_tpu_torch.ops.attention import multi_head_attention
from cassmantle_tpu_torch.ops.fused_conv import gn_silu_conv3x3
from cassmantle_tpu_torch.ops.quant import (
    ActQTensor,
    act_site,
    act_stats_active,
    layer_weight,
    note_act_stat,
    quantized_weight,
)
from cassmantle_tpu_torch.ops.quant_matmul import (
    gn_silu_conv3x3_w8a8,
    w8a8_dense,
)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal diffusion-timestep embedding, fp32. (B,) -> (B, dim)."""
    half = dim // 2
    steps = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    # divided by a device tensor: an IEEE divide on every device
    freqs = torch.exp(-math.log(max_period) * steps
                      / steps.new_full((), half))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def chunk_causal_mask(valid: torch.Tensor, index: Union[int, torch.Tensor],
                      length: int, window: Optional[int] = None
                      ) -> torch.Tensor:
    """Mask of a ``length``-token decode chunk appended at cache position
    ``index`` (an int, or a one-element tensor on ``valid``'s device, so
    the mask builds under a CUDA graph capture without a host value).

    ``valid`` (B, max_len) marks the cache positions to attend (prompt and
    chunk, as one decode step's valid mask); query j sits at ``index + j``
    and attends only positions ``<= index + j`` (and, with ``window``,
    ``> index + j - window``). Returns (B, 1, length, max_len). Positions
    past an accepted prefix roll back by dropping out of the next chunk's
    ``valid``; its append then overwrites them."""
    dev = valid.device
    cache_pos = torch.arange(valid.shape[-1], device=dev)
    q_pos = index + torch.arange(length, device=dev)
    ok = cache_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok = ok & (cache_pos[None, :] > q_pos[:, None] - window)
    return valid[:, None, None, :] & ok[None, None]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """Erf GELU (BERT, OpenCLIP bigG)."""
    return F.gelu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU: Flax's ``nn.gelu`` default (GPT-2, GEGLU)."""
    return F.gelu(x, approximate="tanh")


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    with torch.no_grad():
        w.normal_(0.0, fan_in ** -0.5, generator=generator)


class Dense(nn.Module):
    """``nn.Dense`` twin: weight (out, in), optional bias. A W8A8 site
    (its weight quantized by ``ops/quant.py::w8a8_modules``) runs the int8
    kernel instead, with per-token activation scales when
    ``act_per_token`` (GPT-2), else per-tensor ones."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 act_per_token: bool = False):
        super().__init__()
        self.dtype = dtype
        self.act_per_token = act_per_token
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if act_stats_active():
            note_act_stat(act_site(self), x)
        q = quantized_weight(self)
        if q is not None:
            return w8a8_dense(x, ActQTensor(q.data.t(), q.scale, q.act_scale),
                              self.bias, out_dtype=self.dtype,
                              per_token=self.act_per_token)
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), layer_weight(self).to(dt), bias)


class Conv(nn.Module):
    """``nn.Conv`` twin on NCHW: square kernel, SAME padding (1 for 3x3,
    0 for 1x1), optional stride 2."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _lecun_normal_(self.weight, fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), layer_weight(self).to(dt),
                        self.bias.to(dt), stride=self.stride,
                        padding=self.padding)


class Conv3x3Params(Conv):
    """The conv3x3 of a fused ResBlock: ``Conv``'s parameters and layout
    (so ``from_jax`` needs no rule of its own) and its forward for the
    unfused path; :func:`fused_gn_silu_conv3x3` reads the weight into the
    fused kernel instead, or its W8A8 buffers once quantized."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 3, dtype=dtype)


class Embed(nn.Module):
    """``nn.Embed`` twin: table (num, features), output in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the fast
    variance E[x^2] - E[x]^2 (clamped at 0), fp32 output."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.float() + self.bias.float()


class LayerNorm32(nn.Module):
    """LayerNorm with fp32 statistics, applied as one FMA in x's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    reset_parameters = LayerNorm.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.square().mean(dim=-1, keepdim=True) - mean.square()
        inv = torch.rsqrt(var + self.eps)
        scale32 = self.weight.float()
        a = (inv * scale32).to(x.dtype)
        b = (self.bias.float() - (mean * inv) * scale32).to(x.dtype)
        return x * a + b


def _per_channel(t: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, G) per-group values -> (B, C), each repeated over its group's
    channels (``repeat_interleave`` as a broadcast copy: no host value is
    read, so it can be captured in a CUDA graph)."""
    b, g = t.shape
    return t[:, :, None].expand(b, g, channels // g).reshape(b, channels)


class _GroupNormCore(nn.Module):
    """GroupNorm of an NCHW tensor with fp32 statistics: per-(batch, group)
    mean and E[x^2] in fp32, then out = x * a + b with the per-(batch,
    channel) affine computed in fp32 and applied in x's dtype."""

    def __init__(self, channels: int, num_groups: int, eps: float):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    reset_parameters = LayerNorm.reset_parameters

    def affine(self, x: torch.Tensor):
        """The per-(batch, channel) fp32 affine (a, b), out = x * a + b,
        from per-channel sums over H*W folded into the groups (the
        reference's ``return_affine`` form: no copy of a channels-last
        x)."""
        b, c = x.shape[:2]
        g = self.num_groups
        x32 = x.float()
        dims = tuple(range(2, x.ndim))
        # divided by a device tensor: an IEEE divide on every device
        n_group = x32.new_full((), x32[0, 0].numel() * (c // g))
        mean = x32.sum(dim=dims).reshape(b, g, -1).sum(-1) / n_group
        ex2 = x32.square().sum(dim=dims).reshape(b, g, -1).sum(-1) / n_group
        inv = torch.rsqrt(ex2 - mean.square() + self.eps)      # (B, G)
        a = _per_channel(inv, c) * self.weight.float()
        shift = self.bias.float() - _per_channel(mean, c) * a
        return a, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        x32 = x.reshape(b, g, -1).float()
        mean = x32.mean(dim=-1)                                # (B, G)
        var = x32.square().mean(dim=-1) - mean.square()
        inv = torch.rsqrt(var + self.eps)
        inv_c = _per_channel(inv, c)                           # (B, C)
        mean_c = _per_channel(mean, c)
        a = inv_c * self.weight.float()[None, :]
        shift = self.bias.float()[None, :] - mean_c * a
        shape = (b, c) + (1,) * (x.ndim - 2)
        return x * a.reshape(shape).to(x.dtype) \
            + shift.reshape(shape).to(x.dtype)


class GroupNorm32(nn.Module):
    """GroupNorm32 of the reference; nests the core under ``norm`` to keep
    the reference's parameter paths."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm = _GroupNormCore(channels, num_groups, eps)

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        """Normalized x, or with ``return_affine`` the fp32 (B, C) (a, b)
        of ``out = x * a + b``."""
        if return_affine:
            return self.norm.affine(x)
        return self.norm(x)


def fused_gn_silu_conv3x3(x: torch.Tensor, norm: GroupNorm32,
                          conv: Conv3x3Params, pad_to: int = 0
                          ) -> torch.Tensor:
    """``conv(silu(norm(x)))`` as one fused kernel, on an NCHW x (run
    channels-last: the kernels read NHWC memory, so the permutes here are
    views). fp32 GroupNorm statistics here; a plain or weights-only int8
    weight (dequantized first) goes to the fused GN-affine + SiLU +
    conv3x3 kernel (affine and SiLU in fp32), a W8A8 weight to
    ``gn_silu_conv3x3_w8a8`` (affine and SiLU in x's dtype, then int8).
    Inside the calibration recorder the conv's input, ``silu(x * a + b)``
    in x's dtype, is made here to be noted (as the reference does)."""
    x = x.contiguous(memory_format=torch.channels_last)
    a, b = norm(x, return_affine=True)
    xh = x.permute(0, 2, 3, 1)
    if act_stats_active():
        dt = xh.dtype
        note_act_stat(act_site(conv), F.silu(
            xh * a[:, None, None, :].to(dt) + b[:, None, None, :].to(dt)))
    q = quantized_weight(conv)
    if q is not None:
        hwio = ActQTensor(q.data.permute(2, 3, 1, 0), q.scale, q.act_scale)
        out = gn_silu_conv3x3_w8a8(xh, a, b, hwio, conv.bias, pad_to=pad_to)
    else:
        dt = conv.dtype
        out = gn_silu_conv3x3(xh, a, b,
                              layer_weight(conv).to(dt).permute(2, 3, 1, 0),
                              conv.bias.to(dt), pad_to=pad_to)
    return out.permute(0, 3, 1, 2)


class MultiHeadAttention(nn.Module):
    """Projections + ``multi_head_attention`` + out projection.

    Self attention when ``context`` is None, cross attention otherwise.
    ``fused_qkv`` keeps the reference's concatenated projection: ``qkv``
    (self) or ``q`` + ``kv`` (cross); the attention then reads q, k and v
    as strided views of the fused output, without a copy.
    """

    def __init__(self, query_dim: int, num_heads: int,
                 context_dim: Optional[int] = None, use_bias: bool = True,
                 out_bias: Optional[bool] = None, fused_qkv: bool = False,
                 act_per_token: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = query_dim // num_heads
        self.fused_qkv = fused_qkv
        self.is_cross = context_dim is not None
        inner = num_heads * self.head_dim
        self.inner = inner
        ctx_dim = context_dim if context_dim is not None else query_dim

        def dense(n_in, n_out, bias=use_bias):
            return Dense(n_in, n_out, bias, dtype, act_per_token)

        if fused_qkv and not self.is_cross:
            self.qkv = dense(query_dim, 3 * inner)
        elif fused_qkv:
            self.q = dense(query_dim, inner)
            self.kv = dense(ctx_dim, 2 * inner)
        else:
            self.q = dense(query_dim, inner)
            self.k = dense(ctx_dim, inner)
            self.v = dense(ctx_dim, inner)
        self.out = dense(inner, query_dim,
                         use_bias if out_bias is None else out_bias)

    def forward(self, x, context=None, mask=None, kv_cache=None,
                return_kv: bool = False):
        """Full mode returns out, or (out, (k, v)) with ``return_kv``.
        Decode mode (``kv_cache=(cache_k, cache_v, index)``) writes this
        call's k/v into the caches at ``index`` IN PLACE (the port updates
        the preallocated cache rather than copying it each step) and
        attends over the whole cache under the caller's ``mask``; returns
        (out, (cache_k, cache_v)). ``index`` is the first position (an
        int), or the positions themselves as an int64 tensor of one per
        token on the cache's device (a CUDA graph's step reads it there)."""
        ctx = x if context is None else context
        if self.fused_qkv:
            if kv_cache is not None or return_kv:
                raise ValueError("fused_qkv is a full-forward layout; the "
                                 "decode cache uses separate projections")
            if context is None:
                q, k, v = self.qkv(x).split(self.inner, dim=-1)
            else:
                q = self.q(x)
                k, v = self.kv(ctx).split(self.inner, dim=-1)
        else:
            q, k, v = self.q(x), self.k(ctx), self.v(ctx)
        heads = (self.num_heads, self.head_dim)
        q, k, v = q.unflatten(-1, heads), k.unflatten(-1, heads), \
            v.unflatten(-1, heads)

        kv_out = None
        if kv_cache is not None:
            cache_k, cache_v, index = kv_cache
            if isinstance(index, torch.Tensor):
                cache_k.index_copy_(1, index, k.to(cache_k.dtype))
                cache_v.index_copy_(1, index, v.to(cache_v.dtype))
            else:
                s = k.shape[-3]
                cache_k[:, index:index + s] = k.to(cache_k.dtype)
                cache_v[:, index:index + s] = v.to(cache_v.dtype)
            k, v = cache_k, cache_v
            kv_out = (cache_k, cache_v)
        elif return_kv:
            kv_out = (k, v)

        out = multi_head_attention(q, k, v, mask=mask)
        out = self.out(out.flatten(-2))
        if kv_out is not None:
            return out, kv_out
        return out


class TransformerMLP(nn.Module):
    """Two-layer MLP with a configurable activation."""

    def __init__(self, features: int, intermediate: int,
                 activation: Callable = gelu, act_per_token: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(features, intermediate, dtype=dtype,
                         act_per_token=act_per_token)
        self.fc2 = Dense(intermediate, features, dtype=dtype,
                         act_per_token=act_per_token)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.activation(self.fc1(x)))


class GEGLU(nn.Module):
    """Gated-GELU feed-forward of SD's transformer blocks."""

    def __init__(self, features: int, intermediate: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(features, 2 * intermediate, dtype=dtype)
        self.out = Dense(intermediate, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * gelu(gate))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every layer (lecun-normal kernels and
    embeddings, zero biases, unit norm scales) plus each model's own
    parameters (``reset_parameters`` hooks). Does not reproduce Flax's
    initial values; parity tests carry the reference's parameters over
    with ``from_jax`` instead."""
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model
