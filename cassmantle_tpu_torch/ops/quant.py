"""W8A8 quantization: int8 weights and activations for serving.

Port of the W8A8 part of ``cassmantle_tpu/ops/quant.py`` (weights-only
int8 and the calibration recorder are not ported). Symmetric int8 with no
zero point: weights take one fp32 scale per output channel (absmax/127,
or 1 where absmax is 0); activations one scale per tensor (the UNet) or
per token (GPT-2), absmax/127 computed on the device, or a static scale
given at build. Rounding is half to even and clips to +-127, as
``jnp.round``/``jnp.clip`` do, so the int8 data are bit-identical to the
reference's.

The reference swaps leaves of a Flax parameter tree for ``ActQTensor``s;
here :func:`w8a8_modules` quantizes a built module in place: each selected
``Dense`` or ``Conv3x3Params`` drops its ``weight`` parameter for the
buffers ``weight_q`` (int8, the module's layout: Dense (out, in), conv
OIHW stored channels-last), ``weight_scale`` (fp32 (out,)) and, with a
static scale, ``act_scale`` (fp32 scalar). The module's forward then
branches on :func:`quantized_weight`. Quantize once, at build, after the
weights reached their storage dtype and device: a later ``.to(dtype)``
would cast the fp32 scales.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

#: int8 symmetric range: 127, not 128, so negation is exact.
ACT_QMAX = 127.0
#: absmax floor of an activation scale (an all-zero tensor gives no 0).
_ACT_EPS = 1e-8

#: Module names of the W8A8 dense sites: attention q/k/v/qkv/kv/out,
#: transformer MLP fc1/fc2, GEGLU proj/out. Other Dense sites (time
#: embeddings, proj_in/proj_out) never quantize.
W8A8_DENSE_MODULES = frozenset(
    {"q", "k", "v", "qkv", "kv", "out", "proj", "fc1", "fc2"})
#: Module names of the W8A8 conv3x3 sites: the ResBlocks' fused
#: GroupNorm -> SiLU -> conv3x3 (``Conv3x3Params``).
W8A8_CONV_MODULES = frozenset({"conv1", "conv2"})
#: Smallest weight (elements) worth quantizing.
W8A8_MIN_SIZE = 1 << 16


class ActQTensor(NamedTuple):
    """A W8A8 weight: int8 data, the fp32 per-output-channel weight scale
    and an optional static fp32 activation scale (None: dynamic absmax).
    The ops (``ops/quant_matmul.py``) take ``data`` in the reference's
    layout, dense (in, out) and conv HWIO; the modules hand them views of
    their own buffers."""

    data: torch.Tensor
    scale: torch.Tensor
    act_scale: Optional[torch.Tensor]


def _qmax(like: torch.Tensor) -> torch.Tensor:
    """127 as an fp32 tensor on ``like``'s device, filled there (no host
    copy, no sync). Dividing by it is IEEE division on every device;
    CUDA divides by a Python number as a multiply by its reciprocal,
    which rounds an ulp off at times and then flips int8 values against
    the reference."""
    return like.new_full((), ACT_QMAX, dtype=torch.float32)


def quantize_tensor(w: torch.Tensor, axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 of ``w`` along ``axis`` (the output
    channels): (int8 data, fp32 scale with the other axes kept as 1)."""
    w32 = w.float()
    axis = axis % w32.ndim
    reduce = tuple(i for i in range(w32.ndim) if i != axis)
    absmax = w32.abs().amax(dim=reduce, keepdim=True)
    scale = torch.where(absmax > 0, absmax / _qmax(absmax),
                        torch.ones_like(absmax))
    data = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return data, scale


def act_absmax(x: torch.Tensor, per_token: bool = False) -> torch.Tensor:
    """|x| max in fp32: a 0-dim tensor (per tensor) or (..., 1) over the
    feature axis (per token). Stays on x's device: no host sync."""
    x32 = x.float().abs()
    if per_token:
        return x32.amax(dim=-1, keepdim=True)
    return x32.amax()


def act_scale_from_absmax(absmax) -> torch.Tensor:
    """absmax -> the int8 activation scale max(absmax, 1e-8) / 127."""
    absmax = torch.as_tensor(absmax, dtype=torch.float32)
    return torch.clamp_min(absmax, _ACT_EPS) / _qmax(absmax)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to +-127, as int8 (fp32 divide)."""
    return torch.clamp(torch.round(x.float() / scale),
                       -ACT_QMAX, ACT_QMAX).to(torch.int8)


def quantize_tensor_act(w: torch.Tensor, axis: int = -1,
                        act_scale: Optional[torch.Tensor] = None
                        ) -> ActQTensor:
    """:func:`quantize_tensor` as a W8A8 weight (scale flattened to
    (out,)), carrying the site's static activation scale if given."""
    data, scale = quantize_tensor(w, axis)
    if act_scale is not None:
        act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                    device=w.device)
    return ActQTensor(data, scale.reshape(-1), act_scale)


def w8a8_default_predicate(path: Tuple[str, ...], weight: torch.Tensor,
                           min_size: int = W8A8_MIN_SIZE) -> bool:
    """True for a weight at a W8A8 site: ``path`` is the owning module's
    path, ``weight`` in the port's layout (dense (out, in), conv OIHW)."""
    if not path or weight.numel() < min_size:
        return False
    parent = path[-1]
    if weight.ndim == 2 and parent in W8A8_DENSE_MODULES:
        return True
    return (weight.ndim == 4 and tuple(weight.shape[2:]) == (3, 3)
            and parent in W8A8_CONV_MODULES)


def site_key(path: Tuple[str, ...]) -> str:
    """The calibration key of a site: its module path, '/'-joined."""
    return "/".join(path)


def quantized_weight(module: nn.Module) -> Optional[ActQTensor]:
    """The module's W8A8 weight in its own layout, or None when the
    module was not quantized."""
    data = getattr(module, "weight_q", None)
    if data is None:
        return None
    return ActQTensor(data, module.weight_scale,
                      getattr(module, "act_scale", None))


def _quantize_module_(module: nn.Module,
                      act_scale: Optional[torch.Tensor]) -> None:
    weight = module.weight.detach()
    q = quantize_tensor_act(weight, axis=0, act_scale=act_scale)
    data = q.data
    if data.ndim == 4:       # OHWI memory: the conv kernel's weight layout
        data = data.contiguous(memory_format=torch.channels_last)
    del module.weight
    module.register_buffer("weight_q", data)
    module.register_buffer("weight_scale", q.scale)
    module.register_buffer("act_scale", q.act_scale)


def w8a8_modules(model: nn.Module,
                 act_scales: Optional[Dict[str, float]] = None,
                 predicate: Optional[Callable] = None) -> int:
    """Quantize every W8A8 site of ``model`` in place (the port's
    ``w8a8_tree``); returns the number of sites. ``act_scales`` maps
    :func:`site_key` to a calibrated absmax: those sites get a static
    activation scale, the others scale dynamically."""
    from cassmantle_tpu_torch.models.layers import Conv3x3Params, Dense

    if predicate is None:
        predicate = w8a8_default_predicate
    sites = []
    for name, module in model.named_modules():
        weight = getattr(module, "weight", None)
        if not name or not isinstance(weight, torch.Tensor):
            continue
        path = tuple(name.split("."))
        if not predicate(path, weight):
            continue
        if not isinstance(module, (Dense, Conv3x3Params)):
            raise TypeError(f"W8A8 site {name} is a {type(module).__name__}, "
                            f"which has no quantized branch")
        sites.append((path, module))
    for path, module in sites:
        a_scale = None
        if act_scales is not None and site_key(path) in act_scales:
            a_scale = act_scale_from_absmax(act_scales[site_key(path)])
        _quantize_module_(module, a_scale)
    return len(sites)


def w8a8_site_count(model: nn.Module) -> int:
    """Number of quantized sites of ``model``."""
    return sum(quantized_weight(m) is not None for m in model.modules())


def w8a8_calibrated(model: nn.Module) -> bool:
    """True when any quantized site carries a static activation scale."""
    return any(q is not None and q.act_scale is not None
               for q in map(quantized_weight, model.modules()))
