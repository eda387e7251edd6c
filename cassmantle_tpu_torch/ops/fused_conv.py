"""Fused GroupNorm-affine + SiLU + conv3x3: the CUDA kernel's wrapper and
its plain version.

Port of ``cassmantle_tpu/ops/fused_conv.py``. The contract is the
reference's, in its layouts:

    out = conv3x3(silu(x * a + b)) + bias       (NHWC x, HWIO kernel,
                                                 stride 1, SAME padding)

with ``a``, ``b`` the per-(batch, channel) fp32 GroupNorm affine
(``GroupNorm32(return_affine=True)``). The affine and SiLU run in fp32 and
round to x's dtype, the conv accumulates in fp32, the bias adds in fp32
and the sum rounds to x's dtype, as the Pallas kernel does. The SAME
border is zero in the *activated* tensor (not silu(b)).

- On a CUDA tensor :func:`gn_silu_conv3x3` launches ``csrc/fused_conv.cu``
  (bf16 only) or raises; the activated tensor never reaches device memory.
- On a CPU tensor it runs :func:`gn_silu_conv3x3_plain`.

``pad_to`` is the TPU path's channel padding to full 128-lane tiles. The
plain version applies it (zero channels add nothing, the padded outputs
are sliced off); the CUDA kernel tiles for Hopper and ignores it, so no
call copies x into a padded buffer.

``CASSMANTLE_NO_FUSED_CONV`` (read per call, by the UNet's ResBlocks)
selects the unfused module path, the same code as ``fused_conv=False``.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch
import torch.nn.functional as F

from cassmantle_tpu_torch.ops._igemm import conv_plan, sm_count

SOURCE = "fused_conv.cu"


def kill_switch_set() -> bool:
    """True when CASSMANTLE_NO_FUSED_CONV is set to a truthy value."""
    return os.environ.get("CASSMANTLE_NO_FUSED_CONV", "").lower() \
        not in ("", "0", "false", "no", "off")


def describe(unet_cfg) -> str:
    """One log line on the conv path; empty when fused_conv is off."""
    if not getattr(unet_cfg, "fused_conv", False):
        return ""
    pad = getattr(unet_cfg, "conv_pad_to", 0)
    mode = ("kill-switched to the unfused path" if kill_switch_set()
            else "active")
    return (f"fused_conv: GroupNorm+SiLU+conv3x3 CUDA kernel {mode}"
            + (f", channel padding to {pad} ignored on the card" if pad
               else ""))


def round_up(n: int, mult: int) -> int:
    """n rounded up to a multiple of ``mult`` (mult <= 0: n)."""
    if mult <= 0:
        return n
    return (n + mult - 1) // mult * mult


def _pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    return F.pad(t, (0, to - t.shape[-1])) if to != t.shape[-1] else t


def gn_silu_conv3x3_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          kernel: torch.Tensor, bias: torch.Tensor,
                          pad_to: int = 0) -> torch.Tensor:
    """The fused contract in plain PyTorch with the kernel's casts:
    x (B, H, W, C), a and b (B, C), kernel (3, 3, C, F), bias (F,)."""
    c, f = x.shape[-1], kernel.shape[-1]
    cp, fp = round_up(c, pad_to), round_up(f, pad_to)
    xp = _pad_last(x, cp)
    ap, bp = _pad_last(a.float(), cp), _pad_last(b.float(), cp)
    kp = F.pad(kernel, (0, fp - f, 0, cp - c))
    h = xp.float() * ap[:, None, None, :] + bp[:, None, None, :]
    h = (h * torch.sigmoid(h)).to(x.dtype)
    out = F.conv2d(h.permute(0, 3, 1, 2).float(),
                   kp.to(x.dtype).permute(3, 2, 0, 1).float(), padding=1)
    out = out.permute(0, 2, 3, 1) + _pad_last(bias.float(), fp)
    return out[..., :f].to(x.dtype)


def gn_silu_conv3x3_meta(x: torch.Tensor,
                         kernel: torch.Tensor) -> torch.Tensor:
    """Shapes only, for the cost model (``obs/costmodel.py``): the
    kernel's 3x3 conv in x's dtype, unpadded as the kernel runs it; the
    output (B, H, W, F) in x's dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(
        3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _library():
    from cassmantle_tpu_torch.ops import _build

    fn = _build.load(SOURCE).cassmantle_gn_silu_conv3x3_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
    return fn


def _check(x, a, b, kernel, bias):
    if x.dtype != torch.bfloat16 or kernel.dtype != torch.bfloat16:
        raise TypeError(f"the fused conv kernel takes bf16 x and kernel, got "
                        f"{x.dtype} and {kernel.dtype}")
    if x.ndim != 4 or kernel.ndim != 4 or kernel.shape[:2] != (3, 3):
        raise ValueError(f"need x (B, H, W, C) and kernel (3, 3, C, F); got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    bsz, _, _, c = x.shape
    f = kernel.shape[-1]
    if kernel.shape[2] != c or a.shape != (bsz, c) or b.shape != (bsz, c) \
            or bias.shape != (f,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, kernel "
                         f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}")
    if c % 8 or f % 2:
        raise ValueError(f"the kernel needs C % 8 == 0 and F even; got "
                         f"C={c}, F={f}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (run the model "
                         "channels-last)")
    for t in (a, b, kernel, bias):
        if t.device != x.device:
            raise ValueError("all operands must lie on x's device")


def check_aligned16(**tensors) -> None:
    """TMA, and the kernels' 16-byte vector loads, read from 16-byte-
    aligned bases only: raise on any other."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned; "
                             f"data_ptr() % 16 = {t.data_ptr() % 16}")


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor,
                    pad_to: int = 0) -> torch.Tensor:
    """``conv3x3(silu(x * a + b)) + bias`` -> (B, H, W, F) in x's dtype.
    CPU tensors take the plain version (with ``pad_to``); CUDA tensors
    launch the kernel, count the launch and ignore ``pad_to``. The kernel
    reads its weight as (F, 3, 3, C): ``kernel.permute(3, 0, 1, 2)`` is
    copied unless already contiguous (a channels-last OIHW weight is)."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, a, b, kernel, bias, pad_to)
    if x.device.type == "meta":
        return gn_silu_conv3x3_meta(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3: unsupported device {x.device}")
    _check(x, a, b, kernel, bias)
    bsz, h, w, c = x.shape
    f = kernel.shape[-1]
    w_ohwi = kernel.permute(3, 0, 1, 2).contiguous()
    a32, b32 = a.float().contiguous(), b.float().contiguous()
    bias32 = bias.float().contiguous()
    check_aligned16(x=x, weight=w_ohwi, a=a32, b=b32)
    out = torch.empty((bsz, h, w, f), dtype=x.dtype, device=x.device)
    plan = conv_plan(bsz, h, w, c, f, sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library()(
        x.data_ptr(), a32.data_ptr(), b32.data_ptr(), w_ohwi.data_ptr(),
        bias32.data_ptr(), out.data_ptr(), bsz, h, w, c, f, plan.th,
        plan.tw, plan.imgs, plan.bn, plan.slices, stream)
    if err != 0:
        raise RuntimeError(f"fused conv launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, F {f})")
    gn_silu_conv3x3.launches += 1
    gn_silu_conv3x3.shapes[(bsz, h, w, c, f)] += 1
    return out


# Launch counters, written only where the kernel launches: the total, and
# the tally per (B, H, W, C, F). Callers reset them to measure a run.
gn_silu_conv3x3.launches = 0
gn_silu_conv3x3.shapes = collections.Counter()


def reset_counters() -> None:
    gn_silu_conv3x3.launches = 0
    gn_silu_conv3x3.shapes.clear()
