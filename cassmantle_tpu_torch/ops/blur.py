"""Gaussian reveal blur on the device: separable depthwise convolution.

Port of ``cassmantle_tpu/ops/blur.py``: edge-extended borders, a
truncated Gaussian of ``MAX_TAPS`` taps with sigma = radius (PIL's
convention), one vertical and one horizontal depthwise pass in fp32,
rounded and clipped back to uint8.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device

MAX_TAPS = 63
_HALF = MAX_TAPS // 2


def gaussian_taps(radius: float) -> np.ndarray:
    """Blur radius -> (MAX_TAPS,) normalized fp32 weights."""
    if radius <= 0.05:
        w = np.zeros(MAX_TAPS, dtype=np.float32)
        w[_HALF] = 1.0
        return w
    sigma = float(radius)
    x = np.arange(-_HALF, _HALF + 1, dtype=np.float32)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


def blur_image(image_u8: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 + (MAX_TAPS,) weights -> blurred (H, W, 3) uint8."""
    c = image_u8.shape[-1]
    img = image_u8.float().permute(2, 0, 1)[None]               # (1, C, H, W)
    img = F.pad(img, (_HALF, _HALF, _HALF, _HALF), mode="replicate")
    kh = taps.reshape(1, 1, MAX_TAPS, 1).expand(c, 1, MAX_TAPS, 1)
    kw = taps.reshape(1, 1, 1, MAX_TAPS).expand(c, 1, 1, MAX_TAPS)
    out = F.conv2d(img, kh, groups=c)
    out = F.conv2d(out, kw, groups=c)
    out = torch.clamp(torch.round(out[0]), 0, 255).to(torch.uint8)
    return out.permute(1, 2, 0).contiguous()


def device_blur(image: np.ndarray, radius: float,
                device: DeviceLike = "cuda") -> np.ndarray:
    """Game-facing blur: host uint8 (H, W, 3) in and out."""
    dev = resolve_device(device)
    taps = torch.from_numpy(gaussian_taps(radius)).to(dev)
    with torch.inference_mode():
        out = blur_image(torch.from_numpy(np.ascontiguousarray(image)).to(dev),
                         taps)
    return out.cpu().numpy()
