"""Device resolution and the port's numeric settings.

Entry points take ``device="cuda"`` by default and never fall back to the
CPU on their own: a host without CUDA raises. Tests pass ``device="cpu"``
explicitly, where every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it asks for CUDA
    on a host without it. On CUDA, TF32 is switched off for matmuls and
    cuDNN convolutions: the fp32 sites of the port (VAE/UNet ``conv_out``,
    CLIP, MiniLM, the blur) run in full fp32, as the reference does."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run the port's plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work this thread queued on its current stream (a no-op
    on the CPU). Not the whole device: a device-wide synchronize would
    also wait on another thread's capturing stream and break its CUDA
    graph capture (``ops/graphs.py``)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES[name]
