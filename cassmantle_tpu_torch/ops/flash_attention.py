"""Flash attention: the CUDA kernel's wrapper and its plain version.

Port of ``cassmantle_tpu/ops/flash_attention.py``. The TPU module has
three entry points over one Pallas kernel (self attention, ragged cross
attention with a ``kv_len`` mask, and the wide-head VAE variant at
512-blocks); here ``csrc/flash_attention.cu`` serves all three, and
:func:`flash_attention` is the single entry point:

- on a CUDA tensor it launches a kernel (bf16 only) or raises: the
  warp-specialised wgmma kernel for every UNet shape (D = 40, 80, 160
  at SD1.5, 64 at SDXL),
  the mma.sync kernel for D = 512, other head dims and layouts TMA
  cannot describe
  (``_flash_plan.flash_plan`` decides by shape, never on failure);
- on a CPU tensor it runs :func:`flash_attention_plain`, the same function
  with the same casts in plain PyTorch.

The kernel has no backward: on a CUDA tensor the wrapper raises when grad
mode is on and an input requires grad, rather than return an output cut
from the graph. A forward that is differentiated takes the plain attention
(``ops/attention.py::plain_only``).

Layout: q (B, Sq, H, D), k and v (B, Sk, H, D), any strides with a unit
stride on D; the output is a new contiguous (B, Sq, H, D) tensor.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from cassmantle_tpu_torch.ops._flash_plan import (
    MAX_HEAD_DIM,
    WGMMA,
    flash_plan,
    tma_layout_ok,
)
from cassmantle_tpu_torch.ops._igemm import sm_count

SOURCE = "flash_attention.cu"
_NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with the kernel's casts: fp32 scores,
    columns at or past ``kv_len`` set to -1e30, p rounded to v's dtype
    before p.v, fp32 accumulation, out = acc / l cast to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        s[..., kv_len:] = _NEG_INF
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1).transpose(1, 2)[..., None]          # (B, Sq, H, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / denom).to(q.dtype)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Shapes only, for the cost model (``obs/costmodel.py``): a meta
    tensor holds no data. The kernel's two products, q k^T and p v, in
    its operand dtype; the output's shape and dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    return torch.einsum("bhqk,bkhd->bqhd", s.to(v.dtype), v).to(q.dtype)


def _library(path: str):
    from cassmantle_tpu_torch.ops import _build

    lib = _build.load(SOURCE)
    wgmma = path == WGMMA
    fn = (lib.cassmantle_flash_attention_wgmma if wgmma
          else lib.cassmantle_flash_attention_bf16)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_float]
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * (7 if wgmma else 4)
            + [ctypes.c_void_p]
        )
    return fn


def _check(q, k, v, kv_len):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if not (1 <= kv_len <= k.shape[1]):
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the flash kernel needs a unit stride on D")
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, H, D) attention without a mask (apart from
    ``kv_len``: keys at or past it are ignored). CPU tensors take the plain
    version; CUDA tensors launch the kernel and count the launch."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_len is None:
        kv_len = k.shape[1]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, kv_len)
    if q.device.type == "meta":
        return flash_attention_meta(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward, and an input "
            "requires grad; differentiate under ops.attention.plain_only()")
    _check(q, k, v, kv_len)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    plan = flash_plan(b, sq, h, d, sm_count(q.device),
                      all(tma_layout_ok(t.shape, t.stride(), t.data_ptr())
                          for t in (q, k, v)), float(scale))
    tail = ((plan.np, plan.bk, plan.stages, plan.consumers, plan.boxes,
             plan.ksteps) if plan.path == WGMMA
            else (plan.np, plan.bq, plan.bk))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library(plan.path)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, d, kv_len, float(scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *tail, plan.grid[0], stream)
    if err != 0:
        raise RuntimeError(f"flash attention ({plan.path}) launch failed: "
                           f"cudaError {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)})")
    flash_attention.launches += 1
    flash_attention.shapes[(b, sq, kv_len, h, d)] += 1
    flash_attention.paths[plan.path] += 1
    flash_attention.shape_paths[(b, sq, kv_len, h, d), plan.path] += 1
    return out


# Launch counters, written only where a kernel launches: the total, the
# tally per (B, Sq, kv_len, H, D), per path, and per (shape, path).
# Callers reset them to measure a run.
flash_attention.launches = 0
flash_attention.shapes = collections.Counter()
flash_attention.paths = collections.Counter()
flash_attention.shape_paths = collections.Counter()


def reset_counters() -> None:
    flash_attention.launches = 0
    flash_attention.shapes.clear()
    flash_attention.paths.clear()
    flash_attention.shape_paths.clear()
