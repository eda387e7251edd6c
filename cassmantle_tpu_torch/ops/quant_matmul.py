"""int8 x int8 -> int32 matmul and conv3x3 for W8A8 serving: the CUDA
kernels' wrappers, their plain versions and the W8A8 entry points.

Port of ``cassmantle_tpu/ops/quant_matmul.py``. With x ~ s_a * X8 and
W ~ W8 * s_w (per output channel):

    x @ W ~ (X8 @ W8)_int32 * s_a * s_w

- :func:`int8_matmul`: (M, K) int8 x (K, N) int8, epilogue
  ``acc * row_scale[m] * col_scale[n] + bias[n]`` in fp32, each step
  rounded on its own, cast to ``out_dtype``; per-token activation scales
  are a row scale, a per-tensor scale a row scale of stride 0 that the
  kernel reads through a pointer (no host sync).
- :func:`int8_conv3x3`: NHWC int8 x HWIO int8, stride 1, SAME zero
  padding, nine shifted int8 dots summed in int32, epilogue
  ``acc * col_scale[f] + bias[f]`` (col_scale = s_a * s_w, folded).
- :func:`w8a8_dense` and :func:`gn_silu_conv3x3_w8a8`: the modules'
  entry points, quantizing activations on the device (dynamic absmax,
  per tensor over the whole activation, both CFG halves together, or per
  token; or the site's static scale); :func:`w8a8_conv3x3` is the
  conv's quantize and int8 conv after the elementwise pass;
- an fp8 leaf (``torch.float8_e4m3fn`` data, ``ops/quant.py``) reaches
  no kernel of the port, as in the reference, where it goes to an XLA
  dot: :func:`fp8_matmul` is ``torch._scaled_mm`` at unit scales on the
  card (fp32 out) and the fp32 product of the upcast operands on the CPU
  (the reference's own path off the TPU); the fp8 conv is the fp32 conv
  of the upcast operands on every device. The scales fold in after, in
  fp32, as the int8 epilogue does. No config serves fp8.

On a CUDA tensor the wrappers launch ``csrc/int8_gemm.cu`` or raise; on a
CPU tensor they run the plain versions, whose int32 accumulators are
exact (float64 products of int8 are exact at these depths).

``CASSMANTLE_NO_W8A8`` is read at pipeline build (``w8a8_disabled``): with
it set nothing quantizes and every site takes its plain branch.
"""

from __future__ import annotations

import collections
import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from cassmantle_tpu_torch.ops._igemm import (
    int8_conv_plan,
    matmul_plan,
    sm_count,
)
from cassmantle_tpu_torch.ops.fused_conv import check_aligned16, round_up
from cassmantle_tpu_torch.ops.quant import (
    ActQTensor,
    act_absmax,
    act_scale_from_absmax,
    quantize_act,
)

SOURCE = "int8_gemm.cu"
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def w8a8_disabled() -> bool:
    """True when CASSMANTLE_NO_W8A8 is set to a truthy value."""
    return os.environ.get("CASSMANTLE_NO_W8A8", "").lower() \
        not in ("", "0", "false", "no", "off")


def describe(calibrated: bool, sites: int) -> str:
    """One log line on the W8A8 path."""
    scales = "static calibrated" if calibrated else "dynamic absmax"
    return (f"w8a8: int8 CUDA matmul/conv active at {sites} sites, "
            f"{scales} activation scales")


def _library(name: str):
    from cassmantle_tpu_torch.ops import _build

    fn = getattr(_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        if name == "cassmantle_int8_matmul":
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                           + [ctypes.c_void_p])
    return fn


def _same_device(ref: torch.Tensor, *ts) -> None:
    for t in ts:
        if t is not None and t.device != ref.device:
            raise ValueError("all operands must lie on one device")


# -- int8 matmul --------------------------------------------------------------

def _matmul_operands(x_q, w_q, row_scale, col_scale, bias):
    m, n = x_q.shape[0], w_q.shape[-1]
    row = torch.as_tensor(row_scale, dtype=torch.float32, device=x_q.device)
    if row.numel() not in (1, m):
        raise ValueError(f"row_scale of {row.numel()} values for {m} rows")
    col = col_scale.float().reshape(n)
    b = (torch.zeros((n,), dtype=torch.float32, device=x_q.device)
         if bias is None else bias.float().reshape(n))
    return row, col, b


def int8_matmul_plain(x_q, w_q, row_scale, col_scale, bias=None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: exact int32 accumulation,
    then ``acc * row_scale * col_scale + bias`` in fp32."""
    row, col, b = _matmul_operands(x_q, w_q, row_scale, col_scale, bias)
    acc = (x_q.double() @ w_q.double()).to(torch.int32)
    out = acc.float() * row.reshape(-1, 1) * col.reshape(1, -1)
    return (out + b.reshape(1, -1)).to(out_dtype)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, row_scale, col_scale,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) ``out_dtype``. ``row_scale``
    is one fp32 value or one per row, ``col_scale`` one per column. CPU
    tensors take the plain version; CUDA tensors launch the kernel. The
    kernel reads the weight as (N, K): ``w_q.t()`` is copied unless
    already contiguous (the modules' (out, in) buffers are)."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, row_scale, col_scale, bias,
                                 out_dtype)
    if x_q.device.type == "meta":
        # shapes only, for the cost model: the int8 product, out_dtype out
        return (x_q @ w_q).to(out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul writes fp32 or bf16, not {out_dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"need (M, K) x (K, N); got {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 16:
        raise ValueError(f"the int8 kernel needs K % 16 == 0; got K={k}")
    if not x_q.is_contiguous():
        raise ValueError("x_q must be a contiguous (M, K) matrix")
    _same_device(x_q, w_q, col_scale, bias)
    row, col, b = _matmul_operands(x_q, w_q, row_scale, col_scale, bias)
    row = row.reshape(-1).contiguous()
    wt = w_q.t().contiguous()
    col, b = col.contiguous(), b.contiguous()
    check_aligned16(x_q=x_q, weight=wt)
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    plan = matmul_plan(m, k, n, sm_count(x_q.device))
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    err = _library("cassmantle_int8_matmul")(
        x_q.data_ptr(), wt.data_ptr(), row.data_ptr(),
        1 if row.numel() == m and m > 1 else 0, col.data_ptr(),
        b.data_ptr(), out.data_ptr(), _OUT_DTYPES[out_dtype], m, k, n,
        int(plan.swap), plan.bn, plan.slices, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul launch failed: cudaError {err} "
                           f"(M, K, N = {m}, {k}, {n})")
    int8_matmul.launches += 1
    int8_matmul.shapes[(m, k, n)] += 1
    return out


# -- int8 conv3x3 -------------------------------------------------------------

def int8_conv3x3_plain(x_q, kernel, col_scale, bias,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Nine shifted int8 dots over the zero-padded image, summed exactly
    in int32, then ``acc * col_scale + bias`` in fp32."""
    bsz, h, w, c = x_q.shape
    f = kernel.shape[-1]
    xp = F.pad(x_q.double(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((bsz, h, w, f), dtype=torch.float64, device=x_q.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + w, :] @ kernel[dy, dx].double()
    out = acc.to(torch.int32).float() * col_scale.float().reshape(f)
    return (out + bias.float().reshape(f)).to(out_dtype)


def int8_conv3x3(x_q: torch.Tensor, kernel: torch.Tensor,
                 col_scale: torch.Tensor, bias: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) int8 NHWC x (3, 3, C, F) int8 HWIO, stride 1, SAME ->
    (B, H, W, F) ``out_dtype``. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which reads the weight as (F, 3, 3, C):
    ``kernel.permute(3, 0, 1, 2)`` is copied unless already contiguous (a
    channels-last OIHW buffer is)."""
    if x_q.device.type == "cpu":
        return int8_conv3x3_plain(x_q, kernel, col_scale, bias, out_dtype)
    if x_q.device.type == "meta":
        # shapes only, for the cost model: the int8 conv, out_dtype out
        return F.conv2d(x_q.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1).to(out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or kernel.dtype != torch.int8:
        raise TypeError(f"int8_conv3x3 takes int8 operands, got {x_q.dtype} "
                        f"and {kernel.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv3x3 writes fp32 or bf16, not {out_dtype}")
    if x_q.ndim != 4 or kernel.ndim != 4 or kernel.shape[:2] != (3, 3) \
            or kernel.shape[2] != x_q.shape[3]:
        raise ValueError(f"need x (B, H, W, C) and kernel (3, 3, C, F); got "
                         f"{tuple(x_q.shape)} and {tuple(kernel.shape)}")
    bsz, h, w, c = x_q.shape
    f = kernel.shape[-1]
    if c % 16:
        raise ValueError(f"the int8 conv kernel needs C % 16 == 0; got C={c}")
    if not x_q.is_contiguous():
        raise ValueError("x_q must be contiguous NHWC")
    _same_device(x_q, kernel, col_scale, bias)
    w_ohwi = kernel.permute(3, 0, 1, 2).contiguous()
    col = col_scale.float().reshape(f).contiguous()
    b = bias.float().reshape(f).contiguous()
    check_aligned16(x_q=x_q, weight=w_ohwi)
    out = torch.empty((bsz, h, w, f), dtype=out_dtype, device=x_q.device)
    plan = int8_conv_plan(bsz, h, w, c, f, sm_count(x_q.device))
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    err = _library("cassmantle_int8_conv3x3")(
        x_q.data_ptr(), w_ohwi.data_ptr(), col.data_ptr(), b.data_ptr(),
        out.data_ptr(), _OUT_DTYPES[out_dtype], bsz, h, w, c, f, plan.wgs,
        plan.imgs, plan.rows, plan.cols, plan.slices, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"int8 conv launch failed: cudaError {err} "
                           f"(x {tuple(x_q.shape)}, F {f})")
    int8_conv3x3.launches += 1
    int8_conv3x3.shapes[(bsz, h, w, c, f)] += 1
    return out


# -- fp8 ----------------------------------------------------------------------

def fp8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) fp8 x (K, N) fp8 -> (M, N) fp32: the upcast operands'
    fp32 product (the reference's dot off the TPU)."""
    return x_q.float() @ w_q.float()


def fp8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) fp8 x (K, N) fp8 -> (M, N) fp32 accumulate. On the card
    ``torch._scaled_mm`` at unit scales (K and N multiples of 16, else it
    raises); on the CPU :func:`fp8_matmul_plain`."""
    if x_q.device.type != "cuda":
        return fp8_matmul_plain(x_q, w_q)
    one = torch.ones((), dtype=torch.float32, device=x_q.device)
    # _scaled_mm wants its second operand column-major
    return torch._scaled_mm(x_q.contiguous(), w_q.t().contiguous().t(),
                            scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


def _fp8_dense(x2: torch.Tensor, q: ActQTensor, bias, out_dtype,
               per_token: bool) -> torch.Tensor:
    qdtype = q.data.dtype
    if per_token or q.act_scale is None:
        a_scale = act_scale_from_absmax(
            act_absmax(x2, per_token=per_token), qdtype)
    else:
        a_scale = q.act_scale
    n = q.data.shape[-1]
    acc = fp8_matmul(quantize_act(x2, a_scale, qdtype), q.data)
    out = acc * a_scale.float().reshape(-1, 1) * q.scale.reshape(1, n)
    if bias is not None:
        out = out + bias.float().reshape(1, n)
    return out.to(out_dtype)


def _fp8_conv3x3(h: torch.Tensor, q: ActQTensor,
                 bias: torch.Tensor) -> torch.Tensor:
    a_scale = (act_scale_from_absmax(act_absmax(h), q.data.dtype)
               if q.act_scale is None else q.act_scale)
    f = q.data.shape[-1]
    h_q = quantize_act(h, a_scale, q.data.dtype)
    acc = F.conv2d(h_q.float().permute(0, 3, 1, 2),
                   q.data.float().permute(3, 2, 0, 1), padding=1)
    col = a_scale.float() * q.scale.reshape(f)
    out = acc.permute(0, 2, 3, 1) * col + bias.float().reshape(f)
    return out.to(h.dtype)


# -- the modules' entry points ------------------------------------------------

def w8a8_dense(x: torch.Tensor, q: ActQTensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None,
               per_token: bool = False) -> torch.Tensor:
    """Dense layer on a W8A8 weight (``q.data`` (in, out)): quantize x
    (per-token dynamic scales, else the static scale if the site has one,
    else one dynamic scale over all of x), run the int8 matmul, epilogue
    in fp32, cast to ``out_dtype`` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    n = q.data.shape[-1]
    x2 = x.reshape(-1, k)
    if q.data.dtype != torch.int8:         # an fp8 leaf
        return _fp8_dense(x2, q, bias, out_dtype,
                          per_token).reshape(lead + (n,))
    if per_token or q.act_scale is None:
        scale = act_scale_from_absmax(act_absmax(x2, per_token=per_token))
    else:
        scale = q.act_scale
    out = int8_matmul(quantize_act(x2, scale), q.data, scale,
                      q.scale.reshape(n), bias, out_dtype=out_dtype)
    return out.reshape(lead + (n,))


def gn_silu_conv3x3_w8a8(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         q: ActQTensor, bias: torch.Tensor,
                         pad_to: int = 0) -> torch.Tensor:
    """The int8 form of the fused contract: the GroupNorm affine and SiLU
    in x's dtype (as the reference's elementwise pass does), then
    :func:`w8a8_conv3x3`. Output in x's dtype."""
    dt = x.dtype
    h = F.silu(x * a[:, None, None, :].to(dt) + b[:, None, None, :].to(dt))
    return w8a8_conv3x3(h, q, bias, pad_to)


def w8a8_conv3x3(h: torch.Tensor, q: ActQTensor, bias: torch.Tensor,
                 pad_to: int = 0) -> torch.Tensor:
    """conv3x3 of the activation ``h`` (B, H, W, C) on a W8A8 weight
    (``q.data`` HWIO): quantize h with the site's static scale or one
    dynamic absmax over all of h, then the int8 conv with ``col_scale =
    s_a * s_w``. Output in h's dtype. ``pad_to`` pads C and F of the
    plain path with zeros (exact through the integer dot); the CUDA
    kernel ignores it."""
    dt = h.dtype
    if q.data.dtype != torch.int8:         # an fp8 leaf
        return _fp8_conv3x3(h, q, bias)
    a_scale = (act_scale_from_absmax(act_absmax(h)) if q.act_scale is None
               else q.act_scale)
    f = q.data.shape[-1]
    col = a_scale.float() * q.scale.reshape(f)
    h_q = quantize_act(h, a_scale)
    if h_q.device.type != "cpu":
        return int8_conv3x3(h_q, q.data, col, bias, out_dtype=dt)
    c = h_q.shape[-1]
    cp, fp = round_up(c, pad_to), round_up(f, pad_to)
    hq = F.pad(h_q, (0, cp - c))
    kq = F.pad(q.data, (0, fp - f, 0, cp - c))
    out = int8_conv3x3(hq, kq, F.pad(col, (0, fp - f)),
                       F.pad(bias.float(), (0, fp - f)), out_dtype=dt)
    return out[..., :f]


# Launch counters, written only where a kernel launches: the total, and
# the tally per shape ((M, K, N) and (B, H, W, C, F)).
int8_matmul.launches = 0
int8_matmul.shapes = collections.Counter()
int8_conv3x3.launches = 0
int8_conv3x3.shapes = collections.Counter()


def reset_counters() -> None:
    for fn in (int8_matmul, int8_conv3x3):
        fn.launches = 0
        fn.shapes.clear()
