"""The port's CUDA kernels on the card: each against its plain PyTorch
version (flash attention, the fused GroupNorm-affine + SiLU + conv3x3, the
int8 matmul and the int8 conv3x3). Marked ``cuda``; without a card every
test skips. This file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU.)

Tolerance for the flash kernel, bf16 unit-normal inputs, scaled to the
reference because the output's spread shrinks as sqrt(e / Sk):
max |kernel - plain| <= 2^-6 * max |plain| (2 to 4 bf16 ulps of it) and
||kernel - plain||_2 <= 1e-2 * ||plain||_2. Both sides round the output to
bf16; the kernel rounds p to bf16 against its running max, the plain
version against the row max, and the two sum in another order. The fused
conv kernel takes the same limits: both sides round the activated input
and the output to bf16 and sum 9*C products in fp32 in other orders (its
SiLU takes tanh.approx, about 2^-11 relative error), so only roundings
differ. The flash kernel's
path (wgmma or mma.sync) is checked where the shape or layout decides it.
The int8 kernels
sum int32 exactly and round their fp32 epilogue step by step as the plain
versions do: their outputs must be equal. W8A8 quantization on the card
(scales and int8 values) must equal the CPU's bit for bit.
"""

import pytest
import torch

from cassmantle_tpu_torch.ops.fused_conv import (
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
)
from cassmantle_tpu_torch.ops.fused_conv import (
    reset_counters as reset_conv_counters,
)
from cassmantle_tpu_torch.ops.quant import (
    act_absmax,
    act_scale_from_absmax,
    quantize_act,
    quantize_tensor,
)
from cassmantle_tpu_torch.ops.quant_matmul import (
    int8_conv3x3,
    int8_conv3x3_plain,
    int8_matmul,
    int8_matmul_plain,
)
from cassmantle_tpu_torch.ops.quant_matmul import (
    reset_counters as reset_int8_counters,
)
from cassmantle_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    reset_counters,
)

MAX_REL = 2.0 ** -6
RMS_REL = 1e-2


def assert_agrees(out, ref):
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= RMS_REL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(device, b, sq, sk, h, d, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, device=device,
                        dtype=torch.bfloat16) for s in (sq, sk, sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40),     # UNet level 0 self
    (2, 4096, 77, 8, 40),       # level 0 cross (ragged last key tile)
    (2, 1024, 1024, 8, 80),     # level 1 self
    (2, 1024, 77, 8, 80),       # level 1 cross
    (2, 256, 256, 8, 160),      # level 2 self: one consumer warpgroup
    (2, 256, 77, 8, 160),       # level 2 cross
    (2, 64, 64, 8, 160),        # mid block self
    (2, 64, 77, 8, 160),        # mid block cross
    (1, 4096, 4096, 1, 512),    # VAE mid block, wide head: mma.sync
    (1, 200, 130, 2, 256),      # D 256: mma.sync, two warps a row group
    (1, 100, 33, 3, 24),        # ragged query and key tiles, mma.sync
    (1, 100, 33, 3, 160),       # the same on wgmma
    (1, 70, 45, 2, 20),         # D % 8 != 0: mma.sync, element loads
    (1, 4095, 129, 2, 40),      # Sq % 128 != 0, kv_len % 128 == 1
    (2, 100, 1, 2, 32),         # one key, mma.sync
    (2, 100, 1, 2, 80),         # one key, wgmma
    (1, 300, 77, 2, 48),        # D 48: mma.sync, padded to 48
    (1, 150, 200, 2, 72),       # D 72: mma.sync, padded to 80
    (1, 16384, 16384, 1, 512),  # SDXL's VAE mid block at 128x128
    (1, 4095, 129, 2, 64),      # SDXL's head dim: ragged Sq and kv_len
    (2, 100, 77, 3, 64),        # one ragged query block, 77 keys
    (2, 100, 1, 2, 64),         # one key
])
def test_cuda_kernel_matches_plain(cuda_device, b, sq, sk, h, d):
    q, k, v = _qkv(cuda_device, b, sq, sk, h, d)
    reset_counters()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert flash_attention.shapes == {(b, sq, sk, h, d): 1}
    path = "wgmma" if d in (40, 64, 80, 160) else "mma.sync"
    assert flash_attention.paths == {path: 1}
    ref = flash_attention_plain(q, k, v)
    assert torch.isfinite(out).all()
    assert_agrees(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["self", "cross"])
@pytest.mark.parametrize("sq,h,d", [(4096, 8, 40), (1024, 8, 80),
                                    (256, 8, 160), (64, 8, 160),
                                    (4096, 10, 64), (1024, 20, 64)])
def test_cuda_kernel_fused_projection_views(cuda_device, layout, sq, h, d):
    """q, k, v as the models hand them over: views of one fused qkv
    projection (self), or q alone and k, v views of one kv projection of
    the 77-token context (cross); SD1.5's shapes and SDXL's four (head
    dim 64). TMA reads them in place: the wgmma path, no copy."""
    b, inner = 2, h * d
    g = torch.Generator(cuda_device).manual_seed(sq + d)
    kw = dict(generator=g, device=cuda_device, dtype=torch.bfloat16)
    if layout == "self":
        q, k, v = torch.randn((b, sq, 3 * inner), **kw).split(inner, dim=-1)
    else:
        q = torch.randn((b, sq, inner), **kw)
        k, v = torch.randn((b, 77, 2 * inner), **kw).split(inner, dim=-1)
    q, k, v = (t.unflatten(-1, (h, d)) for t in (q, k, v))
    reset_counters()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.paths == {"wgmma": 1}
    assert_agrees(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_cuda_kernel_takes_mma_sync_for_a_misaligned_base(cuda_device):
    """A q that starts 2 bytes past a 16-byte boundary is no TMA
    operand: the mma.sync kernel takes it, by layout, and agrees."""
    b, s, h, d = 1, 130, 2, 40
    q, k, v = _qkv(cuda_device, b, s, s, h, d)
    flat = torch.empty((q.numel() + 1,), dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape).copy_(q)
    reset_counters()
    out = flash_attention(shifted, k, v)
    torch.cuda.synchronize()
    assert flash_attention.paths == {"mma.sync": 1}
    assert_agrees(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_cuda_kernel_strided_views_and_kv_len(cuda_device):
    """q, k, v as views of one fused projection (the models' layout), and
    an explicit kv_len that masks the tail of K/V."""
    b, s, h, d = 2, 300, 4, 40
    g = torch.Generator(cuda_device).manual_seed(1)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    out = flash_attention(q, k, v, kv_len=257)
    ref = flash_attention_plain(q.contiguous(), k[:, :257].contiguous(),
                                v[:, :257].contiguous())
    torch.cuda.synchronize()
    assert_agrees(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 77, 129])
def test_cuda_kernel_d64_views_and_kv_len(cuda_device, kv_len):
    """SDXL's head dim on wgmma: q, k, v as views of one fused projection
    with an explicit kv_len (one key, the CLIP context, a tile and one)."""
    b, s, h, d = 2, 300, 3, 64
    g = torch.Generator(cuda_device).manual_seed(kv_len)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    reset_counters()
    out = flash_attention(q, k, v, kv_len=kv_len)
    ref = flash_attention_plain(q.contiguous(), k[:, :kv_len].contiguous(),
                                v[:, :kv_len].contiguous())
    torch.cuda.synchronize()
    assert flash_attention.paths == {"wgmma": 1}
    assert_agrees(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (300, 77)])
def test_cuda_kernel_d64_on_mma_sync(cuda_device, sq, sk):
    """D = 64 that TMA cannot take (a base 2 bytes past a 16-byte
    boundary) runs the mma.sync kernel's own D = 64 instance, by layout,
    and agrees."""
    b, h, d = 2, 4, 64
    q, k, v = _qkv(cuda_device, b, sq, sk, h, d, seed=sk)
    flat = torch.empty((q.numel() + 1,), dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape).copy_(q)
    reset_counters()
    out = flash_attention(shifted, k, v)
    torch.cuda.synchronize()
    assert flash_attention.paths == {"mma.sync": 1}
    assert_agrees(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_cuda_flash_d64_repeats_bit_for_bit(cuda_device):
    """SDXL's 32x32 self attention on wgmma (three consumer warpgroups in
    turn) gives the same bits on a second launch."""
    q, k, v = _qkv(cuda_device, 2, 1024, 1024, 20, 64)
    first = flash_attention(q, k, v)
    assert torch.equal(first, flash_attention(q, k, v))


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 16, 16, 1, 8)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(*_qkv(cuda_device, 1, 16, 16, 1, 520))


# -- fused GroupNorm-affine + SiLU + conv3x3 ----------------------------------

def _gn_conv_inputs(device, b, h, w, c, f, seed=0):
    """bf16 unit-normal x, fp32 affine with a nonzero shift (so that a
    border activated as silu(b) instead of 0 shows), a bf16 HWIO kernel
    viewed from OHWI memory as the models hold it, fp32 bias."""
    g = torch.Generator(device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    x = torch.randn((b, h, w, c), dtype=torch.bfloat16, **kw)
    a = torch.rand((b, c), **kw) + 0.5
    shift = torch.randn((b, c), **kw) * 0.5
    ohwi = (torch.randn((f, 3, 3, c), **kw) / (9 * c) ** 0.5).bfloat16()
    bias = torch.randn((f,), **kw) * 0.1
    return x, a, shift, ohwi.permute(1, 2, 3, 0), bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,f", [
    (2, 64, 64, 320, 320),      # UNet level 0 (no split)
    (2, 32, 32, 960, 640),      # level 1 skip concat (a cluster of 2)
    (2, 16, 16, 1280, 1280),    # level 2 (a cluster of 4)
    (2, 8, 8, 2560, 1280),      # 8x8 level: both images a block, a
                                # cluster of 8 splits the channels
    (1, 7, 5, 40, 24),          # ragged tiles, C % 64 != 0
    (3, 5, 64, 16, 8),          # W = 64: two rows a block, a partial group
    (1, 130, 1, 8, 8),          # W = 1: 64 rows a block, three groups
    (1, 128, 128, 512, 512),    # VAE 128x128: 2-row tiles of 64 columns
    (1, 512, 512, 128, 128),    # VAE 512x512: eight stretches a row
    (2, 5, 100, 72, 40),        # ragged W: stretches of 64 and 36, odd H
    (1, 3, 65, 16, 8),          # W = 65: a last stretch of one column
    (1, 16, 130, 64, 384),      # 128-channel blocks, stretches 64, 64, 2
    (1, 8, 8, 1024, 256),       # 128-channel blocks, a cluster of 8
    (1, 256, 256, 128, 256),    # VAE encoder: channels rise 128 -> 256
    (1, 128, 128, 256, 512),    # VAE encoder: channels rise 256 -> 512
])
def test_cuda_fused_conv_matches_plain(cuda_device, b, h, w, c, f):
    x, a, shift, kernel, bias = _gn_conv_inputs(cuda_device, b, h, w, c, f)
    reset_conv_counters()
    out = gn_silu_conv3x3(x, a, shift, kernel, bias)
    torch.cuda.synchronize()
    assert gn_silu_conv3x3.launches == 1
    assert gn_silu_conv3x3.shapes == {(b, h, w, c, f): 1}
    ref = gn_silu_conv3x3_plain(x, a, shift, kernel, bias)
    assert torch.isfinite(out).all()
    assert_agrees(out, ref)


@pytest.mark.cuda
def test_cuda_fused_conv_refuses_what_it_does_not_take(cuda_device):
    x, a, shift, kernel, bias = _gn_conv_inputs(cuda_device, 1, 4, 4, 16, 8)
    with pytest.raises(TypeError):
        gn_silu_conv3x3(x.float(), a, shift, kernel.float(), bias)
    with pytest.raises(ValueError):                     # C % 8 != 0
        gn_silu_conv3x3(*_gn_conv_inputs(cuda_device, 1, 4, 4, 12, 8))
    with pytest.raises(ValueError):                     # not NHWC memory
        gn_silu_conv3x3(x.transpose(1, 2), a, shift, kernel, bias)
    with pytest.raises(ValueError):                     # F odd
        gn_silu_conv3x3(*_gn_conv_inputs(cuda_device, 1, 2, 65, 16, 7))


# -- int8 matmul and conv3x3 --------------------------------------------------

def _int8(g, shape, device):
    return torch.randint(-127, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,per_token,out_dtype", [
    (8192, 320, 960, False, torch.bfloat16),   # UNet level 0 qkv
    (154, 768, 640, False, torch.bfloat16),    # cross kv: ragged M = 154
    (1, 768, 3072, True, torch.bfloat16),      # GPT-2 decode fc1: M = 1
    (32, 3072, 768, True, torch.bfloat16),     # GPT-2 prefill fc2
    (5, 48, 33, True, torch.float32),          # odd N, fp32 out
    (128, 1280, 1280, False, torch.bfloat16),  # mid block: swapped, split
    (2048, 640, 640, False, torch.bfloat16),   # level 1: a cluster of 2
    (8192, 320, 2560, False, torch.float32),   # persistent grid, fp32 out
    (5, 48, 33, True, torch.bfloat16),         # ragged K and N, bf16 out
    (300, 48, 33, False, torch.bfloat16),      # ragged, x on the 64-row side
])
def test_cuda_int8_matmul_matches_plain(cuda_device, m, k, n, per_token,
                                        out_dtype):
    g = torch.Generator(cuda_device).manual_seed(m + n)
    x_q, w_q = _int8(g, (m, k), cuda_device), _int8(g, (n, k), cuda_device)
    rows = m if per_token else 1
    row = torch.rand((rows,), generator=g, device=cuda_device) * 0.1 + 0.01
    col = torch.rand((n,), generator=g, device=cuda_device) * 0.01 + 1e-3
    bias = torch.randn((n,), generator=g, device=cuda_device)
    reset_int8_counters()
    # the weight as the modules hold it: (K, N) viewed from (N, K) memory
    out = int8_matmul(x_q, w_q.t(), row, col, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == 1 and int8_matmul.shapes == {(m, k, n): 1}
    ref = int8_matmul_plain(x_q, w_q.t(), row, col, bias, out_dtype)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,f", [
    (2, 64, 64, 320, 320),      # two warpgroups, C % 128 == 64
    (2, 8, 8, 2560, 1280),      # both images a tile, a cluster of 8
    (1, 5, 7, 32, 24),          # ragged tiles, C % 64 != 0
    (2, 32, 32, 640, 640),      # four rows a tile, a cluster of 2
    (2, 16, 16, 1280, 1280),    # one warpgroup, a cluster of 2
    (1, 3, 1, 16, 8),           # W 1, H 3, C 16
    (2, 3, 1, 48, 40),          # W 1, H 3, C 48: both images a tile
    (1, 4, 130, 16, 8),         # rows wider than a tile
    (2, 4, 6, 64, 200),         # two filter tiles, the second ragged
    (1, 5, 7, 32, 33),          # F odd: element stores
])
def test_cuda_int8_conv_matches_plain(cuda_device, b, h, w, c, f):
    g = torch.Generator(cuda_device).manual_seed(c + f)
    x_q = _int8(g, (b, h, w, c), cuda_device)
    kernel = _int8(g, (f, 3, 3, c), cuda_device).permute(1, 2, 3, 0)
    col = torch.rand((f,), generator=g, device=cuda_device) * 1e-4 + 1e-5
    bias = torch.randn((f,), generator=g, device=cuda_device)
    reset_int8_counters()
    out = int8_conv3x3(x_q, kernel, col, bias, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert int8_conv3x3.launches == 1
    ref = int8_conv3x3_plain(x_q, kernel, col, bias, torch.bfloat16)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_quantization_is_bit_identical_to_cpu(cuda_device):
    """Weight and activation scales (absmax / 127) and the int8 values
    quantized on the card equal the CPU's, which equal the reference's:
    the scales divide in IEEE arithmetic on both devices."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn((1280, 320), generator=g) * 0.05
    x = torch.randn((8, 1024, 320), generator=g) * 3
    data, scale = quantize_tensor(w)
    card_data, card_scale = quantize_tensor(w.to(cuda_device))
    assert torch.equal(card_scale.cpu(), scale)
    assert torch.equal(card_data.cpu(), data)
    for per_token in (False, True):
        s = act_scale_from_absmax(act_absmax(x, per_token=per_token))
        card_s = act_scale_from_absmax(act_absmax(x.to(cuda_device),
                                                  per_token=per_token))
        assert torch.equal(card_s.cpu(), s)
        assert torch.equal(quantize_act(x.to(cuda_device), card_s).cpu(),
                           quantize_act(x, s))


@pytest.mark.cuda
def test_cuda_wgmma_kernels_repeat_bit_for_bit(cuda_device):
    """Two launches on the same inputs give the same bits: the split
    sums run in a fixed order (8x8 fused conv over a cluster of 8, the
    mid block's int8 matmul over a cluster of 4)."""
    x, a, shift, kernel, bias = _gn_conv_inputs(cuda_device, 2, 8, 8, 1280,
                                                1280)
    first = gn_silu_conv3x3(x, a, shift, kernel, bias)
    assert torch.equal(first, gn_silu_conv3x3(x, a, shift, kernel, bias))
    g = torch.Generator(cuda_device).manual_seed(4)
    x_q, w_q = _int8(g, (128, 1280), cuda_device), \
        _int8(g, (1280, 1280), cuda_device)
    one = torch.ones((1,), device=cuda_device)
    col = torch.full((1280,), 1e-4, device=cuda_device)
    first = int8_matmul(x_q, w_q.t(), one, col, out_dtype=torch.float32)
    assert torch.equal(first, int8_matmul(x_q, w_q.t(), one, col,
                                          out_dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_flash_and_int8_conv_repeat_bit_for_bit(cuda_device):
    """Flash attention (wgmma, two consumer warpgroups in turn) and the
    int8 conv (the 8x8 level over a cluster of 8, summed in rank order)
    give the same bits on a second launch."""
    q, k, v = _qkv(cuda_device, 2, 1024, 1024, 8, 80)
    first = flash_attention(q, k, v)
    assert torch.equal(first, flash_attention(q, k, v))
    g = torch.Generator(cuda_device).manual_seed(6)
    x_q = _int8(g, (2, 8, 8, 1280), cuda_device)
    kernel = _int8(g, (1280, 3, 3, 1280), cuda_device).permute(1, 2, 3, 0)
    col = torch.full((1280,), 1e-5, device=cuda_device)
    bias = torch.zeros((1280,), device=cuda_device)
    first = int8_conv3x3(x_q, kernel, col, bias, out_dtype=torch.float32)
    assert torch.equal(first, int8_conv3x3(x_q, kernel, col, bias,
                                           out_dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_wgmma_kernels_refuse_misaligned_operands(cuda_device):
    """TMA reads 16-byte-aligned bases only: an operand that starts
    elsewhere raises before the launch."""
    g = torch.Generator(cuda_device).manual_seed(5)
    one = torch.ones((1,), device=cuda_device)
    x_q = _int8(g, (64 * 48 + 1,), cuda_device)[1:].view(64, 48)
    with pytest.raises(ValueError, match="aligned"):
        int8_matmul(x_q, _int8(g, (48, 32), cuda_device), one,
                    one.expand(32))
    x, a, shift, kernel, bias = _gn_conv_inputs(cuda_device, 1, 4, 4, 16, 8)
    flat = torch.empty((x.numel() + 1,), dtype=x.dtype, device=cuda_device)
    shifted = flat[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        gn_silu_conv3x3(shifted, a, shift, kernel, bias)
    x8 = _int8(g, (1 * 4 * 4 * 16 + 1,), cuda_device)[1:].view(1, 4, 4, 16)
    with pytest.raises(ValueError, match="aligned"):
        int8_conv3x3(x8, _int8(g, (3, 3, 16, 8), cuda_device),
                     one.expand(8), one.expand(8))


@pytest.mark.cuda
def test_cuda_int8_kernels_refuse_what_they_do_not_take(cuda_device):
    g = torch.Generator(cuda_device).manual_seed(0)
    one = torch.ones((1,), device=cuda_device)
    with pytest.raises(ValueError):                     # K % 16 != 0
        int8_matmul(_int8(g, (4, 20), cuda_device),
                    _int8(g, (20, 8), cuda_device), one, one.expand(8))
    with pytest.raises(TypeError):
        int8_matmul(torch.ones((4, 32), device=cuda_device),
                    _int8(g, (32, 8), cuda_device), one, one.expand(8))
    with pytest.raises(ValueError):                     # C % 16 != 0
        int8_conv3x3(_int8(g, (1, 4, 4, 24), cuda_device),
                     _int8(g, (3, 3, 24, 8), cuda_device), one.expand(8),
                     one.expand(8))


# -- the compiled loops: CUDA graphs of the DDIM and decode steps -------------

def _tiny_bf16(cfg, **unet_kw):
    """A tiny config with the serving dtype policy (bf16 UNet and VAE
    compute and parameter storage), so the kernels run; ``unet_kw``
    replaces UNet fields."""
    import dataclasses

    m = cfg.models
    return cfg.replace(models=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, dtype="bfloat16", **unet_kw),
        vae=dataclasses.replace(m.vae, dtype="bfloat16"),
        param_dtype="bfloat16"))


def _all_counters():
    from cassmantle_tpu_torch.ops import graphs

    return {(fn.__name__, attr): dict(v) if isinstance(v, dict) else v
            for (fn, attr), v in graphs.snapshot().items()}


def _reset_all():
    reset_counters()
    reset_conv_counters()
    reset_int8_counters()


@pytest.mark.cuda
def test_cuda_ddim_update_and_vae_scaling_bit_equal_to_cpu(cuda_device):
    """The DDIM update divides by the device tensor c_x and the VAE its
    latents by a device tensor of the scaling factor: IEEE divides on the
    card, bit-equal to the CPU's (and so to the reference's). Control: a
    division by the host value, which CUDA computes as a multiply by its
    reciprocal, departs from the CPU somewhere in the same data."""
    from cassmantle_tpu_torch.models.vae import unscale_latents
    from cassmantle_tpu_torch.ops.ddim import DDIMSchedule, ddim_update

    g = torch.Generator().manual_seed(7)
    x, eps = (torch.randn((2, 64, 64, 4), generator=g) for _ in range(2))
    cpu_c = DDIMSchedule.create(50).coefficients("cpu")
    card_c = DDIMSchedule.create(50).coefficients(cuda_device)
    assert torch.equal(card_c.table.cpu(), cpu_c.table)
    for i in (0, 17, 49):
        cpu = ddim_update(x, eps, *cpu_c.table[i])
        card = ddim_update(x.to(cuda_device), eps.to(cuda_device),
                           *card_c.table[i])
        assert torch.equal(card.cpu(), cpu)
    lat = torch.randn((2, 128, 128, 4), generator=g) * 5
    for factor in (0.18215, 0.13025):
        assert torch.equal(unscale_latents(lat.to(cuda_device),
                                           factor).cpu(),
                           unscale_latents(lat, factor))
    assert not torch.equal((lat.to(cuda_device) / 0.18215).cpu(),
                           lat / 0.18215)


@pytest.mark.cuda
def test_cuda_captured_step_counts_replayed_launches(cuda_device):
    """A flash launch captured in a graph: the warm-up and the capture
    leave the counters as they were, each replay adds its launch (shape
    and path too), and the replayed output equals an eager launch's."""
    from cassmantle_tpu_torch.ops.graphs import CapturedStep

    q, k, v = _qkv(cuda_device, 2, 256, 256, 8, 40)
    out = torch.zeros_like(q)
    _reset_all()
    step = CapturedStep(lambda: out.copy_(flash_attention(q, k, v)))
    assert flash_attention.launches == 0 and not flash_attention.shapes
    for _ in range(3):
        step.replay()
    torch.cuda.synchronize()
    shape = (2, 256, 256, 8, 40)
    assert flash_attention.launches == 3
    assert dict(flash_attention.shapes) == {shape: 3}
    assert dict(flash_attention.shape_paths) == {(shape, "wgmma"): 3}
    assert step.pool_bytes >= 0 and step.capture_s > 0
    assert torch.equal(out, flash_attention(q, k, v))


# the sampler fields of the new samplers' tiny cases, and their graph
# replays a call: DPM++ (fast), DPM++ in DeepCache pairs with an
# unpaired tail (turbo, 5 steps), consistency (lcm), Euler under encoder
# propagation, DPM++ under encprop composed with DeepCache
SAMPLER_CASES = {
    "fast": (dict(kind="dpmpp_2m"), {"step": 4}),
    "turbo": (dict(kind="dpmpp_2m", num_steps=5, deepcache=True),
              {"pair": 2, "tail": 1}),
    "lcm": (dict(consistency=True), {"step": 4}),
    "encprop_euler": (dict(kind="euler", encprop=True,
                           encprop_dense_steps=1), {"key": 1, "segment": 1}),
    "encprop_dpmpp_deepcache": (dict(kind="dpmpp_2m", encprop=True,
                                     deepcache=True, encprop_dense_steps=1),
                                {"key": 1, "segment": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["default", "fused_conv", "w8a8", "sdxl",
                                    "encprop", "deepcache",
                                    *SAMPLER_CASES])
def test_cuda_denoise_graph_equals_eager(cuda_device, preset):
    """The tiny pipeline's CFG sampler loop as replays of its captured
    bodies (the step; encprop's key step and segment, 4 steps at stride 3
    after one dense key; DeepCache's pair; the new samplers' steps, pairs
    and tails, ``SAMPLER_CASES``) equals the eager loop bit for bit on the
    same x_T and conditioning, and counts the same launches of every
    kernel per shape. A second graphed call reuses the graphs."""
    import dataclasses

    from cassmantle_tpu_torch.config import test_config, test_sdxl_config
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

    if preset == "sdxl":
        cfg = _tiny_bf16(test_sdxl_config(), num_heads=None)
        pipe = SDXLPipeline(cfg, device=cuda_device)
    else:
        kw = {} if preset == "default" else {"fused_conv": True,
                                             "conv_pad_to": 128}
        if preset in ("encprop", "deepcache"):
            kw = {}
        cfg = _tiny_bf16(test_config(), **kw)
        if preset == "w8a8":
            cfg = cfg.replace(models=dataclasses.replace(
                cfg.models, unet_w8a8=True, w8a8_min_size=0))
        if preset == "encprop":
            cfg = cfg.replace(sampler=dataclasses.replace(
                cfg.sampler, encprop=True, encprop_dense_steps=1))
        if preset == "deepcache":
            cfg = cfg.replace(sampler=dataclasses.replace(
                cfg.sampler, deepcache=True))
        if preset in SAMPLER_CASES:
            cfg = cfg.replace(sampler=dataclasses.replace(
                cfg.sampler, **SAMPLER_CASES[preset][0]))
        pipe = Text2ImagePipeline(cfg, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(8)
    hw = cfg.sampler.image_size // pipe.vae_scale
    x_t = torch.randn((2, hw, hw, 4), generator=g, device=cuda_device)
    runs = {}
    with torch.inference_mode():
        cond = pipe.encode(["a lighthouse at dusk", "the comet market"])
        for graphed in (False, True, True):
            _reset_all()
            final = pipe.denoise(x_t, cond, graphed=graphed)
            torch.cuda.synchronize()
            runs.setdefault(graphed, []).append((final, _all_counters()))
    (eager, eager_n), = runs[False]
    for final, n in runs[True]:
        assert torch.equal(final, eager)
        assert n == eager_n
    assert eager_n["flash_attention", "launches"] > 0
    if preset == "fused_conv":
        assert eager_n["gn_silu_conv3x3", "launches"] > 0
    if preset == "w8a8":
        assert eager_n["int8_matmul", "launches"] > 0
        assert eager_n["int8_conv3x3", "launches"] > 0
    assert list(pipe.full_variant.step_graphs) == [2]
    want = {"encprop": {"key": 1, "segment": 1},
            "deepcache": {"pair": 2},
            **{k: v[1] for k, v in SAMPLER_CASES.items()}}.get(
                preset, {"step": 4})
    graphs = pipe.full_variant.step_graphs[2].graphs
    assert {k: g.replays for k, g in graphs.items()} \
        == {k: 2 * n for k, n in want.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ddim", "euler", "dpmpp_2m"])
def test_cuda_img2img_graph_equals_eager(cuda_device, kind):
    """img2img on the tiny geometry with the fused VAE: the tail's
    captured step graph equals the eager tail bit for bit (the whole
    uint8 image, encoder and decoder included, from one seed), with the
    same launches of every kernel per shape; kernel 2 runs in the
    encoder and the decoder."""
    import dataclasses

    import numpy as np

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

    cfg = _tiny_bf16(test_config())
    cfg = cfg.replace(
        sampler=dataclasses.replace(cfg.sampler, kind=kind),
        models=dataclasses.replace(cfg.models, vae=dataclasses.replace(
            cfg.models.vae, fused_conv=True)))
    pipe = Text2ImagePipeline(cfg, device=cuda_device)
    images = np.random.default_rng(9).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    runs = {}
    for graphed in (False, True, True):
        _reset_all()
        out = pipe.generate_img2img(images, ["a harbor", "a comet"], 0.6,
                                    seed=3, graphed=graphed)
        runs.setdefault(graphed, []).append((out, _all_counters()))
    (eager, eager_n), = runs[False]
    for out, n in runs[True]:
        np.testing.assert_array_equal(out, eager)
        assert n == eager_n
    assert eager_n["flash_attention", "launches"] > 0
    assert eager_n["gn_silu_conv3x3", "launches"] > 0
    assert list(pipe.img2img_graphs) == [(2, (2, 32, 32, 4))]
    assert pipe.img2img_graphs[2, (2, 32, 32, 4)].graph.replays == 4


@pytest.mark.cuda
def test_cuda_jax_random_equal_to_cpu(cuda_device):
    """The reference's streams on the card: keys (PRNGKey, fold_in,
    split), bits and uniforms bit-equal to the CPU's; normals within 4
    float32 ulps (torch's log1p inside XLA's erfinv polynomial)."""
    from cassmantle_tpu_torch.utils import jax_random as jr

    for seed in (0, 0x1C3, 2 ** 32 - 1):
        keys = {}
        for dev in ("cpu", cuda_device):
            key = jr.fold_in(jr.PRNGKey(seed, dev), 901)
            keys[str(dev)] = torch.cat([key[None], jr.split(key, 3)])
        assert torch.equal(keys["cpu"], keys["cuda"].cpu())
        k_cpu, k_gpu = keys["cpu"][-1], keys["cuda"][-1]
        for shape in ((7,), (2, 64, 64, 4)):
            assert torch.equal(jr.random_bits(k_cpu, shape),
                               jr.random_bits(k_gpu, shape).cpu())
            lo = -0.99999994
            assert torch.equal(jr.uniform(k_cpu, shape, lo, 1.0),
                               jr.uniform(k_gpu, shape, lo, 1.0).cpu())
            ulps = (jr.normal(k_cpu, shape).view(torch.int32).long()
                    - jr.normal(k_gpu, shape).cpu().view(torch.int32).long())
            assert ulps.abs().max() <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8", [False, True])
def test_cuda_decode_graph_equals_eager(cuda_device, w8a8):
    """Greedy decode with its step graph replayed equals the eager steps:
    the same tokens and lengths, the same launches (W8A8: the int8
    matmul inside the graph), at two batch buckets; a second call reuses
    the kept graph."""
    import dataclasses

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    cfg = test_config()
    if w8a8:
        cfg = cfg.replace(models=dataclasses.replace(
            cfg.models, lm_w8a8=True, w8a8_min_size=0))
    gen = PromptGenerator(cfg, device=cuda_device)
    for seeds in (["The Night the Trains Sang"],
                  ["Chapter two: the harbor", "a", "The comet market at "
                   "dusk, where the archivists trade"]):
        out = {}
        for graphed in (False, True, True):
            _reset_all()
            toks, lens = gen.decode_ids_batch(seeds, graphed=graphed)
            out.setdefault(graphed, []).append((toks, lens,
                                                _all_counters()))
        (toks, lens, n), = out[False]
        for t, ln, c in out[True]:
            assert (t == toks).all() and (ln == lens).all()
            assert c == n
        assert (n["int8_matmul", "launches"] > 0) == w8a8
    assert all(s.graph is not None for s in gen.decode_graphs.values())


def _tiny_lm_config(family, **sampler):
    import dataclasses

    from cassmantle_tpu_torch.config import MistralConfig, test_config

    cfg = test_config()
    if family == "mistral":
        cfg = cfg.replace(models=dataclasses.replace(
            cfg.models, mistral=MistralConfig.tiny()))
    return cfg.replace(sampler=dataclasses.replace(cfg.sampler, **sampler))


# bucket 32 at batch 1; then bucket 32 at batch 3 (padded to 4) and the
# 55-token bucket, where the scratch tail leaves no room to speculate
SEED_TEXTS = (["The Night the Trains Sang"],
              ["Chapter two: the harbor", "b c d b c d b c d", "the tide",
               "The comet market at dusk, where the archivists trade"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_cuda_sampled_decode_graph_equals_eager(cuda_device, family):
    """Top-k sampled decode (T 0.7, k 40) with its step graph replayed
    equals the eager steps for the same seed, at two batch buckets (the
    noise is drawn outside the graph from the seeded generator); a second
    seed samples otherwise."""
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    cfg = _tiny_lm_config(family, text_temperature=0.7, text_top_k=40,
                          max_new_tokens=16)
    gen = PromptGenerator(cfg, device=cuda_device)
    for seeds in SEED_TEXTS:
        eager = gen.decode_ids_batch(seeds, seed=3, graphed=False)
        for _ in range(2):
            graphed = gen.decode_ids_batch(seeds, seed=3, graphed=True)
            assert all((g == e).all() for g, e in zip(graphed, eager))
        other, _ = gen.decode_ids_batch(seeds, seed=4, graphed=True)
        assert not (other == eager[0]).all()
    assert all(s.graph is not None for s in gen.decode_graphs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("family,mode", [("gpt2", "ngram"),
                                         ("gpt2", "draft_model"),
                                         ("mistral", "ngram")])
def test_cuda_spec_decode_graph_equals_eager(cuda_device, family, mode):
    """Speculative decode with its chunk graph replayed until the stop
    flag reads true equals the eager chunks: tokens, lengths and stats,
    at two batch buckets (the second with a dummy pad row), twice (the
    capture puts the loop state back); one host read a chunk."""
    import dataclasses

    from cassmantle_tpu_torch.config import GPT2Config, SpecDecodeConfig
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    draft = GPT2Config(vocab_size=256, hidden_size=32, num_layers=1,
                       num_heads=2, max_positions=64, dtype="float32")
    spec = SpecDecodeConfig(mode=mode, gamma=4, ngram=2,
                            draft_model=draft if mode != "ngram" else None)
    cfg = dataclasses.replace(_tiny_lm_config(family), spec_decode=spec)
    gen = PromptGenerator(cfg, device=cuda_device)
    for seeds in SEED_TEXTS:
        eager = gen.decode_ids_batch(seeds, graphed=False)
        eager_stats = gen.last_spec_stats
        for _ in range(2):
            graphed = gen.decode_ids_batch(seeds, graphed=True)
            assert all((g == e).all() for g, e in zip(graphed, eager))
            assert gen.last_spec_stats == eager_stats
    states = gen.spec_graphs.values()
    assert states and all(s.graph is not None for s in states)
    assert all(s.host_reads == s.graph.replays // 2 for s in states)


@pytest.mark.cuda
def test_cuda_capture_survives_a_scoring_thread(cuda_device):
    """Captures while another thread scores guesses (the serving seam's
    dispatch thread encoding, allocating and copying each batch back to
    the host): every capture completes, the scoring thread never fails,
    and each graph replays to its eager result. Captures are thread-local
    on the capturing thread's own stream, with no device-wide synchronize
    or cache release inside the window."""
    import threading
    import time

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.ops.graphs import CapturedStep
    from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer

    scorer = EmbeddingScorer(test_config().models.minilm, cuda_device,
                             batch_buckets=(64,), embed_cache_size=0)
    stop, errors, scored = threading.Event(), [], [0]

    def score():
        while not stop.is_set():
            try:
                scorer.embed([f"guess {scored[0]} {j}" for j in range(48)])
            except Exception as exc:       # surfaced below
                errors.append(exc)
                return
            scored[0] += 1

    thread = threading.Thread(target=score)
    thread.start()
    try:
        while scored[0] < 2 and thread.is_alive():
            time.sleep(0.01)
        g = torch.Generator(cuda_device).manual_seed(5)
        cases = []
        for _ in range(24):
            x = torch.randn((512, 512), generator=g, device=cuda_device)
            out = torch.empty_like(x)

            def step(x=x, out=out):
                return out.copy_(torch.tanh(x @ x.T) * 0.5 + x.softmax(-1))

            cases.append((CapturedStep(step), step, x, out))
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not errors, errors
    assert scored[0] > 2
    for captured, step, x, out in cases:
        captured.replay()
        replayed = out.clone()
        assert torch.equal(replayed, step().clone())


def _staged_mixed(pipe, requests, gap):
    """Requests [(prompts, seed)] through ``pipe``'s staged server: the
    second admitted ``gap`` steps into the first, each later one ``gap``
    steps after the previous requests' rows retired (the denoise thread
    held at that boundary until it is queued)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    srv = pipe._staged_server()
    base = dict(srv.stats)
    marks = {}

    def ready(i):
        def cond(s):
            if i == 0:
                return (s.stats["admissions"] > base["admissions"]
                        and s.stats["steps"] - base["steps"] >= gap)
            rows = sum(len(p) for p, _ in requests[:i])
            if s.stats["retirements"] - base["retirements"] < rows:
                return False
            marks.setdefault(i, s.stats["steps"])
            return s.stats["steps"] - marks[i] >= gap
        return cond

    conds = [ready(i) for i in range(len(requests) - 1)]
    held = [0]

    def hook(s):
        if held[0] < len(conds) and conds[held[0]](s):
            deadline = time.monotonic() + 60.0
            while (s._admit_q.empty() and not s._pend
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            held[0] += 1

    srv._on_step = hook
    try:
        with ThreadPoolExecutor(max_workers=len(requests)) as ex:
            futs = []
            for i, (prompts, seed) in enumerate(requests):
                while i and not conds[i - 1](srv):
                    time.sleep(0.001)
                futs.append(ex.submit(pipe.generate, prompts, seed))
            return [f.result(timeout=300) for f in futs]
    finally:
        srv._on_step = None


@pytest.mark.cuda
def test_cuda_staged_server_at_widths_1_2_4(cuda_device):
    """The staged image server (serving/stages.py) on the card, tiny bf16
    geometry, 4 slots, 12 DDIM steps: a one- and a two-prompt request
    bit-equal to the monolithic graphed path; mid-flight admission (A; B,
    two prompts, 2 steps in; C 2 steps after A retires) runs widths 4, 2
    and 1, each width's graph captured once, and each image within the
    monolithic path's own batch variance (row 0 of a two-prompt batch
    against the solo image) plus 0.5 of a level on the mean and 2 at the
    max; each width's graph replay bit-equal to its eager step; a second
    mixed run captures nothing."""
    import dataclasses
    import os

    import numpy as np

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.ops.ddim import initial_latents
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

    base = _tiny_bf16(test_config())
    cfg = base.replace(
        serving=dataclasses.replace(base.serving, staged_serving=True,
                                    denoise_slots=4),
        sampler=dataclasses.replace(base.sampler, num_steps=12))
    pipe = Text2ImagePipeline(cfg, device=cuda_device)
    prompts = ["a lighthouse at dusk", "the comet market",
               "a night train between cities", "an orchard in the snow"]

    def mono(p, seed=0, latents=None):
        os.environ["CASSMANTLE_NO_STAGED_SERVING"] = "1"
        try:
            return pipe.generate(p, seed=seed, latents=latents)
        finally:
            del os.environ["CASSMANTLE_NO_STAGED_SERVING"]

    def diff(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return float(d.mean()), int(d.max())

    try:
        for p, seed in ((prompts[:1], 7), (prompts[:2], 8)):
            assert np.array_equal(pipe.generate(p, seed=seed), mono(p, seed))
        srv = pipe._staged
        requests = [(prompts[:1], 21), (prompts[1:3], 22), (prompts[3:], 23)]
        w0 = dict(srv.width_steps)
        outs = _staged_mixed(pipe, requests, gap=2)
        assert all(srv.width_steps[w] > w0.get(w, 0) for w in (1, 2, 4))
        builds = dict(srv.builds)
        assert builds == {1: 1, 2: 1, 4: 1}
        yard = [0.0, 0]
        for p, seed in requests:
            rows = [initial_latents(torch.Generator(cuda_device)
                                    .manual_seed(k), 1, 64, pipe.vae_scale,
                                    device=cuda_device)
                    for k in (seed, seed + 1000)]
            y = diff(mono([p[0], prompts[0]], latents=torch.cat(rows))[:1],
                     mono(p[:1], seed))
            yard = [max(yard[0], y[0]), max(yard[1], y[1])]
        for out, (p, seed) in zip(outs, requests):
            mean, mx = diff(out, mono(p, seed))
            assert mean <= yard[0] + 0.5 and mx <= yard[1] + 2
        for w in (1, 2, 4):
            graphed, _ = srv.probe_step(list(range(w)), step=3)
            eager, _ = srv.probe_step(list(range(w)), step=3,
                                      graphed=False)
            assert torch.equal(graphed, eager), w
        _staged_mixed(pipe, requests, gap=2)
        assert dict(srv.builds) == builds
    finally:
        pipe.drop_staged()


@pytest.mark.cuda
def test_cuda_flash_refuses_inputs_that_require_grad(cuda_device):
    """The kernel has no backward: with grad on and an input requiring
    grad it raises rather than return an output cut from the graph."""
    q, k, v = _qkv(cuda_device, 1, 256, 256, 2, 64)
    reset_counters()
    flash_attention(q, k, v)                     # no input requires grad
    for leaf in (q, k, v):
        x = leaf.detach().requires_grad_(True)
        args = [x if t is leaf else t for t in (q, k, v)]
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*args)
        with torch.no_grad():
            flash_attention(*args)
    assert flash_attention.launches == 4


@pytest.mark.cuda
def test_cuda_trainer_forward_takes_the_plain_attention(cuda_device):
    """A differentiated UNet forward (plain_only, remat recompute too)
    launches no flash kernel, and its gradient reaches every attention
    projection; the no-grad forward of the same UNet launches flash."""
    import dataclasses

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.parallel.train import DiffusionTrainer

    cfg = test_config()
    cfg = cfg.replace(models=dataclasses.replace(
        cfg.models, unet=dataclasses.replace(cfg.models.unet,
                                             dtype="bfloat16")))
    tr = DiffusionTrainer(cfg, remat=True, device=cuda_device)
    tr.init_state(seed=0)
    g = torch.Generator(cuda_device).manual_seed(1)
    batch = {"latents": torch.randn((2, 8, 8, 4), generator=g,
                                    device=cuda_device),
             "context": torch.randn((2, 6, 64), generator=g,
                                    device=cuda_device)}
    reset_counters()
    loss = tr.step(batch, g)
    assert torch.isfinite(loss) and flash_attention.launches == 0
    projections = [(n, p) for n, p in tr.unet.named_parameters()
                   if "_attn" in n and (".self_attn." in n
                                        or ".cross_attn." in n)]
    assert projections
    for name, p in projections:
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    with torch.no_grad():
        tr.unet(batch["latents"], torch.tensor([5, 9], device=cuda_device),
                batch["context"])
    assert flash_attention.launches > 0


@pytest.mark.cuda
def test_cuda_fp32_clip_vision_tower_runs(cuda_device):
    """An unmasked fp32 attention (the CLIP vision tower) takes the plain
    path on the card, where the kernel would refuse fp32."""
    from cassmantle_tpu_torch.models.clip_vision import (
        ClipVisionConfig,
        ClipVisionEncoder,
    )
    from cassmantle_tpu_torch.models.layers import init_weights

    cfg = ClipVisionConfig.tiny()
    with torch.device(cuda_device):
        tower = ClipVisionEncoder(cfg)
    init_weights(tower, torch.Generator(cuda_device).manual_seed(0))
    images = torch.randn((2, 32, 32, 3), device=cuda_device)
    reset_counters()
    with torch.no_grad():
        emb = tower(images)
        ref = tower.cpu()(images.cpu())
    assert flash_attention.launches == 0
    torch.testing.assert_close(emb.cpu(), ref, rtol=0, atol=1e-5)
