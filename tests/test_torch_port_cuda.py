"""The port's CUDA kernels on the card: each against its plain PyTorch
version. Marked ``cuda``; without a card every test skips. This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU.)

Tolerance for the flash kernel, bf16 unit-normal inputs, scaled to the
reference because the output's spread shrinks as sqrt(e / Sk):
max |kernel - plain| <= 2^-6 * max |plain| (2 to 4 bf16 ulps of it) and
||kernel - plain||_2 <= 1e-2 * ||plain||_2. Both sides round the output to
bf16; the kernel rounds p to bf16 against its running max, the plain
version against the row max, and the two sum in another order.
"""

import pytest
import torch

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
    (2, 256, 77, 8, 160),       # level 2 cross
    (2, 64, 64, 8, 160),        # mid block self
    (1, 4096, 4096, 1, 512),    # VAE mid block, wide head
    (1, 200, 130, 2, 256),      # two warps per row group
    (1, 100, 33, 3, 24),        # ragged query and key tiles
    (1, 70, 45, 2, 20),         # D % 8 != 0: element-wise tile loads
])
def test_cuda_kernel_matches_plain(cuda_device, b, sq, sk, h, d):
    q, k, v = _qkv(cuda_device, b, sq, sk, h, d)
    reset_counters()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert flash_attention.shapes == {(b, sq, sk, h, d): 1}
    ref = flash_attention_plain(q, k, v)
    assert torch.isfinite(out).all()
    assert_agrees(out, ref)


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
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 16, 16, 1, 8)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(*_qkv(cuda_device, 1, 16, 16, 1, 520))
