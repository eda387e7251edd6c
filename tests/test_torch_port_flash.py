"""The port's flash attention: the plain version (what the wrapper runs on
a CPU tensor) against the reference's Pallas kernel in interpret mode and
against ``xla_attention``, in fp32, on the three modes of the serving
path; and the dispatch rules of ``ops/attention.py``. The CUDA kernel
itself is held against the plain version in ``test_torch_port_cuda.py``.

Tolerance in fp32: atol 1e-5 (the plain version and the kernel's online
softmax differ only in summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cassmantle_tpu.ops.attention import xla_attention
from cassmantle_tpu.ops.flash_attention import (
    WIDE_BLOCK,
    flash_attention as jax_flash,
    flash_cross_attention as jax_flash_cross,
)
from cassmantle_tpu_torch.ops import attention as port_attention
from cassmantle_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    reset_counters,
)

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

ATOL = 1e-5


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, sk, sk)]


@pytest.mark.parametrize("mode,b,sq,sk,h,d", [
    ("self", 1, 1024, 1024, 2, 40),      # one 1024-block, UNet head dim
    ("cross", 1, 1024, 77, 2, 40),       # ragged CLIP context, kv_len=77
    ("wide", 1, 1024, 1024, 1, 512),     # VAE mid block at 512-blocks
])
def test_plain_flash_matches_reference_kernel(mode, b, sq, sk, h, d):
    q, k, v = _qkv(0, b, sq, sk, h, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if mode == "self":
        ref = jax_flash(jq, jk, jv, interpret=True)
    elif mode == "cross":
        ref = jax_flash_cross(jq, jk, jv, interpret=True)
    else:
        ref = jax_flash(jq, jk, jv, interpret=True, block_q=WIDE_BLOCK,
                        block_k=WIDE_BLOCK)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla_attention(jq, jk,
                                                                     jv)),
                               atol=ATOL, rtol=0)


def test_plain_flash_kv_len_masks_the_tail():
    """Keys at or past kv_len contribute nothing: the same as attending
    over the first kv_len keys only."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(1, 2, 33, 90, 3, 24)]
    out = flash_attention_plain(q, k, v, kv_len=77)
    ref = flash_attention_plain(q, k[:, :77], v[:, :77])
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_plain_flash_rounds_p_like_the_kernel():
    """bf16 inputs: p is rounded to bf16 before p.v, the output is bf16."""
    q, k, v = [torch.from_numpy(a).bfloat16() for a in _qkv(2, 1, 64, 77, 2,
                                                             40)]
    out = flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = torch.einsum(
        "bhqk,bkhd->bqhd",
        torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                      * 40 ** -0.5, -1), v.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    reset_counters()
    q, k, v = [torch.from_numpy(a) for a in _qkv(3, 1, 16, 16, 2, 8)]
    flash_attention(q, k, v)
    assert flash_attention.launches == 0
    assert not flash_attention.shapes


@pytest.mark.parametrize("case", ["self", "cross", "masked", "kill_switch"])
def test_dispatch(case, monkeypatch):
    """Mask-free attention goes to flash_attention; masked attention and,
    under CASSMANTLE_NO_FLASH_CROSS, cross attention stay plain."""
    calls = []
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **kw: calls.append(a) or
                        flash_attention_plain(*a, **kw))
    sk = 16 if case in ("self", "masked") else 7
    q, k, v = [torch.from_numpy(a) for a in _qkv(4, 1, 16, sk, 2, 8)]
    mask = None
    if case == "masked":
        mask = torch.ones((16, 16), dtype=torch.bool).tril()
    if case == "kill_switch":
        monkeypatch.setenv("CASSMANTLE_NO_FLASH_CROSS", "1")
    out = port_attention.multi_head_attention(q, k, v, mask=mask)
    assert len(calls) == (1 if case in ("self", "cross") else 0)
    ref = port_attention.plain_attention(q, k, v, mask=mask)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
