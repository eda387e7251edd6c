"""The reference's random streams, in plain PyTorch.

The JAX package draws three things whose values are part of its result:
the consistency sampler's re-noise ladder (``normal(fold_in(PRNGKey(
0x1C3), t), ...)``), and img2img's encoder sample and tail noise
(``split(PRNGKey(seed))``); DDIM at eta > 0 draws its step noise from a
``split`` chain. This module is the port's copy of the semantics of JAX's
default PRNG as the reference runs it: threefry2x32 keys, with
``jax_threefry_partitionable`` on (JAX's default since 0.5):

- a key is two uint32 words; ``PRNGKey(seed)`` is (seed >> 32, seed &
  0xFFFFFFFF) of the seed as a 32-bit integer, so (0, seed mod 2^32);
- ``split(key, n)`` hashes the counters (0, i) for i < n: key i is the
  pair of output words;
- ``fold_in(key, d)`` hashes the one counter pair (0, d);
- ``random_bits(key, shape)`` hashes the counters (hi, lo) of each flat
  index (row-major) and keeps ``bits1 ^ bits2``;
- ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2),
  subtracts 1, scales to [lo, hi) and clamps at lo;
- ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
  XLA's float32 ``erfinv`` (Giles' single-precision polynomials in
  w = -log1p(-u^2), split at w = 5).

uint32 arithmetic runs in int64 tensors, masked to 32 bits (torch's
uint32 has few operations). Keys, bits and uniforms equal
``jax.random``'s bit for bit; normals differ from it only through
``log1p`` inside ``erfinv`` (torch's against XLA's), by at most a few
float32 ulps. Keys are (2,) int64 tensors holding the two words, on the
device that computes with them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds, of the counter pairs (x1, x2)
    under the key (k1, k2): two arrays of uint32 words in int64."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit mode): (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _hash_counters(key: torch.Tensor, shape: Tuple[int, ...]):
    """The hash of each flat index of ``shape`` as its (hi, lo) counter
    pair (JAX's ``iota_2x32_shape``)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b1, b2 = _hash_counters(key, (num,))
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a scalar ``data`` taken as
    uint32 (a Python int or a 0-dim tensor)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([b1, b2])


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words, in int64)."""
    b1, b2 = _hash_counters(key, _shape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    # the 31-bit patterns reinterpret as float32 in [1, 2)
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    dev = key.device
    lo = torch.tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.tensor(maxval, dtype=torch.float32, device=dev)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# float32 nextafter(-1, 0) and sqrt(2), as the reference's normal takes them
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's float32 erfinv: Horner coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (the reference's): p(w) * x, with
    w = -log1p(-x^2) and p a degree-8 polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3; +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = torch.tensor([_ERFINV_LT5, _ERFINV_GE5], dtype=torch.float32,
                        device=x.device)
    p = torch.where(lt, coef[0, 0], coef[1, 0])
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.where(lt, coef[0, i], coef[1, i]) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * torch.tensor(_SQRT2, dtype=torch.float32,
                                    device=key.device)
