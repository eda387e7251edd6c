"""Launch policy shared by the three implicit-GEMM kernels of
``csrc/igemm.cuh`` (the fused conv, the int8 matmul and the int8 conv):
their tile sizes and how far a launch splits its K loop.

The tile constants mirror ``igemm.cuh``'s ``BM``, ``BN`` and ``BKB``; the
wrappers size the split-K workspace from them.
"""

from __future__ import annotations

import functools

import torch

# One block's output tile (rows x columns) and the width of a K tile in
# bytes: igemm.cuh's BM, BN and BKB.
BLOCK_M = 128
BLOCK_N = 128
K_TILE_BYTES = 64


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (132 on an H100 SXM, 114 on an
    H100 PCIe)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_k(m: int, n: int, k_tiles: int, device: torch.device,
            min_k_tiles: int = 4, max_splits: int = 16) -> int:
    """How many slices the K loop of an (m, n) implicit GEMM on
    ``device`` splits into: 1 when its output tiles already fill the
    card's SMs, else enough slices for about two blocks per SM, each at
    least ``min_k_tiles`` K tiles long."""
    sms = sm_count(device)
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    if tiles >= sms:
        return 1
    return max(1, min(max_splits, -(-2 * sms // tiles),
                      k_tiles // min_k_tiles))
