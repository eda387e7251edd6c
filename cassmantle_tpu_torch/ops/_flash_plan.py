"""Launch plan of the flash-attention kernels (``csrc/flash_attention.cu``),
in plain Python so that the CPU tests reach it.

Two kernels, chosen by shape and layout, never as a rescue:

- ``wgmma``: the warp-specialised kernel (TMA loads, wgmma for both
  products). It takes the UNets' head dims (SD1.5's 40, 80, 160 and
  SDXL's 64) with 16-byte-aligned bases, strides that are multiples of
  16 bytes and a positive scale: every UNet shape.
- ``mma.sync``: the kernel of the first port, for the rest: the VAE mid
  block's D = 512 (its 64 x 512 fp32 accumulator does not fit one
  warpgroup's registers), any other head dim, strides or bases TMA
  cannot describe, scale <= 0.

The constants name the source's instantiations: the C functions take
the plan's instance, D boxes, k-steps and grid, and refuse any that
they do not build.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

WGMMA = "wgmma"
MMA_SYNC = "mma.sync"

# wgmma: head dim (p.v's N) -> (keys a tile, K/V ring stages, the most
# consumer warpgroups), as instantiated (cassmantle_flash_attention_wgmma).
# D = 40, 64 and 80 take 128-key tiles, D = 160 64 keys, so that O, S
# and P stay within a consumer's registers; D = 40's and 64's fit the 160
# registers of three consumers. D = 64 (SDXL) was chosen by
# tools/sweep_flash_d64.py on the card.
INSTANCES = {40: (128, 3, 3), 64: (128, 3, 3), 80: (128, 2, 2),
             160: (64, 3, 2)}
BOX = 64               # head-dim columns of one TMA box (128 bytes)
WGMMA_ROWS = 64        # query rows of one consumer warpgroup

# mma.sync: padded head dim -> (query rows, keys a tile), as instantiated
# (cassmantle_flash_attention_bf16).
MMA_SYNC_INSTANCES = {32: (64, 64), 48: (64, 64), 64: (64, 64),
                      80: (64, 64), 160: (64, 32), 256: (64, 32),
                      512: (32, 32)}
MAX_HEAD_DIM = max(MMA_SYNC_INSTANCES)


class FlashPlan(NamedTuple):
    path: str                    # WGMMA or MMA_SYNC
    np: int                      # padded head dim (d on wgmma)
    bq: int                      # query rows a block
    bk: int                      # keys a tile
    stages: int                  # K/V ring depth (wgmma; 0 else)
    consumers: int               # consumer warpgroups (wgmma; 0 else)
    boxes: int                   # TMA boxes along D (wgmma; 0 else)
    ksteps: int                  # q.k^T k-steps of 16: ceil(np / 16)
    grid: Tuple[int, int, int]   # (query blocks, heads, batch)


def tma_layout_ok(shape, strides, data_ptr: int) -> bool:
    """A (B, S, H, D) bf16 operand that a TMA map can describe: a
    16-byte-aligned base, a unit stride on D and element strides of the
    other dimensions (those of size > 1) that are multiples of 8."""
    if data_ptr % 16 or strides[3] != 1:
        return False
    return all(n == 1 or s % 8 == 0 for n, s in zip(shape[:3], strides[:3]))


def flash_plan(b: int, sq: int, h: int, d: int, sms: int,
               tma_ok: bool = True, scale: float = 1.0) -> FlashPlan:
    """The kernel and launch for q (b, sq, h, d) on a card of ``sms``
    SMs (the key count changes neither). ``tma_ok``: every operand passes
    :func:`tma_layout_ok`. The wgmma kernel gives each block three
    consumer warpgroups (192 query rows) where the instance has them and
    those blocks fill the card, else two (128 rows) where those cover at
    least half the card, else one (64 rows), so that small grids spread
    wider."""
    if d in INSTANCES and tma_ok and scale > 0:
        np = d
        bk, stages, most = INSTANCES[np]
        if most == 3 and -(-sq // (3 * WGMMA_ROWS)) * h * b >= sms:
            nc = 3
        elif -(-sq // (2 * WGMMA_ROWS)) * h * b * 2 >= sms:
            nc = 2
        else:
            nc = 1
        bq = nc * WGMMA_ROWS
        return FlashPlan(WGMMA, np, bq, bk, stages, nc, -(-np // BOX),
                         -(-np // 16), (-(-sq // bq), h, b))
    np = min(n for n in MMA_SYNC_INSTANCES if n >= d)
    bq, bk = MMA_SYNC_INSTANCES[np]
    return FlashPlan(MMA_SYNC, np, bq, bk, 0, 0, 0, 0, (-(-sq // bq), h, b))
