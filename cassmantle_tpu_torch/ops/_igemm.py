"""Launch policy of the port's GEMM-shaped kernels, in plain Python so
that the CPU tests reach it:

- :func:`matmul_plan` for the int8 matmul on wgmma (``csrc/int8_gemm.cu``,
  kernel 3): orientation, tile width and the K slices of one cluster;
- :func:`conv_plan` for the fused GroupNorm + SiLU + conv3x3 on wgmma
  (``csrc/fused_conv.cu``, kernel 2): image rows of a column stretch,
  or images, a block and the channel-chunk slices of one cluster;
- :func:`int8_conv_plan` for the int8 conv3x3 on wgmma
  (``csrc/int8_gemm.cu``, kernel 4): the pixel tile that one TMA box per
  tap brings, the consumer warpgroups, the filter width and the K slices
  of one cluster.

The wrappers read their plan here and the C functions take what it
decides; the constants mirror the sources'.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# kernels 2 to 4 (wgmma): rows of one consumer warpgroup, the most
# blocks of one cluster (the portable limit), kernel 3's and 4's K tile
# in bytes and kernel 3's token tiles on the swapped path, kernel 2's
# channel chunk, kernel 2's and 4's output channels a block, kernel 2's
# pixels a block, halo positions and widest column stretch.
WGMMA_M = 64
MAX_CLUSTER = 8
MATMUL_K_TILE = 128
SMALL_M = 256
TOKEN_TILES = (8, 32, 128, 160)
CONV_CHUNK = 64
CONV_BN = 160
CONV_PIXELS = 128
CONV_HALO = 264
CONV_COLS = 64


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (132 on an H100 SXM, 114 on an
    H100 PCIe)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_slices(tiles: int, k_units: int, sms: int) -> int:
    """Blocks of one cluster that split the K loop (``k_units`` chunks
    or tiles) of each of ``tiles`` output tiles, one block per SM: the
    largest power of two that one wave of the card's SMs holds, at most
    MAX_CLUSTER and ``k_units`` (so that every slice is non-empty); 1
    when the tiles alone fill the card. Clusters above 2 blocks take at
    most half the card: a cluster's blocks share one GPC (16 or 18 SMs
    on an H100), and the card measured 2x slower when clusters of 4
    were to fill it (PERF.md, PR 3). Powers of two pack the GPCs."""
    limit = min(MAX_CLUSTER, k_units, sms // tiles)
    slices = 1
    while 2 * slices <= limit:
        slices *= 2
    while slices > 2 and tiles * slices > sms // 2:
        slices //= 2
    return slices


class MatmulPlan(NamedTuple):
    swap: bool      # the weight on wgmma's 64-row side, tokens its N
    rows: int       # rows of the 64-row side a block (64 or 128)
    bn: int         # wgmma N: the other side's rows a block
    tiles: int      # output tiles
    slices: int     # blocks of one cluster along K
    grid: int       # blocks along x: every tile when split, else a
                    # persistent grid of at most one block per SM


def matmul_plan(m: int, k: int, n: int, sms: int) -> MatmulPlan:
    """Kernel 3's launch for (m, k) x (k, n) on a card of ``sms`` SMs.
    m <= SMALL_M swaps the operands: 64 weight rows a block, the tokens
    padded to the smallest of TOKEN_TILES that holds them (several
    tiles of 160 past it). Else 128 x 160 tiles where 160 divides n,
    128 x 128 otherwise. Unsplit, a persistent grid of at most one block
    per SM walks the tiles."""
    k_tiles = -(-k // MATMUL_K_TILE)
    if m <= SMALL_M:
        bn = next((t for t in TOKEN_TILES if t >= m), TOKEN_TILES[-1])
        rows = WGMMA_M
        tiles = -(-n // rows) * -(-m // bn)
        swap = True
    else:
        bn = 160 if n % 160 == 0 else 128
        rows = 2 * WGMMA_M
        tiles = -(-m // rows) * -(-n // bn)
        swap = False
    slices = cluster_slices(tiles, k_tiles, sms)
    grid = tiles if slices > 1 else min(tiles, sms)
    return MatmulPlan(swap, rows, bn, tiles, slices, grid)


class ConvPlan(NamedTuple):
    th: int         # image rows a block
    tw: int         # image columns a block: W, or a stretch of CONV_COLS
    imgs: int       # whole images a block (th == h when > 1)
    bn: int         # output channels a block: CONV_BN, or 128
    tiles: int      # output tiles: pixel groups x bn-channel blocks
    slices: int     # blocks of one cluster along the channel chunks


def conv_plan(b: int, h: int, w: int, c: int, f: int, sms: int
              ) -> ConvPlan:
    """Kernel 2's launch for x (b, h, w, c) and f output channels on a
    card of ``sms`` SMs: a block owns th image rows of a tw-column
    stretch, up to CONV_PIXELS pixels and CONV_HALO halo positions
    ((th + 2)(tw + 2) per image). W <= CONV_COLS takes whole rows
    (tw = W); a wider W takes 2-row tiles of a CONV_COLS stretch, whose
    halo is the 264 positions of the W = 64 tile, with a ragged last
    stretch where CONV_COLS does not divide W. Images small enough are
    packed several a block, so that the weight streams once for them.
    Blocks take CONV_BN output channels (every UNet F is a multiple),
    or 128 where 128 divides F and CONV_BN does not (the VAE's 128, 256
    and 512, which CONV_BN-wide blocks would fill to 80%)."""
    tw = min(w, CONV_COLS)
    th = max(1, min(h, 64, CONV_PIXELS // tw))
    imgs = 1
    if th == h and tw == w:
        imgs = max(1, min(b, CONV_PIXELS // (h * w),
                          CONV_HALO // ((h + 2) * (w + 2))))
    groups = (-(-b // imgs) if imgs > 1
              else b * -(-h // th) * -(-w // tw))
    bn = 128 if f % CONV_BN and f % 128 == 0 else CONV_BN
    tiles = groups * -(-f // bn)
    return ConvPlan(th, tw, imgs, bn, tiles,
                    cluster_slices(tiles, -(-c // CONV_CHUNK), sms))


class Int8ConvPlan(NamedTuple):
    wgs: int        # consumer warpgroups: 64 pixels each
    imgs: int       # the pixel tile: images,
    rows: int       # image rows
    cols: int       # and pixels of a row (W, or a stretch of one row)
    tiles: int      # output tiles: pixel tiles x CONV_BN-filter tiles
    k_units: int    # 9 taps x ceil(C / 128) channel chunks
    slices: int     # blocks of one cluster along the K units
    grid: int       # blocks along x: every tile when split, else a
                    # persistent grid of at most one block per SM


def conv_pixel_tile(b: int, h: int, w: int, pixels: int):
    """(imgs, rows, cols) of a pixel tile of at most ``pixels`` that one
    4-D TMA box (channels, W, H, B) per tap brings, its pixels
    consecutive in NHWC order: a stretch of one row where W alone fills
    it, else whole rows, and whole images where H rows fit."""
    if w >= pixels:
        return 1, 1, pixels
    rows = min(h, pixels // w)
    imgs = min(b, pixels // (h * w)) if rows == h else 1
    return imgs, rows, w


def int8_conv_plan(b: int, h: int, w: int, c: int, f: int, sms: int
                   ) -> Int8ConvPlan:
    """Kernel 4's launch for x (b, h, w, c) int8 and f filters on a card
    of ``sms`` SMs: CONV_BN filters a tile (every main-path f is a
    multiple of it; TMA zero-fills a ragged last tile); pixel tiles of
    128 (two consumer warpgroups) or 64 (one), whichever puts more
    blocks on the card (within 1/8 of each other the larger tile, which
    streams the weight half as often); where the tiles are too few, a
    cluster splits the K units (``cluster_slices``)."""
    k_units = 9 * -(-c // MATMUL_K_TILE)
    best, best_blocks = None, 0
    for wgs in (2, 1):
        imgs, rows, cols = conv_pixel_tile(b, h, w, wgs * WGMMA_M)
        tiles = (-(-b // imgs) * -(-h // rows) * -(-w // cols)
                 * -(-f // CONV_BN))
        slices = cluster_slices(tiles, k_units, sms)
        grid = tiles if slices > 1 else min(tiles, sms)
        blocks = grid * slices
        if best is None or blocks * 8 > best_blocks * 9:
            best = Int8ConvPlan(wgs, imgs, rows, cols, tiles, k_units,
                                slices, grid)
            best_blocks = blocks
    return best
