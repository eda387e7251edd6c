"""The launch policy of the port's wgmma kernels (``ops/_igemm.py``), on
the CPU: for every main-path shape of the int8 matmul (kernel 3) and the
fused GroupNorm + SiLU + conv3x3 (kernel 2), on an H100 SXM (132 SMs)
and an H100 PCIe (114 SMs), the plan fills the card, swaps the operands
exactly at small M, keeps clusters within the portable limit, leaves no
K slice empty and tiles F without waste where the policy says so."""

import pytest

import chip_smoke
from cassmantle_tpu_torch.ops import _igemm

SMS = (132, 114)
MATMUL_SHAPES = sorted(set(chip_smoke.UNET_MATMUL_SHAPES)
                       | set(chip_smoke.LM_MATMUL_SHAPES))
CONV_SHAPES = sorted(chip_smoke.CONV_SHAPES)
WGMMA_S8_N = (8, 32, 128, 160)          # the int8 wgmma shapes built


def slice_bounds(units: int, slices: int):
    """The K range of each rank, as the kernels split it."""
    return [(r * units // slices, (r + 1) * units // slices)
            for r in range(slices)]


def assert_fills_and_splits(tiles, slices, k_units, sms):
    assert 1 <= slices <= _igemm.MAX_CLUSTER
    assert slices & (slices - 1) == 0            # packs the card's GPCs
    assert all(hi > lo for lo, hi in slice_bounds(k_units, slices))
    if tiles >= sms:
        assert slices == 1                       # the tiles fill the card
    else:
        assert tiles * slices <= sms             # one wave
    if slices > 2:                               # clusters of 4 and 8
        assert tiles * slices <= sms // 2        # fit one wave's GPCs
    # blocks for a quarter of the card at least, unless the K depth or
    # the cluster limit forbids more slices (a power of two falls short
    # of the most that fit by less than half)
    assert tiles * slices >= min(sms // 4,
                                 tiles * min(_igemm.MAX_CLUSTER, k_units) // 2)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_plan(m, k, n, sms):
    plan = _igemm.matmul_plan(m, k, n, sms)
    k_tiles = -(-k // _igemm.MATMUL_K_TILE)
    assert plan.swap == (m <= _igemm.SMALL_M)
    assert plan.bn in WGMMA_S8_N
    if plan.swap:
        # the weight on the 64-row side, every token in one N tile
        assert plan.rows == 64 and plan.bn >= m
        assert plan.tiles == -(-n // 64)
    else:
        assert plan.rows == 128
        if n % 160 == 0:                          # every UNet N
            assert plan.bn == 160
        assert plan.tiles == -(-m // 128) * -(-n // plan.bn)
    assert_fills_and_splits(plan.tiles, plan.slices, k_tiles, sms)
    # split: a block per tile and slice; else a persistent grid
    assert plan.grid == (plan.tiles if plan.slices > 1
                         else min(plan.tiles, sms))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,h,w,c,f", CONV_SHAPES)
def test_conv_plan(b, h, w, c, f, sms):
    plan = _igemm.conv_plan(b, h, w, c, f, sms)
    pixels = plan.th * w * plan.imgs
    assert pixels <= _igemm.CONV_PIXELS
    assert plan.imgs * (plan.th + 2) * (w + 2) <= _igemm.CONV_HALO
    assert f % _igemm.CONV_BN == 0               # 160 divides every F
    if h * w <= 64:
        # the 8x8 level packs both CFG images: the weight streams once
        assert plan.imgs == b and pixels == _igemm.CONV_PIXELS
    else:
        assert plan.imgs == 1 and pixels == _igemm.CONV_PIXELS
    groups = -(-b // plan.imgs) * -(-h // plan.th)
    assert plan.tiles == groups * f // _igemm.CONV_BN
    assert_fills_and_splits(plan.tiles, plan.slices,
                            -(-c // _igemm.CONV_CHUNK), sms)


@pytest.mark.parametrize("m,want", [(1, 8), (8, 8), (9, 32), (32, 32),
                                    (33, 128), (128, 128), (154, 160),
                                    (200, 160), (256, 160), (257, 160)])
def test_matmul_token_tile(m, want):
    """Small M pads the tokens to the smallest wgmma N that holds them;
    past 160 two tiles of 160; past SMALL_M the operands stay as they
    are, x on the 128-row side."""
    plan = _igemm.matmul_plan(m, 768, 1280, 132)
    assert plan.bn == want
    assert plan.swap == (m <= 256)
    if plan.swap:
        assert plan.tiles == (1280 // 64) * -(-m // want)


@pytest.mark.parametrize("b,h,w", [(1, 7, 5), (3, 5, 64), (1, 130, 1),
                                   (2, 8, 8), (3, 8, 8), (4, 4, 4)])
def test_conv_plan_ragged_geometry(b, h, w):
    """Odd geometries stay within the kernel's halo and tile limits, and
    the pixel groups cover every image row exactly once."""
    plan = _igemm.conv_plan(b, h, w, 40, 24, 132)
    assert plan.th * w * plan.imgs <= _igemm.CONV_PIXELS
    assert plan.imgs * (plan.th + 2) * (w + 2) <= _igemm.CONV_HALO
    assert plan.imgs == 1 or plan.th == h
    rows = {(n, y) for g in range(-(-b // plan.imgs))
            for i in range(plan.imgs) for gy in range(-(-h // plan.th))
            for y in range(gy * plan.th, min(h, (gy + 1) * plan.th))
            for n in [g * plan.imgs + i] if n < b}
    assert rows == {(n, y) for n in range(b) for y in range(h)}
    assert plan.slices == 1                      # one chunk of 40 channels
