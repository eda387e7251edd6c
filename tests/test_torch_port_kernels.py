"""The launch policy of the port's wgmma kernels (``ops/_igemm.py``,
``ops/_flash_plan.py``), on the CPU: for every main-path shape of the
int8 matmul (kernel 3), the fused GroupNorm + SiLU + conv3x3 (kernel 2),
the int8 conv3x3 (kernel 4) and flash attention (kernel 1), on an H100
SXM (132 SMs) and an H100 PCIe (114 SMs), the plan fills the card, swaps
the operands exactly at small M, keeps clusters within the portable
limit, leaves no K slice empty and tiles F without waste where the
policy says so; kernel 4's pixel tiles, emulated with TMA's zero fill,
give the plain conv exactly; flash attention takes the wgmma kernel at
every UNet shape and the mma.sync kernel by shape and layout only."""

import numpy as np
import pytest

import chip_smoke
from cassmantle_tpu_torch.ops import _flash_plan, _igemm

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

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


# the VAE decoders' ResBlock convs (B, H, W, C, F): SD1.5 at 512² (W 64 to
# 512) and SDXL at 1024² (W 128 to 1024), and SD1.5's past W = 64 at 256²
# (the brownout tiers at half resolution)
VAE_CONV_SHAPES = sorted(set(chip_smoke.VAE_CONV_SHAPES["sd15"])
                         | set(chip_smoke.VAE_CONV_SHAPES["sdxl"])
                         | {s for s in chip_smoke.VAE_CONV_SHAPES["sd15_256"]
                            if s[2] > 64})


def _covered_pixels(plan, b, h, w):
    """Every (image, row, column) of the plan's blocks, as the kernel
    walks them (``fused_conv.cu``: blockIdx.x -> n0, y0, x0; tile row r
    -> image, row, column; pixels past the image dropped), with
    repeats."""
    sx = -(-w // plan.tw)
    gpi = 1 if plan.imgs > 1 else -(-h // plan.th) * sx
    groups = (-(-b // plan.imgs) if plan.imgs > 1
              else b * -(-h // plan.th) * sx)
    out = []
    for g in range(groups):
        n0, gi = g // gpi * plan.imgs, g % gpi
        y0, x0 = gi // sx * plan.th, gi % sx * plan.tw
        for r in range(_igemm.CONV_PIXELS):
            img, rr = divmod(r, plan.th * plan.tw)
            ry, rx = divmod(rr, plan.tw)
            if (img < plan.imgs and n0 + img < b and y0 + ry < h
                    and x0 + rx < w):
                out.append((n0 + img, y0 + ry, x0 + rx))
    return out


@pytest.mark.parametrize("b,h,w,c,f", VAE_CONV_SHAPES + [
    (1, 5, 100, 72, 40), (2, 3, 65, 16, 8), (1, 4, 130, 16, 8)])
def test_conv_plan_stretch_tiles_cover_each_pixel_once(b, h, w, c, f):
    """Past W = 64 a block takes 2 rows of a 64-column stretch (the last
    stretch ragged): every output pixel exactly once, 128 pixels and the
    264 halo positions of the W = 64 tile, and at the VAE's sizes at
    least 128 tiles, unsplit."""
    plan = _igemm.conv_plan(b, h, w, c, f, 132)
    assert plan.tw == _igemm.CONV_COLS and plan.imgs == 1
    assert plan.th * plan.tw <= _igemm.CONV_PIXELS
    assert (plan.th + 2) * (plan.tw + 2) <= _igemm.CONV_HALO
    pixels = _covered_pixels(plan, b, h, w)
    assert len(pixels) == len(set(pixels)) == b * h * w
    assert plan.tiles == (b * -(-h // plan.th) * -(-w // plan.tw)
                          * -(-f // plan.bn))
    if (b, h, w, c, f) in VAE_CONV_SHAPES:
        # F 128, 256 and 512 in whole 128-channel blocks
        assert plan.bn == 128 and f % plan.bn == 0
        assert plan.slices == 1 and plan.tiles >= 128


def _plan_before_stretches(b, h, w, c, f, sms):
    """Kernel 2's plan as it stood for W <= 64 (whole image rows)."""
    th = max(1, min(h, 64, _igemm.CONV_PIXELS // w))
    imgs = 1
    if th == h:
        imgs = max(1, min(b, _igemm.CONV_PIXELS // (h * w),
                          _igemm.CONV_HALO // ((h + 2) * (w + 2))))
    groups = -(-b // imgs) if imgs > 1 else b * -(-h // th)
    tiles = groups * -(-f // _igemm.CONV_BN)
    return th, imgs, tiles, _igemm.cluster_slices(
        tiles, -(-c // _igemm.CONV_CHUNK), sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,h,w,c,f", CONV_SHAPES + [
    (1, 7, 5, 40, 24), (3, 5, 64, 16, 8), (1, 130, 1, 8, 8),
    (4, 4, 4, 40, 24), (2, 4, 6, 64, 200)])
def test_conv_plan_unchanged_up_to_w64(b, h, w, c, f, sms):
    """Every W <= 64 shape whose F is not a multiple of 128 alone (the
    UNet's 14, the card tests' ragged ones) plans whole rows of
    160-channel blocks exactly as before the stretch tiles."""
    plan = _igemm.conv_plan(b, h, w, c, f, sms)
    assert plan.tw == w and plan.bn == _igemm.CONV_BN
    assert (plan.th, plan.imgs, plan.tiles, plan.slices) == \
        _plan_before_stretches(b, h, w, c, f, sms)
    pixels = _covered_pixels(plan, b, h, w)
    assert len(pixels) == len(set(pixels)) == b * h * w


# -- kernel 4: the int8 conv3x3 on wgmma --------------------------------------

# the card tests' ragged geometries: W 7, W 1 with H 3 (C 16 and 48), a
# row wider than a tile, F past one 160-filter tile, F odd
RAGGED_CONV = [(1, 5, 7, 32, 24), (1, 3, 1, 16, 8), (2, 3, 1, 48, 40),
               (1, 4, 130, 16, 8), (3, 5, 64, 16, 8), (2, 4, 6, 64, 200),
               (1, 5, 7, 32, 33)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,h,w,c,f", CONV_SHAPES + RAGGED_CONV)
def test_int8_conv_plan(b, h, w, c, f, sms):
    plan = _igemm.int8_conv_plan(b, h, w, c, f, sms)
    pixels = plan.imgs * plan.rows * plan.cols
    assert plan.wgs in (1, 2) and pixels <= 64 * plan.wgs
    # one 4-D box a tap: whole rows (whole images only with every row),
    # or a stretch of one row
    assert plan.cols == w or plan.rows == plan.imgs == 1
    assert plan.imgs == 1 or plan.rows == h
    assert plan.k_units == 9 * -(-c // _igemm.MATMUL_K_TILE)
    if (b, h, w, c, f) in chip_smoke.CONV_SHAPES:
        # every main-path width tiles without a partial tile
        assert (b * h * w) % pixels == 0 and pixels == 64 * plan.wgs
    groups = -(-b // plan.imgs) * -(-h // plan.rows) * -(-w // plan.cols)
    assert plan.tiles == groups * -(-f // _igemm.CONV_BN)
    assert_fills_and_splits(plan.tiles, plan.slices, plan.k_units, sms)
    assert plan.grid == (plan.tiles if plan.slices > 1
                         else min(plan.tiles, sms))


def emulate_int8_conv(x, w_ohwi, plan):
    """Kernel 4's tiling on the CPU: for each pixel tile and tap the A
    tile is the 4-D box of x at (x0 + dx - 1, y0 + dy - 1, n0), zero
    outside the image as TMA fills it; the tile's rows r < valid are the
    output rows p0 + r. Returns the int64 (B*H*W, F) sums."""
    b, h, w, c = x.shape
    out = np.zeros((b * h * w, w_ohwi.shape[0]), dtype=np.int64)
    hit = np.zeros(b * h * w, dtype=np.int64)
    for n0 in range(0, b, plan.imgs):
        for y0 in range(0, h, plan.rows):
            for x0 in range(0, w, plan.cols):
                acc = 0
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    box = np.zeros((plan.imgs, plan.rows, plan.cols, c),
                                   dtype=np.int64)
                    for i in range(plan.imgs):
                        for r in range(plan.rows):
                            for col in range(plan.cols):
                                n, y = n0 + i, y0 + dy - 1 + r
                                xx = x0 + dx - 1 + col
                                if n < b and 0 <= y < h and 0 <= xx < w:
                                    box[i, r, col] = x[n, y, xx]
                    acc = acc + box.reshape(-1, c) @ w_ohwi[:, dy, dx].T
                p0 = (n0 * h + y0) * w + x0
                valid = (min(plan.imgs, b - n0) * h * w if plan.imgs > 1
                         else min(plan.cols, w - x0) if plan.cols < w
                         else min(plan.rows, h - y0) * w)
                out[p0:p0 + valid] = acc[:valid]
                hit[p0:p0 + valid] += 1
    assert (hit == 1).all()                      # every pixel exactly once
    return out


@pytest.mark.parametrize("b,h,w", sorted({(b, h, w) for b, h, w, _, _
                                          in CONV_SHAPES + RAGGED_CONV}))
def test_int8_conv_tiles_give_the_same_border(b, h, w):
    """The plan's tiles and shifted boxes (SAME border from the zero
    fill) give the plain conv's int32 sums, every pixel stored once."""
    rng = np.random.default_rng(b * 1000 + h * 10 + w)
    c, f = 16, 8
    x = rng.integers(-127, 128, (b, h, w, c))
    w_ohwi = rng.integers(-127, 128, (f, 3, 3, c))
    plan = _igemm.int8_conv_plan(b, h, w, c, f, 132)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = sum(xp[:, dy:dy + h, dx:dx + w].reshape(-1, c)
              @ w_ohwi[:, dy, dx].T for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(emulate_int8_conv(x, w_ohwi, plan), ref)


# -- kernel 1: flash attention ------------------------------------------------

FLASH_SHAPES = sorted(chip_smoke.FLASH_SHAPES.items())


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name,shape", FLASH_SHAPES)
def test_flash_plan(name, shape, sms):
    b, sq, sk, h, d, _ = shape
    plan = _flash_plan.flash_plan(b, sq, h, d, sms)
    if d == 512:                                 # the VAE mid block
        assert plan.path == _flash_plan.MMA_SYNC
        assert (plan.bq, plan.bk) == (32, 32)
    else:                                        # every UNet shape
        assert plan.path == _flash_plan.WGMMA
        assert plan.np == d                      # 40, 64, 80, 160: no pad
        bk, stages, most = _flash_plan.INSTANCES[d]
        assert (plan.bk, plan.stages) == (bk, stages)
        assert plan.bq == 64 * plan.consumers
        blocks128 = -(-sq // 128) * h * b
        if most == 3 and -(-sq // 192) * h * b >= sms:
            assert plan.consumers == 3           # 192 rows fill the card
        else:
            assert plan.consumers == (2 if 2 * blocks128 >= sms else 1)
    # the grid covers every query row once
    assert plan.grid == (-(-sq // plan.bq), h, b)
    assert plan.grid[0] * plan.bq >= sq > (plan.grid[0] - 1) * plan.bq


@pytest.mark.parametrize("d,boxes,ksteps", [(40, 1, 3), (64, 1, 4),
                                            (80, 2, 5), (160, 3, 10)])
def test_flash_head_dim_boxes_and_ksteps(d, boxes, ksteps):
    """64-column boxes along D (zero past d) and ceil(d / 16) k-steps of
    q.k^T at the UNets' 40, 64 (SDXL: one whole box), 80 and 160; p.v's N
    is d. The C function refuses a plan whose boxes or k-steps differ
    from its instance's."""
    plan = _flash_plan.flash_plan(2, 1024, 8, d, 132)
    assert plan.path == _flash_plan.WGMMA
    assert (plan.np, plan.boxes, plan.ksteps) == (d, boxes, ksteps)
    assert d <= 64 * plan.boxes < d + 64


@pytest.mark.parametrize("d", [8, 24, 32, 48, 96, 72, 128, 256])
def test_flash_other_head_dims_take_mma_sync(d):
    """Head dims off the UNets' have no wgmma instance: the mma.sync
    kernel takes them, padded to its smallest instance that holds d."""
    plan = _flash_plan.flash_plan(2, 1024, 8, d, 132)
    assert plan.path == _flash_plan.MMA_SYNC
    assert plan.np == min(n for n in _flash_plan.MMA_SYNC_INSTANCES
                          if n >= d)
    assert (plan.bq, plan.bk) == _flash_plan.MMA_SYNC_INSTANCES[plan.np]
    assert plan.grid == (-(-1024 // plan.bq), 8, 2)


def test_flash_instances_fit():
    for np_, (bk, stages, most) in _flash_plan.INSTANCES.items():
        plan = _flash_plan.flash_plan(1, 4096, 1, np_, 132)
        assert (plan.np, plan.bk, plan.stages) == (np_, bk, stages)
        assert 1 <= plan.consumers <= most <= 3


@pytest.mark.parametrize("sq,h,want", [(4096, 8, 3), (1024, 8, 2),
                                       (256, 8, 1), (300, 2, 1)])
def test_flash_consumers_per_block(sq, h, want):
    """D = 40 takes three consumer warpgroups where 192-row blocks fill
    the card, else two where 128-row blocks cover half of it, else one."""
    plan = _flash_plan.flash_plan(2, sq, h, 40, 132)
    assert plan.consumers == want and plan.bq == 64 * want


@pytest.mark.parametrize("d,tma_ok,scale,path", [
    (512, True, 0.04, "mma.sync"),     # the wide head
    (264, True, 0.06, "mma.sync"),     # padded to mma.sync's 512
    (20, True, 0.2, "mma.sync"),       # d % 8 != 0
    (44, True, 0.15, "mma.sync"),
    (40, False, 0.16, "mma.sync"),     # a stride or base TMA cannot take
    (40, True, -0.16, "mma.sync"),     # a negative scale
    (40, True, 0.16, "wgmma"),
    (8, True, 0.35, "mma.sync"),       # off the UNet's head dims
    (256, True, 0.06, "mma.sync"),
    (80, True, 0.11, "wgmma"),
    (160, True, 0.08, "wgmma"),
    (64, True, 0.125, "wgmma"),        # SDXL's head dim
    (64, False, 0.125, "mma.sync"),
    (64, True, -0.125, "mma.sync"),
])
def test_flash_path_choice(d, tma_ok, scale, path):
    plan = _flash_plan.flash_plan(1, 300, 2, d, 132, tma_ok, scale)
    assert plan.path == path
    if path == "mma.sync":
        assert plan.np >= d and plan.consumers == 0


@pytest.mark.parametrize("shape,strides,ptr,ok", [
    ((2, 4096, 8, 40), (4096 * 960, 960, 40, 1), 0, True),   # fused qkv
    ((2, 77, 8, 40), (77 * 640, 640, 40, 1), 640, True),     # fused kv
    ((1, 100, 3, 20), (6000, 60, 20, 1), 0, False),          # 40-byte rows
    ((2, 64, 8, 40), (64 * 320, 320, 40, 1), 8, False),      # base % 16
    ((1, 64, 1, 40), (7, 40, 3, 1), 0, True),                # size-1 dims
    ((2, 64, 8, 40), (64 * 320, 320, 40, 2), 0, False),      # D not unit
])
def test_flash_tma_layout(shape, strides, ptr, ok):
    """Byte strides must be multiples of 16 where a dimension has more
    than one index; the base 16-byte aligned."""
    assert _flash_plan.tma_layout_ok(shape, strides, ptr) == ok


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name,blocks", [("self_x1", 440), ("cross_x1", 440),
                                         ("self_x2", 240), ("cross_x2", 240)])
def test_flash_d64_sdxl_grids(name, blocks, sms):
    """SDXL's four UNet shapes (head dim 64) on the wgmma kernel with three
    consumer warpgroups (192 query rows a block): ceil(4096 / 192) x 10
    heads x 2 = 440 blocks at 64x64 latents and ceil(1024 / 192) x 20 x 2
    = 240 at 32x32; both fill the card."""
    b, sq, _, h, d, _ = chip_smoke.FLASH_SHAPES[name]
    plan = _flash_plan.flash_plan(b, sq, h, d, sms)
    assert (plan.path, plan.np, plan.consumers, plan.bq) == (
        _flash_plan.WGMMA, 64, 3, 192)
    assert (plan.boxes, plan.ksteps) == (1, 4)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == blocks >= sms


@pytest.mark.parametrize("shape,strides", [
    ((2, 4096, 10, 64), (4096 * 640 + 4, 640, 64, 1)),    # batch stride
    ((1, 300, 2, 64), (300 * 130, 130, 65, 1)),           # 130-byte rows
])
def test_flash_d64_takes_mma_sync_where_tma_cannot(shape, strides):
    """A D = 64 operand that TMA cannot describe goes to the mma.sync
    kernel at its own D = 64 instance (no padding to 80), by layout."""
    assert not _flash_plan.tma_layout_ok(shape, strides, 0)
    b, sq, h, d = shape
    plan = _flash_plan.flash_plan(b, sq, h, d, 132, tma_ok=False)
    assert (plan.path, plan.np) == (_flash_plan.MMA_SYNC, 64)
    assert (plan.bq, plan.bk) == _flash_plan.MMA_SYNC_INSTANCES[64]
    assert plan.grid == (-(-sq // plan.bq), h, b)


def test_flash_round_counts_follow_the_models():
    """chip_smoke's per-model flash counts: SD1.5 launches 1,601 a round
    (wgmma 1,600, mma.sync 1), SDXL 7,001 (wgmma 7,000, mma.sync 1), the
    encoder-propagation round 911 (20 x 32 + 15 x 18 + 1), DeepCache's
    1,051 (25 x 32 + 25 x 10 + 1), DPM++'s 801 (25 x 32 + 1), turbo's 505
    (12 x 32 + 12 x 10 + 1), lcm's 129 (4 x 32 + 1) and img2img's 962 (30
    x 32 and both VAE mid blocks), each shape of a round on the path the
    plan gives it at 132 SMs."""
    for model, want in (("sd15", 1601), ("sdxl", 7001), ("encprop", 911),
                        ("deepcache", 1051), ("fast", 801), ("turbo", 505),
                        ("lcm", 129), ("img2img", 962)):
        counts = chip_smoke.ROUND_FLASH[model]
        assert sum(counts.values()) == want
        paths = {}
        for name, n in counts.items():
            b, sq, _, h, d, _ = chip_smoke.FLASH_SHAPES[name]
            path = _flash_plan.flash_plan(b, sq, h, d, 132).path
            paths[path] = paths.get(path, 0) + n
        assert paths == chip_smoke.ROUND_FLASH_PATHS[model]
    assert set(chip_smoke.FLASH_SHAPES) == set().union(
        *map(set, chip_smoke.ROUND_FLASH.values()))


def test_tier_flash_counts_follow_the_tiers():
    """chip_smoke's [brownout] cells against the ladder: each cell's image
    size and steps are what ``degraded_sampler_cfg`` gives its preset at
    its tier; its flash round (961 at DDIM-30, 129 at the four consistency
    steps, 411 for encprop at stride 5, 4,201 at SDXL) on the paths the
    plan gives each shape at 132 SMs (the VAE mid block on mma.sync)."""
    import dataclasses

    from cassmantle_tpu_torch import config as pconfig
    from cassmantle_tpu_torch.serving import overload

    presets = {"default": pconfig.FrameworkConfig(),
               "consistency": chip_smoke.consistency_student_config(),
               "fusedconv": pconfig.fusedconv_serving_config(),
               "w8a8": pconfig.w8a8_serving_config(),
               "encprop": pconfig.encprop_serving_config(),
               "sdxl": pconfig.sdxl_config(), "game": pconfig.FrameworkConfig()}
    totals = {"default@t1": 961, "default@t4": 961, "consistency@t3": 129,
              "encprop@t2": 411, "encprop@t4": 411, "sdxl@t1": 4201,
              "sdxl@t4": 4201,
              "fusedconv@t4": 961, "w8a8@t4": 961, "game@t5": 961}
    for cell, (size, mode, replays) in chip_smoke.TIER_CELLS.items():
        preset, tier = cell.split("@t")
        s = overload.degraded_sampler_cfg(
            presets[preset].sampler, overload.DEFAULT_TIERS[int(tier)])
        assert s.image_size == size
        assert s.num_steps == sum(replays.values()) or mode == "encprop"
        assert s.consistency == (mode == "consistency")
        counts = chip_smoke.ROUND_FLASH[chip_smoke.PRESET_MODEL[cell]]
        assert sum(counts.values()) == totals[cell]
        paths = {}
        for name, n in counts.items():
            b, sq, _, h, d, _ = chip_smoke.FLASH_SHAPES[name]
            path = _flash_plan.flash_plan(b, sq, h, d, 132).path
            paths[path] = paths.get(path, 0) + n
        assert paths == {"wgmma": totals[cell] - 1, "mma.sync": 1}
    assert dataclasses.asdict(overload.DEFAULT_TIERS[5])["blur_bucket_px"] \
        == 2.0


def test_every_tier_of_every_preset_runs_checked_shapes():
    """chip_smoke's first check: every served preset, at full quality and
    at each tier of ``DEFAULT_TIERS`` (its round derived from the config
    through ``degraded_sampler_cfg``), launches each kernel only at
    shapes phase 2 holds against the plain version. The encprop preset's
    tiers 4 and 5 bring flash at batch 8 at 256x256 and the fused VAE
    decoder at 256x256 (img2img's decoder too)."""
    assert chip_smoke.tier_shape_gaps() == []


def test_round_tables_follow_the_configs():
    """chip_smoke's per-round tables (``expected_tallies`` of each preset,
    ROUND_FLASH and TIER_KERNELS of each [brownout] cell) equal the
    derivation from the configs: flash launches per shape, the other
    kernels' shapes."""
    assert chip_smoke.round_table_mismatches() == []
