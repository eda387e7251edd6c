"""Time the port's wgmma kernels at every cluster size of their split K.

    python3 tools/sweep_clusters.py

On one NVIDIA card: for main-path shapes of the int8 matmul (kernel 3)
and the fused GroupNorm + SiLU + conv3x3 (kernel 2), run the kernel with
its launch plan's cluster slices replaced by 1, 2, 4 and 8 (where the K
depth allows), check each result against the plain version, and print
device ms per launch (``chip_smoke.time_ms``). This is the measurement
behind ``ops/_igemm.py::cluster_slices``. Fails without CUDA.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MATMULS = ((512, 1280, 1280), (512, 5120, 1280), (2048, 640, 640),
           (128, 5120, 1280), (1, 3072, 768))
CONVS = ((2, 16, 16, 640, 1280), (2, 16, 16, 1280, 1280),
         (2, 32, 32, 640, 640), (2, 8, 8, 2560, 1280))


def main() -> int:
    import torch

    import chip_smoke
    from cassmantle_tpu_torch.ops import _igemm, fused_conv, quant_matmul
    from cassmantle_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        chip_smoke.fail("the sweep needs an NVIDIA card")
    resolve_device("cuda")
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    g = torch.Generator("cuda").manual_seed(0)
    kw = dict(generator=g, device="cuda")
    base_mm, base_conv = _igemm.matmul_plan, _igemm.conv_plan
    for m, k, n in MATMULS:
        x = torch.randint(-127, 128, (m, k), dtype=torch.int8, **kw)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw).t()
        row = torch.rand((1,), **kw) * 0.01
        col = torch.rand((n,), **kw) * 1e-3
        bias = torch.randn((n,), **kw)
        args = (x, w, row, col, bias, torch.bfloat16)
        ref = quant_matmul.int8_matmul_plain(*args)
        k_tiles = -(-k // _igemm.MATMUL_K_TILE)
        for s in (1, 2, 4, 8):
            if s > k_tiles:
                continue
            quant_matmul.matmul_plan = (
                lambda *a, s=s: (lambda p: p._replace(
                    slices=s, grid=p.tiles if s > 1 else min(p.tiles, a[3])))(
                    base_mm(*a)))
            ok = torch.equal(quant_matmul.int8_matmul(*args), ref)
            ms = chip_smoke.time_ms(lambda: quant_matmul.int8_matmul(*args),
                                    20)
            print(f"[sweep] int8_matmul {(m, k, n)} slices {s}: {ms:.4f} ms"
                  f" ({'equal' if ok else 'DIFFERS'})", flush=True)
    for b, h, w_, c, f in CONVS:
        x = torch.randn((b, h, w_, c), dtype=torch.bfloat16, **kw)
        a = torch.rand((b, c), **kw) + 0.5
        shift = torch.randn((b, c), **kw) * 0.5
        kernel = (torch.randn((f, 3, 3, c), **kw) / (9 * c) ** 0.5) \
            .bfloat16().permute(1, 2, 3, 0)
        bias = torch.randn((f,), **kw) * 0.1
        args = (x, a, shift, kernel, bias)
        ref = fused_conv.gn_silu_conv3x3_plain(*args)
        for s in (1, 2, 4, 8):
            if s > -(-c // _igemm.CONV_CHUNK):
                continue
            fused_conv.conv_plan = (
                lambda *p, s=s: base_conv(*p)._replace(slices=s))
            agree = chip_smoke.scaled_agreement(
                fused_conv.gn_silu_conv3x3(*args), ref)
            ms = chip_smoke.time_ms(lambda: fused_conv.gn_silu_conv3x3(*args),
                                    20)
            print(f"[sweep] gn_silu_conv3x3 {(b, h, w_, c, f)} slices {s}: "
                  f"{ms:.4f} ms ({'agrees' if agree['ok'] else 'DIFFERS'})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
