"""Time kernel 2's 160- and 128-channel blocks at the VAE decoders' convs.

    python3 tools/sweep_conv_bn.py

On one NVIDIA card: for each ResBlock conv of the SD1.5 and SDXL VAE
decoders (``chip_smoke.VAE_CONV_SHAPES``: F = 128, 256 or 512), run the
fused GroupNorm + SiLU + conv3x3 (kernel 2) with its launch plan's block
width set to 160 and to 128, in the order 160, 128, 128, 160; check each
result against the plain version and print device ms per launch
(``chip_smoke.time_ms``). This is the measurement behind the 128-wide
instance that ``ops/_igemm.py::conv_plan`` picks where 128 divides F and
160 does not. Fails without CUDA.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    import chip_smoke
    from cassmantle_tpu_torch.ops import _igemm, fused_conv
    from cassmantle_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        chip_smoke.fail("the sweep needs an NVIDIA card")
    resolve_device("cuda")
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    g = torch.Generator("cuda").manual_seed(1)
    kw = dict(generator=g, device="cuda")
    base = _igemm.conv_plan
    shapes = {**chip_smoke.VAE_CONV_SHAPES["sd15"],
              **chip_smoke.VAE_CONV_SHAPES["sdxl"]}
    try:
        for b, h, w, c, f in shapes:
            x = torch.randn((b, h, w, c), dtype=torch.bfloat16, **kw)
            a = torch.rand((b, c), **kw) + 0.5
            shift = torch.randn((b, c), **kw) * 0.5
            kernel = (torch.randn((f, 3, 3, c), **kw) / (9 * c) ** 0.5) \
                .bfloat16().permute(1, 2, 3, 0)
            bias = torch.randn((f,), **kw) * 0.1
            args = (x, a, shift, kernel, bias)
            ref = fused_conv.gn_silu_conv3x3_plain(*args)
            times = {160: [], 128: []}
            for bn in (160, 128, 128, 160):
                fused_conv.conv_plan = (
                    lambda *p, bn=bn: base(*p)._replace(bn=bn))
                agree = chip_smoke.scaled_agreement(
                    fused_conv.gn_silu_conv3x3(*args), ref)
                if not agree["ok"]:
                    chip_smoke.fail(f"bn {bn} at {(b, h, w, c, f)} "
                                    f"disagrees: {agree['text']}")
                times[bn].append(chip_smoke.time_ms(
                    lambda: fused_conv.gn_silu_conv3x3(*args), 20))
            print(f"[sweep] gn_silu_conv3x3 {(b, h, w, c, f)}: bn 160 "
                  f"{times[160]} ms, bn 128 {times[128]} ms (both agree)",
                  flush=True)
            del x, a, shift, kernel, bias, args, ref
            torch.cuda.empty_cache()
    finally:
        fused_conv.conv_plan = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
