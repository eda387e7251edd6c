"""Time candidate instances of the wgmma flash kernel at head dim 64.

    python3 tools/sweep_flash_d64.py

On one NVIDIA card: builds ``csrc/flash_attention.cu`` with extra D = 64
instantiations of ``fa3::flash_wgmma_kernel`` (keys a tile, K/V ring
stages, consumer warpgroups) into the git-ignored
``cassmantle_tpu_torch/_build/sweep/``, prints each instance's ptxas
report (registers, spills, a serialised wgmma) and its HGMMA count, then
runs every instance that neither spills nor serialises at SDXL's four
UNet attention shapes (and two ragged ones) with the launch plan's tile,
stages and consumers replaced: each result is held against the plain
version under ``chip_smoke.py``'s limits, and timed in device ms per
launch (``chip_smoke.time_ms``) beside the mma.sync kernel (padded to 80
and at its own 64) and one SDPA call. This is the measurement behind
``ops/_flash_plan.py::INSTANCES[64]``. Fails without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (keys a tile, ring stages, consumer warpgroups)
CANDIDATES = ((128, 2, 2), (128, 3, 2), (128, 4, 2), (128, 2, 3),
              (128, 3, 3), (64, 3, 2), (64, 4, 3), (64, 3, 3))
TIMED = ("self_x1", "cross_x1", "self_x2", "cross_x2")
RAGGED = ((1, 4095, 129, 2, "separate"), (2, 100, 77, 3, "separate"))
ANCHOR = "  CASSMANTLE_FLASH_WGMMA(160, 64, 3, 2)\n"


def build_variant():
    """The flash source with every candidate instantiated: its library
    and ptxas report."""
    from cassmantle_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    extra = "".join(f"  CASSMANTLE_FLASH_WGMMA(64, {bk}, {st}, {mc})\n"
                    for bk, st, mc in CANDIDATES)
    if ANCHOR not in src:
        raise RuntimeError("instantiation anchor not found in the source")
    with open(os.path.join(out_dir, "flash_attention.cu"), "w") as f:
        f.write(src.replace(ANCHOR, ANCHOR + extra))
    shutil.copy(os.path.join(_build.CSRC_DIR, "hopper.cuh"), out_dir)
    lib = os.path.join(out_dir, "libflash_sweep.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(out_dir, "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def instance_reports(log: str, lib: str) -> dict:
    """{(np, bk, st, mc): (ptxas text, clean)} of the wgmma instances, and
    their HGMMA counts where cuobjdump is found."""
    reports, kernel, spill = {}, None, ""
    serialised = set()
    for line in log.splitlines():
        m = re.search(r"wgmma\.mma_async instructions are serialized.*"
                      r"function '([^']+)'", line)
        if m:
            serialised.add(m.group(1))
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel, spill = m.group(1), ""
        elif kernel and "spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line:
            m = re.search(r"flash_wgmma_kernelI" + r"Li(\d+)E" * 4, kernel)
            if m:
                key = tuple(int(g) for g in m.groups())
                clean = spill.startswith("0 bytes stack frame, 0 bytes spill "
                                         "stores, 0 bytes spill loads")
                reports[key] = [kernel, f"{line.split(':', 1)[1].strip()}; "
                                f"{spill}", clean]
            kernel = None
    for key, rep in reports.items():
        if rep[0] in serialised:
            rep[1] += "; wgmma SERIALISED"
            rep[2] = False
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, timeout=300).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                counts[current] = 0
            elif current and re.search(r"\bHGMMA\.", line):
                counts[current] += 1
        for rep in reports.values():
            rep[1] += f"; {counts.get(rep[0], 0)} HGMMA"
    return {k: (v[1], v[2]) for k, v in reports.items()}


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from cassmantle_tpu_torch.ops import _flash_plan
    from cassmantle_tpu_torch.ops import flash_attention as fa_mod
    from cassmantle_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        chip_smoke.fail("the sweep needs an NVIDIA card")
    resolve_device("cuda")
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    lib_path, log = build_variant()
    reports = instance_reports(log, lib_path)
    for key, (text, clean) in sorted(reports.items()):
        print(f"[ptxas] flash_wgmma_kernel<{', '.join(map(str, key))}>: "
              f"{text}", flush=True)
    lib = ctypes.CDLL(lib_path)
    library = {}
    for path, name in ((_flash_plan.WGMMA,
                        "cassmantle_flash_attention_wgmma"),
                       (_flash_plan.MMA_SYNC,
                        "cassmantle_flash_attention_bf16")):
        fn, ref = getattr(lib, name), fa_mod._library(path)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        library[path] = fn
    fa_mod._library = library.__getitem__
    base_plan = fa_mod.flash_plan

    def planned(variant):
        def plan(b, sq, h, d, sms, tma_ok=True, scale=1.0):
            if variant[0] == "mma.sync":
                np_ = variant[1]
                bq, bk = _flash_plan.MMA_SYNC_INSTANCES.get(np_, (64, 64))
                return _flash_plan.FlashPlan(
                    _flash_plan.MMA_SYNC, np_, bq, bk, 0, 0, 0, 0,
                    (-(-sq // bq), h, b))
            bk, st, nc = variant
            return _flash_plan.FlashPlan(
                _flash_plan.WGMMA, d, 64 * nc, bk, st, nc, 1, 4,
                (-(-sq // (64 * nc)), h, b))
        return plan

    variants = [("mma.sync", 80), ("mma.sync", 64)] + [
        (bk, st, mc) for bk, st, mc in CANDIDATES
        if reports.get((64, bk, st, mc), ("", False))[1]]
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = [(name, chip_smoke.FLASH_SHAPES[name]) for name in TIMED] + [
        (f"ragged_{sq}x{sk}", (b, sq, sk, h, 64, layout))
        for b, sq, sk, h, layout in RAGGED]
    failed = []
    for name, (b, sq, sk, h, d, layout) in shapes:
        q, k, v = chip_smoke.flash_inputs(b, sq, sk, h, d, layout, gen)
        ref = fa_mod.flash_attention_plain(q, k, v)
        timed = name in TIMED
        line = [f"[sweep] flash {name} {(b, sq, sk, h, d)}:"]
        if timed:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = chip_smoke.time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            bound_ms = chip_smoke.flash_bound(b, sq, sk, h, d)[0]
            line.append(f"bound {bound_ms * 1e3:.2f} us, sdpa {sdpa:.4f} ms;")
        for variant in variants:
            fa_mod.flash_plan = planned(variant)
            out = fa_mod.flash_attention(q, k, v)
            torch.cuda.synchronize()
            agree = chip_smoke.flash_agreement(out, ref)
            tag = ("mma.sync/" + str(variant[1]) if variant[0] == "mma.sync"
                   else "bk{} st{} nc{}".format(*variant))
            ms = (chip_smoke.time_ms(lambda: fa_mod.flash_attention(q, k, v),
                                     20) if timed else None)
            ok = agree["ok"] and bool(torch.isfinite(out).all())
            if not ok:
                failed.append((name, tag))
            line.append(f"{tag} " + (f"{ms:.4f} ms " if ms else "")
                        + f"({agree['max_share']:.2f}/"
                        f"{agree['rms_share']:.2f} of the limits, "
                        f"{'pass' if ok else 'FAIL'});")
        fa_mod.flash_plan = base_plan
        print(" ".join(line), flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    if failed:
        chip_smoke.fail(f"instances disagree with the plain version: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
