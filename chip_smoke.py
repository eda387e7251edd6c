"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``cassmantle_tpu_torch`` only (nothing of JAX or ``cassmantle_tpu``):

0. prints the card's name and power limit; fails without CUDA;
1. builds every kernel of ``cassmantle_tpu_torch/csrc/`` with ``nvcc``
   into the git-ignored ``cassmantle_tpu_torch/_build/``;
2. holds each kernel against its plain PyTorch version at every shape the
   main path gives it, and times the kernel, the plain version and one
   PyTorch library call of the same function (a yardstick the port never
   calls) beside the card's bound for the work;
3. runs the tiny test geometry on the card and on the CPU from the same
   weights and inputs, and checks that image, prompt tokens, scores and
   blur agree;
4. serves one game round at the full default width (SD1.5 512x512,
   50-step CFG DDIM, GPT-2-small prompt text, MiniLM scoring, blur) with
   seeded random weights, and checks that every kernel launch of the
   round came from that run;
5. profiles two denoise steps of that pipeline: host time per step, the
   device's busy time and idle share, and the flash kernel's part.

Prints one ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Every flash-attention shape of one SD1.5-512 round with CFG (batch 2 x 8
# heads in the UNet; the VAE mid block is one head at D = 512):
# name -> (B, Sq, Sk, H, D, layout). "self" reads q, k, v as views of one
# fused qkv projection, "cross" reads q from its own projection and k, v
# from a fused kv projection of the 77-token CLIP context, as the models do.
FLASH_SHAPES = {
    "self_l0": (2, 4096, 4096, 8, 40, "self"),
    "cross_l0": (2, 4096, 77, 8, 40, "cross"),
    "self_l1": (2, 1024, 1024, 8, 80, "self"),
    "cross_l1": (2, 1024, 77, 8, 80, "cross"),
    "self_l2": (2, 256, 256, 8, 160, "self"),
    "cross_l2": (2, 256, 77, 8, 160, "cross"),
    "self_mid": (2, 64, 64, 8, 160, "self"),
    "cross_mid": (2, 64, 77, 8, 160, "cross"),
    "vae_mid": (1, 4096, 4096, 1, 512, "separate"),
}
# 50 steps x 16 transformer blocks x (self + cross) + the VAE mid block.
ROUND_FLASH_LAUNCHES = 50 * 32 + 1
# Kernel vs plain, bf16 unit-normal inputs. Both sides round the output
# to bf16 (one ulp of the largest output is 2^-8 to 2^-7 of it), and the
# kernel rounds p to bf16 against its running max where the plain version
# uses the row max, summing in another order. The limits scale with the
# reference, since the output's spread shrinks as sqrt(e / Sk):
#   max |kernel - plain| <= 2^-6 * max |plain|   (2 to 4 ulps of it);
#   ||kernel - plain||_2 <= 1e-2 * ||plain||_2   (each rounding adds ~1e-3).
# A kernel that dropped one 64-key tile of 4096 would miss the second by
# ~10x and the first by ~3x.
FLASH_MAX_REL = 2.0 ** -6
FLASH_RMS_REL = 1e-2

FLASH_REPLACES = "cassmantle_tpu/ops/flash_attention.py:131"
FLASH_SOURCE = "cassmantle_tpu_torch/csrc/flash_attention.cu"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, replays: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    cost (Python, ctypes) does not hide in the time of a short kernel.
    Inputs stay warm in L2, as they are when the projection that made
    them has just run."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def flash_inputs(b, sq, sk, h, d, layout, gen):
    """bf16 unit-normal q, k, v (B, S, H, D) with the strides the models
    hand the kernel."""
    import torch

    kw = dict(generator=gen, device="cuda", dtype=torch.bfloat16)
    inner = h * d
    if layout == "self":
        qkv = torch.randn((b, sq, 3 * inner), **kw)
        q, k, v = qkv.split(inner, dim=-1)
    elif layout == "cross":
        q = torch.randn((b, sq, inner), **kw)
        k, v = torch.randn((b, sk, 2 * inner), **kw).split(inner, dim=-1)
    else:
        q, k, v = (torch.randn((b, s, inner), **kw) for s in (sq, sk, sk))
    return tuple(t.unflatten(-1, (h, d)) for t in (q, k, v))


def flash_agreement(out, ref) -> dict:
    """The kernel's output against the plain version's, each error as a
    share of its limit (``ok`` when both shares are at most 1)."""
    diff = out.float() - ref.float()
    ref32 = ref.float()
    max_abs = diff.abs().max().item()
    limit = FLASH_MAX_REL * ref32.abs().max().item()
    rel_rms = (diff.norm() / ref32.norm()).item()
    return dict(max_abs_err=max_abs, max_limit=limit, rel_rms_err=rel_rms,
                max_share=max_abs / limit, rms_share=rel_rms / FLASH_RMS_REL,
                ok=max_abs <= limit and rel_rms <= FLASH_RMS_REL)


def flash_bound(b, sq, sk, h, d):
    """(bound ms, 'bytes' or 'operations', flops, bytes): 4*B*H*Sq*Sk*D
    FLOPs at the bf16 peak; q, k, v, o read or written once."""
    flops = 4 * b * h * sq * sk * d
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def check_flash_kernel():
    """Kernel vs plain at every main-path shape; returns per-shape rows."""
    import torch
    import torch.nn.functional as F

    from cassmantle_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    rows = {}
    gen = torch.Generator("cuda").manual_seed(0)
    for name, (b, sq, sk, h, d, layout) in FLASH_SHAPES.items():
        q, k, v = flash_inputs(b, sq, sk, h, d, layout, gen)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        agree = flash_agreement(out, ref)
        finite = bool(torch.isfinite(out).all())
        ms = time_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), 2)
        # the library yardstick: one SDPA call on (B, H, S, D) copies
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        bound_ms, bound_by, flops, nbytes = flash_bound(b, sq, sk, h, d)
        rows[name] = dict(
            shape=[b, sq, sk, h, d], max_abs_err=agree["max_abs_err"],
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
            mbytes=nbytes / 1e6, ok=finite and agree["ok"])
        print(f"[kernel] flash_attention {name} (B, Sq, Sk, H, D)="
              f"{(b, sq, sk, h, d)}: max_abs_err "
              f"{agree['max_abs_err']:.3e} (limit {agree['max_limit']:.3e}, "
              f"{agree['max_share']:.2f} of it), rel_rms_err "
              f"{agree['rel_rms_err']:.3e} ({agree['rms_share']:.2f} of "
              f"{FLASH_RMS_REL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) -> "
              f"{'pass' if rows[name]['ok'] else 'FAIL'}", flush=True)
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def tiny_bf16_config():
    """The CPU tests' geometry with the serving dtype policy (bf16 UNet
    and VAE compute, bf16 parameter storage), so the kernel runs."""
    import dataclasses

    from cassmantle_tpu_torch.config import test_config

    cfg = test_config()
    m = cfg.models
    models = dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, dtype="bfloat16"),
        vae=dataclasses.replace(m.vae, dtype="bfloat16"),
        param_dtype="bfloat16")
    return cfg.replace(models=models)


def check_small_agreement():
    """The tiny geometry on the card against the CPU, same weights and
    inputs. The CPU runs the plain attention, the card the kernel.

    The image is held to bf16's own noise. Two bf16 runs do not agree
    with each other to the CPU tests' 2 levels: their roundings (the
    kernel's p against its running max, other GEMM and conv sum orders)
    differ, and 4 denoise steps carry the difference on. So both bf16
    images are compared with an fp32 CPU run of the same weights (the path
    the CPU tests hold against the reference), and the card may stray from
    it no further than the CPU's own bf16 run does, plus 0.5 of a level on
    the mean and 2 levels at the max."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.serving.service import InferenceService

    cfg = tiny_bf16_config()
    cpu = InferenceService(cfg, device="cpu")
    b = cpu.backend
    sd = {"clip_text": b.t2i.clip.state_dict(),
          "unet": b.t2i.unet.state_dict(), "vae": b.t2i.vae.state_dict(),
          "gpt2": b.prompt_gen.model.state_dict(),
          "minilm": cpu.scorer.model.state_dict()}
    gpu = InferenceService(cfg, device="cuda", state_dicts=sd)
    fp32 = Text2ImagePipeline(test_config(), device="cpu", state_dicts=sd)
    prompts = ["A watercolor style piece depicting: a lighthouse at dusk.",
               "A vaporwave style piece depicting: the comet market."]
    hw = cfg.sampler.image_size // cpu.backend.t2i.vae_scale
    x_t = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (len(prompts), hw, hw, 4)).astype(np.float32))
    ref = fp32.generate(prompts, latents=x_t).astype(np.int32)
    img_c = cpu.backend.t2i.generate(prompts, latents=x_t)
    img_g = gpu.backend.t2i.generate(prompts, latents=x_t)
    d_cpu = np.abs(img_c.astype(np.int32) - ref)
    d_gpu = np.abs(img_g.astype(np.int32) - ref)
    seeds = ["The Night the Trains Sang", "Chapter two: the harbor"]
    tok_c, len_c = cpu.backend.prompt_gen.decode_ids_batch(seeds)
    tok_g, len_g = gpu.backend.prompt_gen.decode_ids_batch(seeds)
    pairs = [("lighthouse", "lighthouse"), ("crimson", "amber"),
             ("comet", "archive"), ("a quiet harbor", "harbor"),
             ("orchard", "an orchard at dusk"), ("teal", "silver"),
             ("Caravan", "caravan"), ("glacier", "canyon")]
    sim_err = float(np.abs(cpu.similarity(pairs)
                           - gpu.similarity(pairs)).max())
    blur_err = max(int(np.abs(cpu.blur(img_c[0], r).astype(np.int32)
                              - gpu.blur(img_c[0], r).astype(np.int32)).max())
                   for r in (0.0, 5.0, 15.0))
    res = dict(
        card_vs_fp32_max=int(d_gpu.max()),
        card_vs_fp32_mean=float(d_gpu.mean()),
        cpu_bf16_vs_fp32_max=int(d_cpu.max()),
        cpu_bf16_vs_fp32_mean=float(d_cpu.mean()),
        card_vs_cpu_bf16_mean=float(np.abs(img_g.astype(np.int32)
                                           - img_c.astype(np.int32)).mean()),
        tokens_equal=bool(np.array_equal(tok_c, tok_g)
                          and np.array_equal(len_c, len_g)),
        sim_max_err=sim_err, blur_max_err=blur_err)
    # fp32 GPT-2 and MiniLM (TF32 off): the same greedy tokens and scores
    # within 1e-4 (summation order); the blur within 1 level (rounding).
    ok = (d_gpu.mean() <= d_cpu.mean() + 0.5
          and d_gpu.max() <= d_cpu.max() + 2
          and res["tokens_equal"] and sim_err <= 1e-4 and blur_err <= 1)
    print(f"[small] tiny geometry, card vs CPU: {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


def run_round(card: str):
    """One full-width round through InferenceService; returns the flash
    launch tally of the main path and the stage report."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.ops.flash_attention import (
        flash_attention,
        reset_counters,
    )
    from cassmantle_tpu_torch.serving.service import InferenceService

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    svc = InferenceService(cfg)                     # device="cuda"
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pairs = [("lighthouse", "lighthouse"), ("crimson", "amber"),
             ("comet", "archive"), ("a quiet harbor", "harbor"),
             ("orchard", "an orchard at dusk"), ("teal", "silver"),
             ("Caravan", "caravan"), ("glacier", "canyon"),
             ("observatory", "station"), ("violet", "violet tune")]

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    rc = svc.generate_content("The Night the Trains Sang")
    round_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sims = svc.similarity(pairs)
    score_s = time.perf_counter() - t1
    blurred = {}
    t1 = time.perf_counter()
    for r in (0.0, 5.0, 15.0):
        blurred[r] = svc.blur(rc.image, r)
    blur_s = time.perf_counter() - t1
    launches = flash_attention.launches
    shapes = dict(flash_attention.shapes)

    t2i, gen = svc.backend.t2i, svc.backend.prompt_gen
    stages = {"decode": gen.last_seconds, **t2i.last_stage_seconds,
              "score": score_s, "blur": blur_s}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # a second round, warm, for the steady-state time
    t0 = time.perf_counter()
    rc2 = svc.generate_content("Chapter two: the harbor")
    warm_round_s = time.perf_counter() - t0
    warm_stages = {"decode": gen.last_seconds, **t2i.last_stage_seconds}

    img = rc.image
    checks = {
        "image_shape": img.shape == (cfg.sampler.image_size,) * 2 + (3,),
        "image_uint8": img.dtype == np.uint8,
        "decoded_finite": bool(t2i.last_decoded_finite),
        "image_not_constant": int(img.max()) > int(img.min()),
        "second_image_ok": rc2.image.shape == img.shape,
        "flash_launches": launches == ROUND_FLASH_LAUNCHES,
        "scores_finite": bool(np.all(np.isfinite(sims))),
        "scores_in_range": bool(np.all(np.abs(sims) <= 1.0 + 1e-5)),
        "blur_shapes": all(b.shape == img.shape and b.dtype == np.uint8
                           for b in blurred.values()),
        "blur_zero_is_identity": bool(np.array_equal(blurred[0.0], img)),
        "blur_smooths": (np.abs(np.diff(blurred[15.0].astype(np.int32),
                                        axis=1)).mean()
                         < np.abs(np.diff(img.astype(np.int32),
                                          axis=1)).mean()),
        "prompt_text": bool(rc.prompt_text.strip()),
    }
    checks = {k: bool(v) for k, v in checks.items()}
    report = dict(
        card=card, build_models_s=build_s, round_s=round_s,
        warm_round_s=warm_round_s, stages_s=stages,
        warm_stages_s=warm_stages, peak_gib=peak_gib,
        flash_launches=launches, text_fallbacks=svc.backend.text_fallbacks,
        prompt_text=rc.prompt_text, scores=[float(s) for s in sims],
        image_mean=float(img.mean()), image_std=float(img.std()),
        checks=checks)
    print(f"[round] {json.dumps(report)}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    return svc, shapes, bad


def profile_denoise(svc, steps: int = 2) -> dict:
    """Where a denoise step's time goes, at full width: the host seconds
    of ``steps`` CFG UNet steps (no profiler attached), then the same
    steps under ``torch.profiler`` for the device's busy time (the sum of
    its kernel and copy times: one stream, so they never overlap), the
    idle share, and the flash kernel's part of the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from cassmantle_tpu_torch.ops.ddim import make_cfg_denoiser
    from cassmantle_tpu_torch.ops.flash_attention import (
        flash_attention,
        reset_counters,
    )

    t2i = svc.backend.t2i
    s = t2i.cfg.sampler
    hw = s.image_size // t2i.vae_scale
    timesteps = [int(t) for t in t2i.schedule.timesteps[:steps]]
    with torch.inference_mode():
        ctx = t2i.clip(t2i._tokenize(["a lighthouse at dusk"]))["hidden"]
        uncond = t2i.clip(t2i._tokenize([s.negative_prompt]))["hidden"]
        denoise = make_cfg_denoiser(t2i.unet, ctx, uncond, s.guidance_scale)
        gen = torch.Generator("cuda").manual_seed(3)
        x = torch.randn((1, hw, hw, 4), generator=gen, device="cuda")

        def run():
            for t in timesteps:
                denoise(x, t)
            torch.cuda.synchronize()

        run()                                        # warm
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        # the work of one step: aten's count, plus 4*B*H*Sq*Sk*D for each
        # flash launch (the counter cannot see inside the kernel)
        reset_counters()
        with FlopCounterMode(display=False) as counter:
            denoise(x, timesteps[0])
        attn_flops = sum(n * 4 * b * h * sq * sk * d for (b, sq, sk, h, d), n
                         in flash_attention.shapes.items())
        step_flops = counter.get_total_flops() + attn_flops
    bound_ms = step_flops / PEAK_BF16_FLOPS * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    flash_us = sum(e.time_range.elapsed_us() for e in device
                   if "flash_fwd_kernel" in e.name)
    report = {"step_wall_ms": wall_ms, "step_tflop": step_flops / 1e12,
              "step_bound_ms": bound_ms,
              "bound_share_of_wall": bound_ms / wall_ms}
    if not device:
        return {**report, "device_busy_ms": "not measured"}
    busy_ms = busy_us / 1e3 / steps
    return {**report, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "bound_share_of_busy": bound_ms / busy_ms,
            "kernels_per_step": len(device) / steps,
            "flash_ms": flash_us / 1e3 / steps,
            "flash_share_of_busy": flash_us / max(busy_us, 1e-9)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run "
             "needs an NVIDIA card")
    card = card_line()
    print(f"[card] {card}", flush=True)

    from cassmantle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(libs)} in {build_s:.1f} s", flush=True)
    for src, path in libs.items():
        log = path[:-3] + ".log"
        try:
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print(f"[ptxas] {src}: {line.strip()}")
        except OSError:
            pass                      # built before: the report is gone

    rows = check_flash_kernel()
    if not all(r["ok"] for r in rows.values()):
        fail("flash kernel disagrees with its plain version")

    if not check_small_agreement():
        fail("tiny geometry: card and CPU disagree")

    svc, shapes, bad = run_round(card)
    if bad:
        fail(f"round checks failed: {bad}")
    print(f"[profile] denoise step at full width ({card}): "
          f"{json.dumps(profile_denoise(svc))}", flush=True)

    by_shape = {(b, sq, sk, h, d): name
                for name, (b, sq, sk, h, d, _) in FLASH_SHAPES.items()}
    unknown = set(shapes) - set(by_shape)
    missing = set(by_shape) - set(shapes)
    if unknown or missing:
        fail(f"main-path flash shapes differ from the checked ones: "
             f"unchecked {sorted(unknown)}, never launched {sorted(missing)}")

    kernels = []
    for key, name in by_shape.items():
        r = rows[name]
        kernels.append({
            "name": f"flash_attention[{name}]", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": shapes[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ok": r["ok"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
