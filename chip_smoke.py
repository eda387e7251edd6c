"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``cassmantle_tpu_torch`` only (nothing of JAX or ``cassmantle_tpu``):

0. prints the card's name and power limit; fails without CUDA, or with a
   kill switch (CASSMANTLE_NO_FUSED_CONV, CASSMANTLE_NO_W8A8) set;
1. builds every kernel of ``cassmantle_tpu_torch/csrc/`` with ``nvcc``
   (one process per source, all at once) into the git-ignored
   ``cassmantle_tpu_torch/_build/``, and reports each kernel's registers
   and spills and, with ``cuobjdump``, its warpgroup MMA instructions
   (fails if a wgmma kernel spills or issues none);
2. holds each kernel (flash attention, the fused GroupNorm-affine + SiLU +
   conv3x3, the int8 matmul, the int8 conv3x3) against its plain PyTorch
   version at every shape the main paths give it (the fused conv also at
   the SD1.5 and SDXL VAE decoders' widths, 64 to 1024; flash also at the
   decoder-only forward's batch 4), and times the kernel,
   the plain version and one PyTorch library call (a yardstick the port
   never calls) beside the card's bound for the work (for flash
   attention also the floor its exponentials set, and the kernel path
   each shape takes);
3. runs the tiny test geometry on the card and on the CPU from the same
   weights and inputs (default, fused-conv, W8A8, SDXL, encoder
   propagation, DeepCache, Euler, DPM-Solver++(2M) alone, with DeepCache
   and under encoder propagation, consistency sampling, img2img with the
   VAE encoder, and the Mistral prompt LM), and checks that images,
   prompt tokens, logits, scores and blur agree; and holds
   ``utils/jax_random.py``'s keys, bits and uniforms on the card equal to
   the CPU's ([jax_random]);
4. serves one game round at full width (SD1.5 512x512, 50-step CFG DDIM,
   GPT-2-small prompt text, MiniLM scoring, blur) with seeded random
   weights under each of ``FrameworkConfig()``,
   ``fusedconv_serving_config()`` and ``w8a8_serving_config()``, one
   under ``sdxl_config()`` (SDXL-base 1024x1024: CLIP-L and bigG text
   towers, the micro-conditioned UNet, the 0.13025 VAE), and one under
   each of ``encprop_serving_config()`` (20 key forwards, 15 batched
   decoder-only forwards, the fused VAE decoder) and
   ``deepcache_serving_config()`` (25 full/shallow pairs), one under
   each of ``fast_serving_config()`` (DPM-Solver++(2M)
   at 25 steps), ``turbo_serving_config()`` (DPM++ at 24 steps in 12
   DeepCache pairs) and ``lcm_serving_config()`` (four consistency
   steps), and one img2img call (``generate_img2img`` at strength 0.6:
   the fused VAE encoder, the last 30 of DDIM's 50 steps, the fused
   decoder) on a served round's image, each with the
   counts set to 0 just before it and read just after: every kernel of
   the path launched as often, and at the shapes, as the path says (and
   the default and SDXL rounds none of the other kernels), at checked
   shapes only, and each flash shape on the kernel path its check took.
   The CFG steps replay captured CUDA graphs (one of the step; encprop
   a key-step and a segment graph; DeepCache a pair graph; img2img's tail
   a step graph), and the GPT-2 decode steps one of the decode step
   (``ops/graphs.py``): the counts add each replay's launches, and each
   graph must have replayed as often as its loop says;
5. holds each served graph against the eager steps it replaces
   ([graphs]): the final latents of a 50-step graphed denoise bit-equal
   to the eager loop's on the same x_T and conditioning, and (default,
   W8A8) the 96 decode tokens equal, with each graph's capture and
   instantiate seconds and pool bytes;
6. profiles the served step (graph replays) and the eager step beside
   it: host time per step, the device's busy time and idle share, device
   kernels and host launch calls per step, and each kernel's part; the
   profiled replays must show the step's kernels (flash, and the fused
   conv or the int8 kernels of the preset), the witness that a replay
   launches them. Under encprop, DeepCache, fast, turbo, lcm and img2img
   each captured body is profiled the same way, with the whole loop's
   host ms and idle share (and img2img's eager VAE encoder);
7. serves a round with Mistral-7B as the prompt LM ([round-mistral]: 32
   layers of 4096, GQA 32/8, bf16, seeded random weights built submodule
   by submodule; the image path as at default), with the LM's build
   seconds, parameter bytes, prefill ms and graphed decode ms per token
   beside the weight-read bound; its 96 graphed decode tokens equal the
   eager ones ([graphs]); profiles a decode-step replay ([profile]: busy
   ms, idle share, kernels, the fp32 LM head's share); the tiny Mistral
   geometry on the card against the CPU ([small] mistral);
8. speculative decode against greedy ([spec]): GPT-2 under
   ``spec_decode_serving_config()``, Mistral-7B with the n-gram draft,
   and with a GPT-2-small draft at vocabulary 32,000: tokens, the
   chunks / drafted / accepted counts, decode seconds, host reads; where
   tokens part, the greedy chain's top-2 gap there may not exceed twice
   the drift between the verify forward's logits and greedy's there;
9. Mistral-7B top-k sampled decode ([sampled], T 0.7, k 40): graphed
   equal to eager for one seed, every token in its step's top 40;
10. the serving seam ([serve]): ``InferenceService(FrameworkConfig())``
   behind its batching queues, supervisor and int8 table: (a) 1,024
   concurrent one-pair ``similarity`` calls of out-of-vocabulary guesses
   coalesce into bucketed dispatches, scores within 1e-5 of one direct
   call, with per-guess latency and device ms a dispatch; (b) the same
   through rung 0 (in-vocabulary guesses, pinned answers): no dispatch,
   scores within 1e-2 of fp32; (c) four concurrent rounds, one cold,
   while guesses are scored: one prompt batch of four, each text the
   lone batch decode's, each image bit-equal to a lone ``t2i.generate``
   of what the round drew, flash launched 4 x 1,601 times; (d) a
   poisoned member floors its own request only; (e) with one UNet
   weight corrupted, a chaos ``device.lost`` recovers in place (the
   models built again into the served tensors, the warm replaying the
   last decode), the image after equal to the one before with no new
   capture; (f) a device-side assert in a child
   process classifies as a device loss, an out-of-memory error does
   not. After the SDXL round, ``[serve-sdxl]``: its service serves one
   round while guesses are scored (``BASELINE.json``'s fifth
   configuration on one card);
11. weights from a directory: ``[weights]`` writes fp16 files under the
   published names and shapes of ``data/manifests`` (seeded N(0, 0.02)
   values, unit norm scales, zero biases; about 3 GB) and synthetic
   vocabularies into the git-ignored ``cassmantle_tpu_torch/_build/``,
   serves ``InferenceService(FrameworkConfig(), weights_dir=...)`` from
   them and checks that every published key is consumed or ignored, that
   every served tensor equals its file's converted tensor, that the BPE
   and WordPiece tokenizers serve, the round checks of
   ``[round-default]`` (``[round-weights]``, ``[graphs] weights``), an
   image other than the seeded service's, and a second boot verifying
   the fingerprint sidecars, with each file's load seconds and GB/s;
   ``[weights-rebuild]`` runs ``[serve]`` (e)'s drill on that service,
   its recipes reading the files again (the rebuild's rise in
   ``max_memory_allocated`` at most the largest tensor in fp32 plus 64
   MiB, beside the seeded recipe's rise); ``[weights-mistral]`` builds
   Mistral at full width, cut to 4 layers, from two BF16 shards through
   ``build_streamed`` (peak at most the bf16 footprint plus one fp32
   submodule, tensors equal to the shards', graphed decode = eager). The
   files are removed after.

Prints one ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
prints no result.
"""

from __future__ import annotations

import asyncio
import collections
import gc
import json
import logging
import math
import os
import re
import struct
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
    # SDXL-1024 (sdxl_config()): head dim 64, 10 heads at 640 channels
    # (64x64 latents), 20 at 1280 (32x32); the VAE mid block at 128x128
    "self_x1": (2, 4096, 4096, 10, 64, "self"),
    "cross_x1": (2, 4096, 77, 10, 64, "cross"),
    "self_x2": (2, 1024, 1024, 20, 64, "self"),
    "cross_x2": (2, 1024, 77, 20, 64, "cross"),
    "vae_mid_xl": (1, 16384, 16384, 1, 512, "separate"),
    # the encoder-propagation preset's decoder-only forward: the up path's
    # levels at batch 4 (2 propagated steps x the CFG pair)
    "self_l0_b4": (4, 4096, 4096, 8, 40, "self"),
    "cross_l0_b4": (4, 4096, 77, 8, 40, "cross"),
    "self_l1_b4": (4, 1024, 1024, 8, 80, "self"),
    "cross_l1_b4": (4, 1024, 77, 8, 80, "cross"),
    "self_l2_b4": (4, 256, 256, 8, 160, "self"),
    "cross_l2_b4": (4, 256, 77, 8, 160, "cross"),
}
# Flash launches of one SD1.5 UNet forward by mode (its transformer
# blocks, one self and one cross attention each): a full forward runs 16
# (5 at each of three levels, 1 in the mid block); the decoder-only
# forward of encoder propagation the up path's 9 (3 a level), at batch 4;
# DeepCache's shallow forward level 0's 5 (2 down, 3 up).
UNET_FLASH = {
    "full": {"self_l0": 5, "cross_l0": 5, "self_l1": 5, "cross_l1": 5,
             "self_l2": 5, "cross_l2": 5, "self_mid": 1, "cross_mid": 1},
    "decoder_only": {"self_l0_b4": 3, "cross_l0_b4": 3, "self_l1_b4": 3,
                     "cross_l1_b4": 3, "self_l2_b4": 3, "cross_l2_b4": 3},
    "shallow": {"self_l0": 5, "cross_l0": 5},
}
# UNet forwards of one round by preset, where they differ from DDIM-50's
# 50 full: encoder propagation runs 20 key (full) forwards (5 dense, then
# one per segment of 3) and one decoder-only forward for the 2 propagated
# steps of each of the 15 segments; DeepCache 25 full and 25 shallow
# forwards; DPM-Solver++(2M) 25 (fast), or 12 full/shallow pairs with
# DeepCache (turbo); the consistency sampler 4 (lcm); img2img at strength
# 0.6 the last 30 of DDIM's 50 steps.
SAMPLER_FORWARDS = {"encprop": {"full": 20, "decoder_only": 15},
                    "deepcache": {"full": 25, "shallow": 25},
                    "fast": {"full": 25},
                    "turbo": {"full": 12, "shallow": 12},
                    "lcm": {"full": 4},
                    "img2img": {"full": 30}}
# VAE mid blocks a round: the decoder's; img2img's encoder adds one
VAE_MIDS = {"img2img": 2}
IMG2IMG_STRENGTH = 0.6


def sampler_flash(sampler: str) -> dict:
    """Flash launches per shape of one SD1.5 round under ``sampler``: its
    UNet forwards' and the VAE mid blocks' (one a decoder or encoder)."""
    out = {"vae_mid": VAE_MIDS.get(sampler, 1)}
    for mode, forwards in SAMPLER_FORWARDS[sampler].items():
        for name, n in UNET_FLASH[mode].items():
            out[name] = out.get(name, 0) + n * forwards
    return out


# Flash launches per shape of one round, by model: 50 CFG steps x the
# transformer blocks at the shape's level (each one self and one cross
# attention), and the VAE mid block once. SD1.5: 5 blocks at each of
# three levels, 1 in the mid block (1,601 a round). SDXL: 5 x 2 at
# 64x64, 5 x 10 + 10 mid at 32x32 (7,001 a round).
ROUND_FLASH = {
    "sd15": {"self_l0": 250, "cross_l0": 250, "self_l1": 250,
             "cross_l1": 250, "self_l2": 250, "cross_l2": 250,
             "self_mid": 50, "cross_mid": 50, "vae_mid": 1},
    "sdxl": {"self_x1": 500, "cross_x1": 500, "self_x2": 3000,
             "cross_x2": 3000, "vae_mid_xl": 1},
    # 20 x 32 + 15 x 18 + 1 = 911 and 25 x 32 + 25 x 10 + 1 = 1,051;
    # 25 x 32 + 1 = 801 (fast), 12 x 32 + 12 x 10 + 1 = 505 (turbo),
    # 4 x 32 + 1 = 129 (lcm), 30 x 32 + 2 = 962 (img2img)
    **{sampler: sampler_flash(sampler) for sampler in SAMPLER_FORWARDS},
}
# by kernel path: the UNet's head dims on the wgmma kernel, the VAE mid
# blocks' D = 512 on mma.sync (ops/_flash_plan.py)
ROUND_FLASH_PATHS = {
    model: {"wgmma": sum(n for name, n in counts.items()
                         if not name.startswith("vae")),
            "mma.sync": sum(n for name, n in counts.items()
                            if name.startswith("vae"))}
    for model, counts in ROUND_FLASH.items()}
# the model (and loop) each served preset runs
PRESET_MODEL = {"default": "sd15", "weights": "sd15", "fusedconv": "sd15",
                "w8a8": "sd15",
                "sdxl": "sdxl", "mistral": "sd15",
                **{sampler: sampler for sampler in SAMPLER_FORWARDS}}
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

PEAK_INT8_OPS = 1979e12
UNET_FORWARDS = 50               # one CFG forward (batch 2) per DDIM step
LM_FORWARDS = 96                 # prefill + 95 decode steps (max_new 96)

# Every ResBlock conv3x3 of one SD1.5-512 UNet forward with CFG:
# (B, H, W, C, F) -> launches per forward (22 ResBlocks x 2 = 44); the
# fused kernel runs them under fusedconv_serving_config(), the int8 conv
# under w8a8_serving_config().
CONV_SHAPES = {
    (2, 64, 64, 320, 320): 7, (2, 64, 64, 640, 320): 2,
    (2, 64, 64, 960, 320): 1, (2, 32, 32, 320, 640): 1,
    (2, 32, 32, 640, 640): 6, (2, 32, 32, 960, 640): 1,
    (2, 32, 32, 1280, 640): 1, (2, 32, 32, 1920, 640): 1,
    (2, 16, 16, 640, 1280): 1, (2, 16, 16, 1280, 1280): 6,
    (2, 16, 16, 1920, 1280): 1, (2, 16, 16, 2560, 1280): 2,
    (2, 8, 8, 1280, 1280): 11, (2, 8, 8, 2560, 1280): 3,
}
# Every ResBlock conv3x3 of one VAE decode (one image): (B, H, W, C, F) ->
# launches (mid block 2 ResBlocks, 3 a level, 2 convs each: 28). The
# fused kernel runs SD1.5's under encprop_serving_config() (18 of them
# at W > 64); SDXL's six shapes are checked, not served. The SD1.5
# encoder's (img2img's, 2 ResBlocks a level and the mid block's 2: 20)
# raise the channels where the decoder lowers them: C 128 -> F 256 at
# 256x256 and 256 -> 512 at 128x128.
VAE_CONV_SHAPES = {
    "sd15": {(1, 64, 64, 512, 512): 10, (1, 128, 128, 512, 512): 6,
             (1, 256, 256, 512, 256): 1, (1, 256, 256, 256, 256): 5,
             (1, 512, 512, 256, 128): 1, (1, 512, 512, 128, 128): 5},
    "sdxl": {(1, 128, 128, 512, 512): 10, (1, 256, 256, 512, 512): 6,
             (1, 512, 512, 512, 256): 1, (1, 512, 512, 256, 256): 5,
             (1, 1024, 1024, 256, 128): 1, (1, 1024, 1024, 128, 128): 5},
    "sd15_enc": {(1, 512, 512, 128, 128): 4, (1, 256, 256, 128, 256): 1,
                 (1, 256, 256, 256, 256): 3, (1, 128, 128, 256, 512): 1,
                 (1, 128, 128, 512, 512): 3, (1, 64, 64, 512, 512): 8},
}
# Every W8A8 dense site of one UNet forward, (M, K, N) -> launches (16
# transformer blocks x 7: self qkv and out, cross q, kv and out, GEGLU
# proj and out). M = 2 x tokens; the cross kv reads the 2 x 77 context.
UNET_MATMUL_SHAPES = {}
for _c, _m, _blocks in ((320, 8192, 5), (640, 2048, 5), (1280, 512, 5),
                        (1280, 128, 1)):
    for _shape, _n in (((_m, _c, 3 * _c), 1), ((_m, _c, _c), 3),
                       ((_m, _c, 8 * _c), 1), ((_m, 4 * _c, _c), 1),
                       ((154, 768, 2 * _c), 1)):
        UNET_MATMUL_SHAPES[_shape] = (UNET_MATMUL_SHAPES.get(_shape, 0)
                                      + _n * _blocks)
# GPT-2's W8A8 projections per layer (q, k, v, out, fc1, fc2) at M = 32
# (prefill: one prompt in the 32-token bucket) and M = 1 (decode).
GPT2_KN = {(768, 768): 4, (768, 3072): 1, (3072, 768): 1}
GPT2_LAYERS = 12
LM_MATMUL_SHAPES = {(m, k, n): c * GPT2_LAYERS * (1 if m == 32 else 95)
                    for m in (32, 1) for (k, n), c in GPT2_KN.items()}
ROUND_FUSED_LAUNCHES = 44 * UNET_FORWARDS                     # 2,200
ROUND_UNET_MATMUL_LAUNCHES = 112 * UNET_FORWARDS              # 5,600
ROUND_LM_MATMUL_LAUNCHES = 72 * LM_FORWARDS                   # 6,912

FUSED_REPLACES = "cassmantle_tpu/ops/fused_conv.py:273"
FUSED_SOURCE = "cassmantle_tpu_torch/csrc/fused_conv.cu"
MATMUL_REPLACES = "cassmantle_tpu/ops/quant_matmul.py:170"
CONV_REPLACES = "cassmantle_tpu/ops/quant_matmul.py:383"
INT8_SOURCE = "cassmantle_tpu_torch/csrc/int8_gemm.cu"


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


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


# exponentials a clock of one SM: 16 special-function lanes (ex2)
EX2_PER_SM_CLOCK = 16


def flash_exp_floor_ms(b, sq, sk, h, sms, clock_mhz):
    """The least time the B*H*Sq*Sk exponentials of the online softmax
    take on the SMs' special-function units at the highest clock."""
    return b * h * sq * sk / (sms * EX2_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3


def flash_bound(b, sq, sk, h, d):
    """(bound ms, 'bytes' or 'operations', flops, bytes): 4*B*H*Sq*Sk*D
    FLOPs at the bf16 peak; q, k, v, o read or written once."""
    flops = 4 * b * h * sq * sk * d
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def check_flash_kernel():
    """Kernel vs plain at every main-path shape; returns per-shape rows,
    each with the kernel path the shape took (wgmma or mma.sync) and the
    floor of its exponentials."""
    import torch
    import torch.nn.functional as F

    from cassmantle_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        reset_counters,
    )

    rows = {}
    gen = torch.Generator("cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_mhz()
    for name, (b, sq, sk, h, d, layout) in FLASH_SHAPES.items():
        q, k, v = flash_inputs(b, sq, sk, h, d, layout, gen)
        reset_counters()
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        (path,) = flash_attention.paths
        exp_ms = flash_exp_floor_ms(b, sq, sk, h, sms, clock)
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
            shape=[b, sq, sk, h, d], path=path,
            max_abs_err=agree["max_abs_err"], ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            ok=finite and agree["ok"])
        print(f"[kernel] flash_attention {name} (B, Sq, Sk, H, D)="
              f"{(b, sq, sk, h, d)} path {path}: max_abs_err "
              f"{agree['max_abs_err']:.3e} (limit {agree['max_limit']:.3e}, "
              f"{agree['max_share']:.2f} of it), rel_rms_err "
              f"{agree['rel_rms_err']:.3e} ({agree['rms_share']:.2f} of "
              f"{FLASH_RMS_REL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), exp floor {exp_ms * 1e3:.2f} us "
              f"({clock:.0f} MHz) -> "
              f"{'pass' if rows[name]['ok'] else 'FAIL'}", flush=True)
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def bound(ops, nbytes, peak):
    """(bound ms, 'operations' or 'bytes'): the larger of ops at ``peak``
    and bytes at the memory rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def report_row(kernel, label, shape, agree, ms, plain_ms, library_ms,
               library_name, ops, nbytes, peak):
    """One [kernel] line and the row kept for the kernels JSON line."""
    bound_ms, bound_by = bound(ops, nbytes, peak)
    row = dict(shape=list(shape), max_abs_err=agree["max_abs_err"], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, ok=agree["ok"])
    lib = ("none" if library_ms is None
           else f"{library_name} {library_ms:.4f} ms")
    print(f"[kernel] {kernel} {label}={tuple(shape)}: {agree['text']}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib}, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}; {ops / 1e9:.3f} G ops, "
          f"{nbytes / 1e6:.2f} MB) -> {'pass' if row['ok'] else 'FAIL'}",
          flush=True)
    return row


def scaled_agreement(out, ref) -> dict:
    """bf16 outputs against the plain version under the flash limits:
    max |diff| <= 2^-6 max |plain|, ||diff||_2 <= 1e-2 ||plain||_2."""
    import torch

    a = flash_agreement(out, ref)
    ok = a["ok"] and bool(torch.isfinite(out).all())
    return dict(max_abs_err=a["max_abs_err"], ok=ok, text=(
        f"max_abs_err {a['max_abs_err']:.3e} ({a['max_share']:.2f} of "
        f"{a['max_limit']:.3e}), rel_rms_err {a['rel_rms_err']:.3e} "
        f"({a['rms_share']:.2f} of {FLASH_RMS_REL})"))


def exact_agreement(out, ref) -> dict:
    """The int8 kernels against their plain versions: int32 sums are
    exact and both round the fp32 epilogue step by step, so the outputs
    must be equal (limit 0)."""
    diff = (out.float() - ref.float()).abs()
    n_diff = int((diff > 0).sum().item())
    return dict(max_abs_err=diff.max().item(), ok=n_diff == 0, text=(
        f"max_abs_err {diff.max().item():.3e}, {n_diff} of {diff.numel()} "
        f"values differ (limit: equal)"))


def check_fused_conv_kernel():
    """Kernel 2 vs plain at the UNet's 14 ResBlock conv shapes, the VAE
    decoders' (SD1.5's six, W 64 to 512, and SDXL's six, W 128 to 1024:
    2-row tiles of 64-column stretches past W = 64) and the SD1.5
    encoder's two that rise in channels (128 -> 256, 256 -> 512), bf16
    unit-normal x, affine a in [0.5, 1.5) with a nonzero shift, weights
    ~ N(0, 1/9C) in the models' OHWI memory. Library yardstick: one cuDNN
    conv of the pre-activated tensor (the conv alone)."""
    import torch
    import torch.nn.functional as F

    from cassmantle_tpu_torch.ops.fused_conv import (
        gn_silu_conv3x3,
        gn_silu_conv3x3_plain,
    )

    rows = {}
    gen = torch.Generator("cuda").manual_seed(1)
    vae = {**VAE_CONV_SHAPES["sd15"], **VAE_CONV_SHAPES["sdxl"],
           **VAE_CONV_SHAPES["sd15_enc"]}
    for shape in list(CONV_SHAPES) + list(vae):
        b, h, w, c, f = shape
        kw = dict(generator=gen, device="cuda")
        x = torch.randn((b, h, w, c), dtype=torch.bfloat16, **kw)
        a = torch.rand((b, c), **kw) + 0.5
        shift = torch.randn((b, c), **kw) * 0.5
        ohwi = (torch.randn((f, 3, 3, c), **kw) / (9 * c) ** 0.5).bfloat16()
        kernel = ohwi.permute(1, 2, 3, 0)
        bias = torch.randn((f,), **kw) * 0.1
        out = gn_silu_conv3x3(x, a, shift, kernel, bias)
        torch.cuda.synchronize()
        ref = gn_silu_conv3x3_plain(x, a, shift, kernel, bias)
        agree = scaled_agreement(out, ref)
        ms = time_ms(lambda: gn_silu_conv3x3(x, a, shift, kernel, bias), 20)
        plain_ms = time_ms(
            lambda: gn_silu_conv3x3_plain(x, a, shift, kernel, bias), 2)
        act = F.silu(x.float() * a[:, None, None] + shift[:, None, None]) \
            .bfloat16().permute(0, 3, 1, 2)
        w_oihw = ohwi.permute(0, 3, 1, 2)
        bias16 = bias.bfloat16()
        library_ms = time_ms(
            lambda: F.conv2d(act, w_oihw, bias16, padding=1), 20)
        m = b * h * w
        ops = 18 * m * c * f
        nbytes = 2 * (m * c + 9 * c * f + m * f) + 4 * (2 * b * c + f)
        rows[shape] = report_row(
            "gn_silu_conv3x3", "(B, H, W, C, F)", shape, agree, ms, plain_ms,
            library_ms, "cudnn conv", ops, nbytes, PEAK_BF16_FLOPS)
        del x, a, shift, ohwi, kernel, bias, out, ref, act
        torch.cuda.empty_cache()
    return rows


def check_int8_matmul_kernel():
    """Kernel 3 vs plain at the 19 UNet (M, K, N) (one per-tensor scale,
    stride 0) and the GPT-2 prefill and decode shapes (per-token scales),
    bf16 out, int8 operands uniform in [-127, 127], the weight in the
    modules' (N, K) memory. Library yardstick: torch._int_mm, the int32
    product alone (it takes M > 16 only)."""
    import torch

    from cassmantle_tpu_torch.ops.quant_matmul import (
        int8_matmul,
        int8_matmul_plain,
    )

    rows = {}
    gen = torch.Generator("cuda").manual_seed(2)
    for shape in list(UNET_MATMUL_SHAPES) + list(LM_MATMUL_SHAPES):
        m, k, n = shape
        per_token = shape in LM_MATMUL_SHAPES
        kw = dict(generator=gen, device="cuda")
        x_q = torch.randint(-127, 128, (m, k), dtype=torch.int8, **kw)
        w_q = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw).t()
        row = torch.rand((m if per_token else 1,), **kw) * 0.01 + 1e-3
        col = torch.rand((n,), **kw) * 1e-3 + 1e-4
        bias = torch.randn((n,), **kw)
        args = (x_q, w_q, row, col, bias, torch.bfloat16)
        out = int8_matmul(*args)
        torch.cuda.synchronize()
        agree = exact_agreement(out, int8_matmul_plain(*args))
        ms = time_ms(lambda: int8_matmul(*args), 20)
        plain_ms = time_ms(lambda: int8_matmul_plain(*args), 2)
        library_ms = (time_ms(lambda: torch._int_mm(x_q, w_q), 20)
                      if m > 16 else None)
        ops = 2 * m * k * n
        nbytes = m * k + k * n + 2 * m * n + 4 * (row.numel() + 2 * n)
        rows[shape] = report_row(
            "int8_matmul", "(M, K, N)", shape, agree, ms, plain_ms,
            library_ms, "torch._int_mm", ops, nbytes, PEAK_INT8_OPS)
        del x_q, w_q, row, col, bias, out, args
        torch.cuda.empty_cache()
    return rows


def int8_im2col(x_q):
    """(B*H*W, 9*C) int8: the nine SAME-padded taps of each pixel, tap
    by tap, for the library yardstick."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = x_q.shape
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(b * h * w, 9 * c)


def check_int8_conv_kernel():
    """Kernel 4 vs plain at the 14 ResBlock conv shapes, int8 operands
    uniform in [-127, 127], the weight in OHWI memory, bf16 out. No single
    PyTorch call computes an int8 conv; the library yardstick is
    torch._int_mm on an im2col built beforehand (M = B*H*W, K = 9C, N =
    F): the int32 product alone, im2col prebuilt."""
    import torch

    from cassmantle_tpu_torch.ops.quant_matmul import (
        int8_conv3x3,
        int8_conv3x3_plain,
    )

    rows = {}
    gen = torch.Generator("cuda").manual_seed(3)
    for shape in CONV_SHAPES:
        b, h, w, c, f = shape
        kw = dict(generator=gen, device="cuda")
        x_q = torch.randint(-127, 128, (b, h, w, c), dtype=torch.int8, **kw)
        kernel = torch.randint(-127, 128, (f, 3, 3, c), dtype=torch.int8,
                               **kw).permute(1, 2, 3, 0)
        col = torch.rand((f,), **kw) * 1e-5 + 1e-6
        bias = torch.randn((f,), **kw)
        args = (x_q, kernel, col, bias, torch.bfloat16)
        out = int8_conv3x3(*args)
        torch.cuda.synchronize()
        agree = exact_agreement(out, int8_conv3x3_plain(*args))
        ms = time_ms(lambda: int8_conv3x3(*args), 20)
        plain_ms = time_ms(lambda: int8_conv3x3_plain(*args), 2)
        cols = int8_im2col(x_q)
        w_kn = kernel.permute(3, 0, 1, 2).reshape(f, 9 * c).t()
        library_ms = time_ms(lambda: torch._int_mm(cols, w_kn), 20)
        m = b * h * w
        ops = 18 * m * c * f
        nbytes = m * c + 9 * c * f + 2 * m * f + 8 * f
        rows[shape] = report_row(
            "int8_conv3x3", "(B, H, W, C, F)", shape, agree, ms, plain_ms,
            library_ms, "torch._int_mm (int32 product alone, im2col "
            "prebuilt)", ops, nbytes, PEAK_INT8_OPS)
        del x_q, kernel, col, bias, out, args, cols, w_kn
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
    # no int8 table: the scores below come from each side's device rung
    cpu = InferenceService(cfg, device="cpu", table=None)
    b = cpu.backend
    sd = {"clip_text": b.t2i.clip.state_dict(),
          "unet": b.t2i.unet.state_dict(), "vae": b.t2i.vae.state_dict(),
          "gpt2": b.prompt_gen.model.state_dict(),
          "minilm": cpu.scorer.model.state_dict()}
    gpu = InferenceService(cfg, device="cuda", state_dicts=sd, table=None)
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
    sim_err = float(np.abs(asyncio.run(cpu.similarity(pairs))
                           - asyncio.run(gpu.similarity(pairs))).max())
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


def with_unet(cfg, **unet_kw):
    import dataclasses

    m = cfg.models
    return cfg.replace(models=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, **unet_kw)))


SITE_REL = 1e-5


def record_w8a8_sites():
    """Patch the two W8A8 site functions that quantize (``w8a8_dense``
    where the modules call it, ``w8a8_conv3x3`` after the conv sites'
    elementwise pass) to record each call as (function, args, kwargs);
    returns (calls, undo)."""
    from cassmantle_tpu_torch.models import layers
    from cassmantle_tpu_torch.ops import quant_matmul

    calls = []
    real = [(layers, "w8a8_dense"), (quant_matmul, "w8a8_conv3x3")]
    real = [(mod, n, getattr(mod, n)) for mod, n in real]

    def wrap(fn):
        def site(*args, **kw):
            calls.append((fn, args, kw))
            return fn(*args, **kw)
        return site

    for mod, n, fn in real:
        setattr(mod, n, wrap(fn))
    return calls, lambda: [setattr(mod, n, fn) for mod, n, fn in real]


def wrong_scales(fn, kw):
    """The control: ``fn`` with the scale mode the site does not use.
    A per-token site scales per tensor; a per-tensor site scales each
    sample alone, where the port scales the whole CFG batch at once."""
    import torch

    if kw.get("per_token"):
        return lambda *args, **kw: fn(*args, **{**kw, "per_token": False})
    return lambda x, *args, **kw: torch.cat(
        [fn(x[i:i + 1], *args, **kw) for i in range(x.shape[0])])


def replay_w8a8_sites(calls):
    """Each recorded card site call again in fp32, on the card and on the
    CPU from the same inputs: {"sites", "calls", "max_rel", "worst_call",
    "control_rel"}.

    The replayed functions take the activation as it reaches the
    quantize step (the conv sites' GroupNorm affine and SiLU, plain
    PyTorch that may round an ulp apart on the two devices, ran before
    it), so the int8 activations are the same on both (the same fp32
    divides and rounding), the int32 sums exact, and the fp32 epilogue
    within an ulp: max |card - CPU| within 1e-5 of max |CPU| per call.
    The control runs the first dense and the first conv call with the
    wrong scale mode on the card (``wrong_scales``): it must miss that
    limit."""
    import torch

    from cassmantle_tpu_torch.ops.quant import ActQTensor

    def to(v, device):
        if isinstance(v, ActQTensor):
            return ActQTensor(*(None if t is None else t.to(device)
                                for t in v))
        if isinstance(v, torch.Tensor):
            v = v.to(device)
            return v.float() if v.is_floating_point() else v
        return v

    def rel(a, b):
        return float((a.float().cpu() - b).abs().max() / b.abs().max())

    worst, worst_call, control, sites, controlled = 0.0, None, [], set(), \
        set()
    for fn, args, kw in calls:
        kw = {**kw, **({"out_dtype": torch.float32} if "out_dtype" in kw
                       else {})}
        q = next(a for a in args if isinstance(a, ActQTensor))
        sites.add(q.data.data_ptr())
        with torch.inference_mode():
            card_args = [to(a, "cuda") for a in args]
            cpu = fn(*(to(a, "cpu") for a in args), **kw)
            err = rel(fn(*card_args, **kw), cpu)
            if err > worst:
                worst, worst_call = err, [fn.__name__, list(args[0].shape)]
            if fn not in controlled and args[0].shape[0] > 1:
                controlled.add(fn)
                control.append(rel(wrong_scales(fn, kw)(*card_args, **kw),
                                   cpu))
    return dict(sites=len(sites), calls=len(calls), max_rel=worst,
                worst_call=worst_call,
                control_rel=min(control) if control else None)


def check_small_fused_and_w8a8():
    """The tiny geometry's fused-conv and W8A8 twins (bf16 UNet) on the
    card and on the CPU from the same weights and inputs, each image held
    against an fp32 CPU run of the fused fp path (the plain version in
    fp32, which the CPU tests hold against the reference).

    fused conv: the card strays from fp32 no further than the CPU's own
    bf16 run does, plus 0.5 of a level on the mean and 2 at the max (the
    default path's limits: bf16 roundings differ in order between the two
    and 4 steps carry them on).
    W8A8 (w8a8_min_size=0, dynamic scales), site by site: every quantized
    site call of the card's image run and of its GPT-2 decode replayed in
    fp32 on the card and on the CPU from the same inputs
    (``replay_w8a8_sites``),
    every quantized site called, and a per-sample control that misses the
    limit. The images as a gross check only: both runs carry the int8
    quantization error on top of bf16's, and an int8 value flips where
    card and CPU round the activation a bf16 ulp apart, moving its element
    by 1/127 of the site's absmax; the tiny model amplifies such flips to
    the size of the quantization error itself. So the card may stray from
    fp32 at most 1.5 times as far as the CPU's W8A8 run does, plus 0.5 of
    a level on the mean and 2 at the max. GPT-2 tokens: their agreement
    is reported (a flip where two logits are within a step changes a
    greedy token)."""
    import dataclasses

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.ops import fused_conv, quant_matmul
    from cassmantle_tpu_torch.ops.quant import w8a8_site_count
    from cassmantle_tpu_torch.serving.pipeline import (
        PromptGenerator,
        Text2ImagePipeline,
    )

    fused_cfg = with_unet(tiny_bf16_config(), fused_conv=True,
                          conv_pad_to=128)
    cpu = Text2ImagePipeline(fused_cfg, device="cpu")
    sd = {"clip_text": cpu.clip.state_dict(), "unet": cpu.unet.state_dict(),
          "vae": cpu.vae.state_dict()}
    fp32 = Text2ImagePipeline(with_unet(test_config(), fused_conv=True),
                              device="cpu", state_dicts=sd)
    hw = fused_cfg.sampler.image_size // cpu.vae_scale
    x_t = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, hw, hw, 4)).astype(np.float32))
    prompts = ["A watercolor style piece depicting: a lighthouse at dusk.",
               "A vaporwave style piece depicting: the comet market."]
    ref = fp32.generate(prompts, latents=x_t).astype(np.int32)

    def deviation(pipe):
        img = pipe.generate(prompts, latents=x_t).astype(np.int32)
        d = np.abs(img - ref)
        return int(d.max()), float(d.mean())

    ok_all = True
    w8a8_cfg = fused_cfg.replace(models=dataclasses.replace(
        fused_cfg.models, unet_w8a8=True, lm_w8a8=True, w8a8_min_size=0))
    for name, cfg, scale in (("fused_conv", fused_cfg, 1.0),
                             ("w8a8", w8a8_cfg, 1.5)):
        c_max, c_mean = deviation(Text2ImagePipeline(
            cfg, device="cpu", state_dicts=sd))
        fused_conv.reset_counters()
        quant_matmul.reset_counters()
        gpu = Text2ImagePipeline(cfg, device="cuda", state_dicts=sd)
        calls, undo = record_w8a8_sites()
        try:
            g_max, g_mean = deviation(gpu)
        finally:
            undo()
        launched = (fused_conv.gn_silu_conv3x3.launches
                    if name == "fused_conv"
                    else min(quant_matmul.int8_conv3x3.launches,
                             quant_matmul.int8_matmul.launches))
        res = dict(card_vs_fp32_max=g_max, card_vs_fp32_mean=g_mean,
                   cpu_vs_fp32_max=c_max, cpu_vs_fp32_mean=c_mean,
                   card_kernels_launched=launched > 0)
        ok = (g_mean <= scale * c_mean + 0.5 and g_max <= scale * c_max + 2
              and launched > 0)
        if name == "w8a8":
            seeds = ["The Night the Trains Sang", "Chapter two: the harbor"]
            lm_sd = PromptGenerator(fused_cfg, device="cpu").model \
                .state_dict()
            lm_cpu = PromptGenerator(cfg, device="cpu", state_dict=lm_sd)
            lm_gpu = PromptGenerator(cfg, device="cuda", state_dict=lm_sd)
            tok_c, _ = lm_cpu.decode_ids_batch(seeds)
            lm_calls, undo = record_w8a8_sites()
            try:
                tok_g, _ = lm_gpu.decode_ids_batch(seeds)
            finally:
                undo()
            unet_sites = replay_w8a8_sites(calls)
            lm_sites = replay_w8a8_sites(lm_calls)
            res.update(unet_sites=unet_sites, lm_sites=lm_sites,
                       token_agreement=float((tok_c == tok_g).mean()))
            ok = (ok and unet_sites["sites"] == w8a8_site_count(gpu.unet)
                  and lm_sites["sites"] == w8a8_site_count(lm_gpu.model)
                  == 6 * cfg.models.gpt2.num_layers
                  and max(unet_sites["max_rel"], lm_sites["max_rel"])
                  <= SITE_REL
                  and unet_sites["control_rel"] > SITE_REL
                  and lm_sites["control_rel"] > SITE_REL)
        print(f"[small] tiny geometry, {name}, card vs CPU: "
              f"{json.dumps(res)} -> {'pass' if ok else 'FAIL'}", flush=True)
        ok_all = ok_all and ok
    return ok_all


def check_small_sdxl():
    """The tiny SDXL geometry (both towers, micro-conditioning, bf16 UNet
    and VAE) on the card against the CPU, same weights and inputs, with
    heads = channels // 64: the UNet's and the VAE's attention run the
    flash kernel's wgmma instance at D = 64. Held as the default path is
    (``check_small_agreement``): against an fp32 CPU run of the same
    weights, the card strays no further than the CPU's own bf16 run does,
    plus 0.5 of a level on the mean and 2 levels at the max."""
    import dataclasses

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import test_sdxl_config
    from cassmantle_tpu_torch.ops import flash_attention
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

    fp32_cfg = with_unet(test_sdxl_config(), num_heads=None)
    m = fp32_cfg.models
    cfg = fp32_cfg.replace(models=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, dtype="bfloat16"),
        vae=dataclasses.replace(m.vae, dtype="bfloat16"),
        param_dtype="bfloat16"))
    cpu = SDXLPipeline(cfg, device="cpu")
    sd = {"clip_text": cpu.clip.state_dict(),
          "clip_text_2": cpu.clip2.state_dict(),
          "unet": cpu.unet.state_dict(), "vae": cpu.vae.state_dict()}
    gpu = SDXLPipeline(cfg, device="cuda", state_dicts=sd)
    fp32 = SDXLPipeline(fp32_cfg, device="cpu", state_dicts=sd)
    prompts = ["A watercolor style piece depicting: a lighthouse at dusk.",
               "A vaporwave style piece depicting: the comet market."]
    hw = cfg.sampler.image_size // cpu.vae_scale
    x_t = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (len(prompts), hw, hw, 4)).astype(np.float32))
    ref = fp32.generate(prompts, latents=x_t).astype(np.int32)
    d_cpu = np.abs(cpu.generate(prompts, latents=x_t).astype(np.int32) - ref)
    flash_attention.reset_counters()
    d_gpu = np.abs(gpu.generate(prompts, latents=x_t).astype(np.int32) - ref)
    paths = flash_path_totals(flash_attention.flash_attention.shape_paths)
    res = dict(card_vs_fp32_max=int(d_gpu.max()),
               card_vs_fp32_mean=float(d_gpu.mean()),
               cpu_bf16_vs_fp32_max=int(d_cpu.max()),
               cpu_bf16_vs_fp32_mean=float(d_cpu.mean()),
               card_decoded_finite=gpu.last_decoded_finite,
               flash_paths=paths)
    ok = (d_gpu.mean() <= d_cpu.mean() + 0.5
          and d_gpu.max() <= d_cpu.max() + 2 and gpu.last_decoded_finite
          and paths.get("wgmma", 0) > 0)
    print(f"[small] tiny geometry, sdxl, card vs CPU: {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


# [small] sampler cases: (name, sampler fields, the loop served, fused
# VAE); the tiny geometry's 4 steps unless named
SMALL_SAMPLERS = (
    ("encprop", dict(encprop=True, encprop_dense_steps=1), "encprop", True),
    ("deepcache", dict(deepcache=True), "deepcache", False),
    ("euler", dict(kind="euler"), "euler", False),
    ("dpmpp_2m", dict(kind="dpmpp_2m", num_steps=5), "dpmpp_2m", False),
    ("dpmpp_2m_deepcache", dict(kind="dpmpp_2m", num_steps=5,
                                deepcache=True), "deepcache", False),
    ("encprop_dpmpp_2m", dict(kind="dpmpp_2m", encprop=True,
                              encprop_dense_steps=1), "encprop", True),
    ("consistency", dict(consistency=True, num_steps=4), "consistency",
     False),
    ("img2img", dict(kind="ddim"), "ddim", True),
)


def check_small_samplers():
    """The tiny geometry (bf16 UNet and VAE) under every sampler loop but
    plain DDIM, on the card (graphed) and on the CPU from the same
    weights and inputs: encoder propagation (4 steps, stride 3, one
    dense key: key forwards at steps 0 and 1, one decoder-only forward
    for steps 2 and 3; the fused VAE decoder), DeepCache (two
    full/shallow pairs), Euler, DPM-Solver++(2M) (5 steps), DPM++ with
    DeepCache (two pairs and an unpaired step), encprop over DPM++, four
    consistency steps, and img2img (the fused VAE encoder, strength 0.6 of
    4 DDIM steps, seed 3, on a random uint8 image). Held as the default
    path is (``check_small_agreement``): against an fp32 CPU run of the
    same weights, the card strays no further than the CPU's own bf16 run
    does, plus 0.5 of a level on the mean and 2 levels at the max."""
    import dataclasses

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.ops import flash_attention, fused_conv
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

    prompts = ["A watercolor style piece depicting: a lighthouse at dusk.",
               "A vaporwave style piece depicting: the comet market."]
    ok_all = True
    for name, kw, mode, fused_vae in SMALL_SAMPLERS:
        cfgs = []
        for base in (tiny_bf16_config(), test_config()):
            m = base.models
            cfgs.append(base.replace(
                sampler=dataclasses.replace(base.sampler, **kw),
                models=dataclasses.replace(m, vae=dataclasses.replace(
                    m.vae, fused_conv=fused_vae))))
        cfg, fp32_cfg = cfgs
        cpu = Text2ImagePipeline(cfg, device="cpu")
        sd = {"clip_text": cpu.clip.state_dict(),
              "unet": cpu.unet.state_dict(), "vae": cpu.vae.state_dict()}
        if name == "img2img":
            sd["vae_enc"] = cpu._ensure_encoder().state_dict()
        gpu = Text2ImagePipeline(cfg, device="cuda", state_dicts=sd)
        fp32 = Text2ImagePipeline(fp32_cfg, device="cpu", state_dicts=sd)
        if name == "img2img":
            images = np.random.default_rng(12).integers(
                0, 256, (len(prompts), cfg.sampler.image_size,
                         cfg.sampler.image_size, 3), dtype=np.uint8)
            run = lambda p: p.generate_img2img(          # noqa: E731
                images, prompts, 0.6, seed=3)
        else:
            hw = cfg.sampler.image_size // cpu.vae_scale
            x_t = torch.from_numpy(np.random.default_rng(11).standard_normal(
                (len(prompts), hw, hw, 4)).astype(np.float32))
            run = lambda p: p.generate(prompts, latents=x_t)  # noqa: E731
        ref = run(fp32).astype(np.int32)
        d_cpu = np.abs(run(cpu).astype(np.int32) - ref)
        reset_all_counters()
        d_gpu = np.abs(run(gpu).astype(np.int32) - ref)
        graphs = (gpu.img2img_graphs if name == "img2img"
                  else gpu.step_graphs)
        res = dict(card_vs_fp32_max=int(d_gpu.max()),
                   card_vs_fp32_mean=float(d_gpu.mean()),
                   cpu_bf16_vs_fp32_max=int(d_cpu.max()),
                   cpu_bf16_vs_fp32_mean=float(d_cpu.mean()),
                   card_decoded_finite=gpu.last_decoded_finite,
                   sampler_mode=gpu.sampler_mode,
                   encprop_step_counts=gpu.encprop_counts,
                   graphs={str(k): sorted(g.graphs)
                           for k, g in graphs.items()},
                   flash_launches=flash_attention.flash_attention.launches,
                   fused_conv_launches=fused_conv.gn_silu_conv3x3.launches)
        ok = (d_gpu.mean() <= d_cpu.mean() + 0.5
              and d_gpu.max() <= d_cpu.max() + 2 and gpu.last_decoded_finite
              and gpu.sampler_mode == mode == cpu.sampler_mode
              and len(graphs) == 1
              and res["flash_launches"] > 0
              and (res["fused_conv_launches"] > 0) == fused_vae)
        print(f"[small] tiny geometry, {name}, card vs CPU: "
              f"{json.dumps(res)} -> {'pass' if ok else 'FAIL'}", flush=True)
        ok_all = ok_all and ok
    return ok_all


def check_jax_random():
    """``utils/jax_random.py`` on the card against the CPU: keys (PRNGKey,
    split, fold_in chains), bits and uniforms bit for bit; normals (XLA's
    erfinv polynomial over torch's log1p, which may round otherwise on
    the card) within 4 float32 ulps. One [jax_random] line."""
    import torch

    from cassmantle_tpu_torch.utils import jax_random as jr

    res, ok = {}, True
    for seed in (0, 1, 0x1C3, 2 ** 32 - 1):
        keys = {}
        for dev in ("cpu", "cuda"):
            key = jr.PRNGKey(seed, dev)
            chain = [key]
            for t in (999, 20):
                chain.append(jr.fold_in(chain[-1], t))
            chain += list(jr.split(chain[-1], 3))
            keys[dev] = torch.stack(chain)
        equal = torch.equal(keys["cpu"], keys["cuda"].cpu())
        ok = ok and equal
        for shape in ((7,), (2, 64, 64, 4), (1, 128, 128, 4)):
            k_cpu, k_gpu = keys["cpu"][-1], keys["cuda"][-1]
            bits = torch.equal(jr.random_bits(k_cpu, shape),
                               jr.random_bits(k_gpu, shape).cpu())
            uni = torch.equal(jr.uniform(k_cpu, shape, -1.0, 1.0),
                              jr.uniform(k_gpu, shape, -1.0, 1.0).cpu())
            n_cpu = jr.normal(k_cpu, shape)
            n_gpu = jr.normal(k_gpu, shape).cpu()
            ulps = (n_cpu.view(torch.int32).long()
                    - n_gpu.view(torch.int32).long()).abs()
            res[f"{seed}/{'x'.join(map(str, shape))}"] = dict(
                keys_equal=equal, bits_equal=bits, uniform_equal=uni,
                normal_max_ulps=int(ulps.max()),
                normal_values_differing=int((ulps > 0).sum()))
            ok = ok and bits and uni and int(ulps.max()) <= 4
    print(f"[jax_random] card vs CPU: {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


def check_small_mistral():
    """The tiny Mistral geometry (2 layers, 4 query and 2 KV heads of 16,
    window 16) on the card against the CPU from the same weights: in fp32
    (TF32 off) the greedy tokens of three prompts over two buckets are
    equal (the card's graphed decode); in bf16 the card's logits stray
    from the fp32 CPU logits (relative to their largest) no further than
    twice the CPU's own bf16 run does."""
    import dataclasses

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import MistralConfig, test_config
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    base = test_config()
    cfg32 = base.replace(models=dataclasses.replace(
        base.models, mistral=MistralConfig.tiny()))
    cfg16 = cfg32.replace(models=dataclasses.replace(
        cfg32.models, param_dtype="bfloat16", mistral=dataclasses.replace(
            MistralConfig.tiny(), dtype="bfloat16")))
    cpu = PromptGenerator(cfg32, device="cpu")
    sd = cpu.model.state_dict()
    gpu = PromptGenerator(cfg32, device="cuda", state_dict=sd)
    seeds = ["The Night the Trains Sang", "Chapter two: the harbor",
             "The comet market at dusk, where the archivists trade"]
    tok_c, len_c = cpu.decode_ids_batch(seeds)
    tok_g, len_g = gpu.decode_ids_batch(seeds)
    ids = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg32.models.mistral.vocab_size, (2, 24)))
    with torch.inference_mode():
        ref = cpu.model(ids)
        cpu16 = PromptGenerator(cfg16, device="cpu", state_dict=sd).model(ids)
        gpu16 = PromptGenerator(cfg16, device="cuda",
                                state_dict=sd).model(ids.cuda()).cpu()
    scale = float(ref.abs().max())
    d_cpu = (cpu16.float() - ref).abs() / scale
    d_gpu = (gpu16.float() - ref).abs() / scale
    res = dict(tokens_equal=bool(np.array_equal(tok_c, tok_g)
                                 and np.array_equal(len_c, len_g)),
               tokens=tok_g.shape[1],
               bf16_card_vs_fp32_max_rel=float(d_gpu.max()),
               bf16_card_vs_fp32_mean_rel=float(d_gpu.mean()),
               bf16_cpu_vs_fp32_max_rel=float(d_cpu.max()),
               bf16_cpu_vs_fp32_mean_rel=float(d_cpu.mean()))
    ok = (res["tokens_equal"] and d_gpu.max() <= 2 * d_cpu.max()
          and d_gpu.mean() <= 2 * d_cpu.mean())
    print(f"[small] tiny geometry, mistral, card vs CPU: {json.dumps(res)} "
          f"-> {'pass' if ok else 'FAIL'}", flush=True)
    return ok


def reset_all_counters() -> None:
    from cassmantle_tpu_torch.ops import flash_attention, fused_conv
    from cassmantle_tpu_torch.ops import quant_matmul

    flash_attention.reset_counters()
    fused_conv.reset_counters()
    quant_matmul.reset_counters()


def read_tallies() -> dict:
    """{kernel: Counter of launches per shape} as the counters stand, and
    under "flash_paths" the flash launches per (shape, kernel path)."""
    import collections

    from cassmantle_tpu_torch.ops.flash_attention import flash_attention
    from cassmantle_tpu_torch.ops.fused_conv import gn_silu_conv3x3
    from cassmantle_tpu_torch.ops.quant_matmul import (
        int8_conv3x3,
        int8_matmul,
    )

    tallies = {name: collections.Counter(fn.shapes) for name, fn in (
        ("flash_attention", flash_attention),
        ("gn_silu_conv3x3", gn_silu_conv3x3),
        ("int8_matmul", int8_matmul), ("int8_conv3x3", int8_conv3x3))}
    tallies["flash_paths"] = collections.Counter(flash_attention.shape_paths)
    return tallies


def flash_path_totals(shape_paths) -> dict:
    """{path: launches} from launches per (shape, path)."""
    totals = {}
    for (_, path), n in shape_paths.items():
        totals[path] = totals.get(path, 0) + n
    return totals


def round_flash_shapes(preset: str) -> dict:
    """{(B, Sq, Sk, H, D): launches} of flash attention in one round of
    ``preset``."""
    return {FLASH_SHAPES[name][:5]: n
            for name, n in ROUND_FLASH[PRESET_MODEL[preset]].items()}


def expected_tallies(preset: str) -> dict:
    """Launches per shape of one round of ``preset``, every kernel."""
    base = {"gn_silu_conv3x3": {}, "int8_matmul": {}, "int8_conv3x3": {},
            "flash_attention": round_flash_shapes(preset)}
    per_round = {s: n * UNET_FORWARDS for s, n in CONV_SHAPES.items()}
    if preset == "fusedconv":
        return {**base, "gn_silu_conv3x3": per_round}
    if preset == "encprop":     # the fused VAE decoder, once a round
        return {**base, "gn_silu_conv3x3": dict(VAE_CONV_SHAPES["sd15"])}
    if preset == "img2img":     # the fused VAE encoder and decoder
        return {**base, "gn_silu_conv3x3": dict(
            collections.Counter(VAE_CONV_SHAPES["sd15"])
            + collections.Counter(VAE_CONV_SHAPES["sd15_enc"]))}
    if preset == "w8a8":
        mm = {s: n * UNET_FORWARDS for s, n in UNET_MATMUL_SHAPES.items()}
        return {**base, "int8_conv3x3": per_round,
                "int8_matmul": {**mm, **LM_MATMUL_SHAPES}}
    return base


# replays a round's denoise makes of each captured body, by preset: the
# DDIM step 50 times; encprop's key step over the 5 dense keys and its
# segment (key forward, decoder-only forward, 3 updates) 15 times;
# DeepCache's full/shallow pair 25 times; DPM++'s step 25 times (fast),
# its pair 12 times (turbo); the consistency step 4 times; img2img's
# DDIM tail step 30 times
GRAPH_REPLAYS = {"encprop": {"key": 5, "segment": 15},
                 "deepcache": {"pair": 25}, "fast": {"step": 25},
                 "turbo": {"pair": 12}, "lcm": {"step": 4},
                 "img2img": {"step": 30}}
# the loop each preset's pipeline serves (Text2ImagePipeline.sampler_mode)
SAMPLER_MODE = {"encprop": "encprop", "deepcache": "deepcache",
                "fast": "dpmpp_2m", "turbo": "deepcache",
                "lcm": "consistency"}


def unet_forwards(replays: dict) -> dict:
    """UNet forwards by mode that a denoise's replays ran."""
    if "pair" in replays:
        return {"full": replays["pair"], "shallow": replays["pair"]}
    if "segment" in replays:
        return {"full": replays.get("key", 0) + replays["segment"],
                "decoder_only": replays["segment"]}
    return {"full": replays.get("step", 0)}


def run_round(card: str, preset: str, cfg, svc=None):
    """One full-width round of ``cfg`` through InferenceService (``svc``,
    or one built here) with every launch counter set to 0 just before it
    and read just after; returns the service, the tallies and the failed
    checks."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.serving.service import InferenceService

    t0 = time.perf_counter()
    if svc is None:
        svc = InferenceService(cfg)                 # device="cuda"
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if svc.table_stats and svc.table_stats["built"] and not TABLE_BUILD:
        TABLE_BUILD.update(svc.table_stats)
    pairs = [("lighthouse", "lighthouse"), ("crimson", "amber"),
             ("comet", "archive"), ("a quiet harbor", "harbor"),
             ("orchard", "an orchard at dusk"), ("teal", "silver"),
             ("Caravan", "caravan"), ("glacier", "canyon"),
             ("observatory", "station"), ("violet", "violet tune")]

    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()
    t0 = time.perf_counter()
    rc = asyncio.run(svc.generate_content("The Night the Trains Sang"))
    round_s = time.perf_counter() - t0
    replays = {name: g.replays for name, g in
               svc.backend.t2i.step_graphs[1].graphs.items()}
    t1 = time.perf_counter()
    sims = asyncio.run(svc.similarity(pairs))
    score_s = time.perf_counter() - t1
    blurred = {}
    t1 = time.perf_counter()
    for r in (0.0, 5.0, 15.0):
        blurred[r] = svc.blur(rc.image, r)
    blur_s = time.perf_counter() - t1
    tallies = read_tallies()

    t2i, gen = svc.backend.t2i, svc.backend.prompt_gen
    stages = {"decode": gen.last_seconds, **t2i.last_stage_seconds,
              "score": score_s, "blur": blur_s}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # a second round, warm, for the steady-state time
    t0 = time.perf_counter()
    rc2 = asyncio.run(svc.generate_content("Chapter two: the harbor"))
    warm_round_s = time.perf_counter() - t0
    warm_stages = {"decode": gen.last_seconds, **t2i.last_stage_seconds}

    img = rc.image
    launches = {k: sum(v.values()) for k, v in tallies.items()
                if k != "flash_paths"}
    flash_paths = flash_path_totals(tallies["flash_paths"])
    model = PRESET_MODEL[preset]
    checks = {
        "image_shape": img.shape == (cfg.sampler.image_size,) * 2 + (3,),
        "image_uint8": img.dtype == np.uint8,
        "decoded_finite": bool(t2i.last_decoded_finite),
        "image_not_constant": int(img.max()) > int(img.min()),
        "second_image_ok": rc2.image.shape == img.shape,
        "flash_launches": (launches["flash_attention"]
                           == sum(ROUND_FLASH[model].values())),
        "flash_paths": flash_paths == ROUND_FLASH_PATHS[model],
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
    for kernel, want in expected_tallies(preset).items():
        checks[f"{kernel}_launches_per_shape"] = dict(tallies[kernel]) == want
    mode = t2i.sampler_mode
    checks["sampler_mode"] = mode == SAMPLER_MODE.get(preset, "ddim")
    checks["graph_replays"] = replays == GRAPH_REPLAYS.get(preset,
                                                           {"step": 50})
    if preset in SAMPLER_FORWARDS:
        checks["unet_forwards"] = (unet_forwards(replays)
                                   == SAMPLER_FORWARDS[preset])
    checks["encprop_step_counts"] = t2i.encprop_counts == (
        (20, 0, 30) if mode == "encprop" else None)
    checks = {k: bool(v) for k, v in checks.items()}
    lm = lm_decode_times(gen) if preset == "mistral" else None
    report = dict(
        preset=preset, card=card, build_models_s=build_s, round_s=round_s,
        warm_round_s=warm_round_s, stages_s=stages,
        warm_stages_s=warm_stages, peak_gib=peak_gib, launches=launches,
        flash_paths=flash_paths,
        launches_per_shape={k: {"x".join(map(str, shape)): n
                                for shape, n in sorted(tallies[k].items())}
                            for k in ("flash_attention", "gn_silu_conv3x3")},
        sampler_mode=mode, graph_replays=replays,
        unet_forwards=unet_forwards(replays),
        encprop_step_counts=t2i.encprop_counts,
        text_fallbacks=svc.backend.text_fallbacks,
        prompt_text=rc.prompt_text, scores=[float(s) for s in sims],
        image_mean=float(img.mean()), image_std=float(img.std()),
        lm=lm, checks=checks)
    print(f"[round-{preset}] {json.dumps(report)}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    return svc, tallies, bad


def img2img_config():
    """``FrameworkConfig()`` (DDIM-50) with the VAE on the fused conv:
    img2img runs the encoder's and the decoder's ResBlocks on kernel 2."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig

    base = FrameworkConfig()
    return base.replace(models=dataclasses.replace(
        base.models, vae=dataclasses.replace(base.models.vae,
                                             fused_conv=True)))


def img2img_steps(cfg) -> int:
    """The tail's steps at IMG2IMG_STRENGTH, as generate_img2img takes
    them."""
    steps = cfg.sampler.num_steps
    return max(1, min(steps, int(round(IMG2IMG_STRENGTH * steps))))


def run_img2img(card: str, preset: str, cfg):
    """One full-width img2img call (``Text2ImagePipeline.
    generate_img2img``: the VAE encoder, the noised encoding, the last 30
    of DDIM's 50 steps, the decoder) on the image of a round served
    first, with every launch counter set to 0 just before it and read
    just after: flash at the UNet's shapes 30 times a forward's and at
    both VAE mid blocks, kernel 2 at the encoder's 20 and the decoder's
    28 ResBlock convs, the tail graph replayed 30 times. Returns the
    service, the tallies and the failed checks."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.serving.service import InferenceService

    t0 = time.perf_counter()
    svc = InferenceService(cfg)                     # device="cuda"
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    base = asyncio.run(svc.generate_content(
        "The Night the Trains Sang")).image[None]
    t2i = svc.backend.t2i
    prompt = ["A watercolor style piece depicting: the harbor at dawn."]
    k = img2img_steps(cfg)

    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()
    t0 = time.perf_counter()
    out = t2i.generate_img2img(base, prompt, IMG2IMG_STRENGTH, seed=1)
    round_s = time.perf_counter() - t0
    tallies = read_tallies()
    stages = dict(t2i.last_stage_seconds)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hw = cfg.sampler.image_size // t2i.vae_scale
    replays = {name: g.replays for name, g in
               t2i.img2img_graphs[k, (1, hw, hw, 4)].graphs.items()}
    t0 = time.perf_counter()
    out2 = t2i.generate_img2img(base, prompt, IMG2IMG_STRENGTH, seed=2)
    warm_s = time.perf_counter() - t0
    warm_stages = dict(t2i.last_stage_seconds)

    img = out[0]
    launches = {k_: sum(v.values()) for k_, v in tallies.items()
                if k_ != "flash_paths"}
    flash_paths = flash_path_totals(tallies["flash_paths"])
    checks = {
        "image_shape": out.shape == base.shape,
        "image_uint8": out.dtype == np.uint8,
        "decoded_finite": bool(t2i.last_decoded_finite),
        "image_not_constant": int(img.max()) > int(img.min()),
        "other_seed_differs": not np.array_equal(out2, out),
        "tail_steps": k == SAMPLER_FORWARDS["img2img"]["full"],
        "flash_launches": (launches["flash_attention"]
                           == sum(ROUND_FLASH["img2img"].values())),
        "flash_paths": flash_paths == ROUND_FLASH_PATHS["img2img"],
        "graph_replays": replays == GRAPH_REPLAYS["img2img"],
        "unet_forwards": unet_forwards(replays)
        == SAMPLER_FORWARDS["img2img"],
    }
    for kernel, want in expected_tallies("img2img").items():
        checks[f"{kernel}_launches_per_shape"] = dict(tallies[kernel]) == want
    checks = {k_: bool(v) for k_, v in checks.items()}
    report = dict(
        preset=preset, card=card, build_models_s=build_s,
        strength=IMG2IMG_STRENGTH, tail_steps=k, round_s=round_s,
        warm_round_s=warm_s, stages_s=stages, warm_stages_s=warm_stages,
        peak_gib=peak_gib, launches=launches, flash_paths=flash_paths,
        launches_per_shape={k_: {"x".join(map(str, shape)): n
                                 for shape, n in sorted(tallies[k_].items())}
                            for k_ in ("flash_attention", "gn_silu_conv3x3")},
        graph_replays=replays, unet_forwards=unet_forwards(replays),
        input_mean=float(base.mean()), image_mean=float(img.mean()),
        image_std=float(img.std()),
        mean_abs_change=float(np.abs(img.astype(np.int32)
                                     - base[0].astype(np.int32)).mean()),
        checks=checks)
    print(f"[round-img2img] {json.dumps(report)}", flush=True)
    bad = [k_ for k_, v in checks.items() if not v]
    return svc, tallies, bad


# profiler kernel names -> the kernel they belong to
KERNEL_PATTERNS = (
    ("flash_attention", re.compile(r"flash_wgmma_kernel|flash_fwd_kernel")),
    ("int8_matmul", re.compile(r"int8_matmul_wgmma_kernel")),
    ("int8_conv3x3", re.compile(r"int8_conv_wgmma_kernel")),
    ("gn_silu_conv3x3", re.compile(r"gn_conv_wgmma_kernel")),
)
# the wgmma kernels: no spills, and warpgroup MMA instructions in SASS
WGMMA_KERNELS = re.compile(r"int8_matmul_wgmma_kernel|gn_conv_wgmma_kernel"
                           r"|flash_wgmma_kernel|int8_conv_wgmma_kernel")


def kernel_build_report(libs) -> list:
    """One [ptxas] line per kernel of each library (registers, shared
    memory, spills, from the build's -Xptxas -v report) and, where the
    toolkit has cuobjdump, one [sass] line with its count of warpgroup
    MMA instructions (HGMMA, IGMMA). Fails if a wgmma kernel spills, if
    ptxas serialises its wgmma (an info line, C7510-C7520: each wgmma
    then waits for the last), or, with cuobjdump, if it issues no
    warpgroup MMA."""
    import os

    lines = []
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    for src, path in sorted(libs.items()):
        try:
            with open(path[:-3] + ".log") as f:
                log = f.read()
        except OSError:
            lines.append(f"[ptxas] {src}: report not kept (built before)")
            log = ""
        kernel = None
        for line in log.splitlines():
            m = re.search(r"wgmma\.mma_async instructions are serialized.*"
                          r"function '([^']+)'", line)
            if m and WGMMA_KERNELS.search(m.group(1)):
                fail(f"ptxas serialises the wgmma of {m.group(1)}: "
                     f"{line.strip()}")
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel, spill = m.group(1), ""
            elif kernel and "spill" in line:
                spill = line.strip()
            elif kernel and "Used" in line:
                used = line.split(":", 1)[1].strip()
                lines.append(f"[ptxas] {src} {kernel}: {used}; {spill}")
                if WGMMA_KERNELS.search(kernel) and not spill.startswith(
                        "0 bytes stack frame, 0 bytes spill stores, "
                        "0 bytes spill loads"):
                    fail(f"{kernel} spills: {spill}")
                kernel = None
        if not os.path.exists(cuobjdump):
            lines.append(f"[sass] {src}: cuobjdump not found, not counted")
            continue
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, timeout=300).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                counts[current] = 0
            elif current and re.search(r"\b[HI]GMMA\.", line):
                counts[current] += 1
        for kernel, n in sorted(counts.items()):
            lines.append(f"[sass] {src} {kernel}: {n} warpgroup MMA "
                         f"instructions (HGMMA/IGMMA)")
            if WGMMA_KERNELS.search(kernel) and n == 0:
                fail(f"{kernel} issues no wgmma")
    return lines


# host API calls that enqueue device work, copy between host and
# device, or wait for the device, as the profiler names them
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Launch)")
HOST_COPY = re.compile(r"^cu(da)?Memcpy")
HOST_SYNC = re.compile(r"^cu(da)?\w*Synchronize")


def trace_counts(prof, steps: int) -> dict:
    """From a profiler window over ``steps`` steps: the device's busy ms
    per step (the sum of its kernel and copy times: one stream, so they
    never overlap), its events (kernels and copies) per step, each
    kernel's ms and launches per step, the host's launch calls per step
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...), and its copy and
    synchronize calls that start between its first and last launch call
    (the window's own closing synchronize, and the profiler's, fall
    outside)."""
    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    host = [e for e in cpu if HOST_LAUNCH.search(e.name)]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    first = min((e.time_range.start for e in host), default=0)
    last = max((e.time_range.start for e in host), default=0)
    between = [e.name for e in cpu if first < e.time_range.start < last]
    out = {"device_busy_ms": busy_us / 1e3 / steps,
           "kernels_per_step": len(device) / steps,
           "host_launches_per_step": len(host) / steps,
           "host_launch_calls": dict(collections.Counter(
               e.name for e in host)),
           "host_copy_calls": sum(bool(HOST_COPY.search(n))
                                  for n in between),
           "host_sync_calls": sum(bool(HOST_SYNC.search(n))
                                  for n in between)}
    for kernel, pattern in KERNEL_PATTERNS:
        events = [e for e in device if pattern.search(e.name)]
        if events:
            us = sum(e.time_range.elapsed_us() for e in events)
            out[f"{kernel}_ms"] = us / 1e3 / steps
            out[f"{kernel}_share_of_busy"] = us / max(busy_us, 1e-9)
            out[f"{kernel}_launches_per_step"] = len(events) / steps
    return out


def device_profile():
    """``torch.profiler`` over the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile_replays(step, n: int, reset, dev, want=None, windows: int = 3):
    """``n`` replays of the captured ``step`` under ``torch.profiler``,
    after ``reset()`` and a sync: (trace counts, host ms per replay).
    ``want`` ({kernel: launches a replay}): while a kernel reads fewer
    (``replay_launches``), the window is profiled again, up to
    ``windows`` in all, and each such kernel's launches per replay is
    the most any window read; the other counts are the first window's.
    Every replay of a graph launches the same kernels and a dropped
    device record only lowers a window's count, so the most read is the
    truest (``witness_windows`` says how many windows were read)."""
    from cassmantle_tpu_torch.utils.device import synchronize

    counts = window_ms = None
    for tried in range(1, windows + 1):
        reset()
        synchronize(dev)
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step.replay()
            synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3 / n
        got = trace_counts(prof, n)
        if counts is None:
            counts, window_ms = got, ms
        for kernel in want or ():
            key = f"{kernel}_launches_per_step"
            if key in got:
                counts[key] = max(counts.get(key, 0), got[key])
        if all(replay_launches(counts, k) >= v
               for k, v in (want or {}).items()):
            break
    counts["witness_windows"] = tried
    return counts, window_ms


def replay_launches(counts: dict, kernel: str) -> int:
    """A kernel's launches per replay from a window of graph replays:
    every replay of a graph launches the same kernels, and the profiler
    at times drops a device record (on an H100, windows of 10 replays
    have read up to 6 events fewer than 10 times a replay's), so the
    window's count per replay rounds up. A replay that launched one
    kernel fewer would read a whole launch fewer, dropped records or
    not, as long as fewer than one a replay of the kernel's dropped."""
    return math.ceil(counts.get(f"{kernel}_launches_per_step", 0) - 1e-9)


def witness_want(preset: str) -> dict:
    """The kernels one CFG step of ``preset`` launches: the UNet's flash
    shapes (on the wgmma kernel), and the fused conv's or the int8
    kernels' sites."""
    model = PRESET_MODEL[preset]
    want = {"flash_attention": sum(
        n for name, n in ROUND_FLASH[model].items()
        if not name.startswith("vae")) // UNET_FORWARDS}
    if preset == "fusedconv":
        want["gn_silu_conv3x3"] = sum(CONV_SHAPES.values())
    if preset == "w8a8":
        want["int8_conv3x3"] = sum(CONV_SHAPES.values())
        want["int8_matmul"] = sum(UNET_MATMUL_SHAPES.values())
    return want


def graph_witness(counts: dict, preset: str) -> dict:
    """What the profiled graph replays launched against what one CFG
    step of ``preset`` launches (``witness_want``), and that no host
    copy or synchronize call sat between the replays."""
    want = witness_want(preset)
    seen = {k: replay_launches(counts, k) for k in want}
    quiet = counts["host_copy_calls"] == counts["host_sync_calls"] == 0
    return {"want_per_step": want, "seen_per_step": seen,
            "host_copy_calls": counts["host_copy_calls"],
            "host_sync_calls": counts["host_sync_calls"],
            "ok": seen == want and quiet}


def profile_denoise(svc, preset: str, steps: int = 2,
                    replays: int = 10) -> dict:
    """Where a denoise step's time goes, at full width, for the step the
    pipeline serves (a replay of its captured CFG DDIM step) and, beside
    it, for the eager step it replaces:

    - served: host ms per step over a whole 50-step graphed denoise (no
      profiler attached, ending in a sync), then ``replays`` replays
      under ``torch.profiler`` (``profile_replays``) for the device's
      busy time, the idle share (against the unprofiled wall, and
      against the profiled window's, which carries the first launch's
      latency and the closing sync), the device's kernels per step, the
      host's launch calls per step, each kernel's part, and the witness
      that the replays launched the kernels (``graph_witness``);
    - eager: the same readings for ``steps`` eager CFG UNet steps
      (``eager_*``);
    - the step's bound: aten's FLOP count at the bf16 peak plus the
      kernels' own work (the counter cannot see inside them): attention
      and the fused conv at the bf16 peak, the int8 products at the int8
      peak;
    - the eager stages around the loop: device kernels and host launch
      calls of the CLIP encode and of the VAE decode."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from cassmantle_tpu_torch.models.vae import postprocess_images
    from cassmantle_tpu_torch.ops.ddim import cfg_inputs, make_cfg_denoiser
    from cassmantle_tpu_torch.utils.device import synchronize

    t2i = svc.backend.t2i
    dev = t2i.device
    s = t2i.cfg.sampler
    hw = s.image_size // t2i.vae_scale
    ts = torch.from_numpy(t2i.schedule.timesteps.astype("int32")).to(dev)
    timesteps = [ts[i:i + 1] for i in range(steps)]
    with torch.inference_mode():
        cond = t2i.encode(["a lighthouse at dusk"])
        inputs = cfg_inputs(**cond)
        denoise = make_cfg_denoiser(
            t2i.unet, guidance_scale=s.guidance_scale, **cond)
        gen = torch.Generator(dev).manual_seed(3)
        x = torch.randn((1, hw, hw, 4), generator=gen, device=dev)

        def eager():
            for t in timesteps:
                denoise(x, t)
            synchronize(dev)

        eager()                                       # warm
        t0 = time.perf_counter()
        eager()
        eager_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with device_profile() as prof:
            t0 = time.perf_counter()
            eager()
            eager_window_ms = (time.perf_counter() - t0) * 1e3 / steps
        eager_counts = trace_counts(prof, steps)

        graph = t2i.step_graphs[1]                    # the round's
        graph(x, **inputs)                            # warm
        synchronize(dev)
        t0 = time.perf_counter()
        final = graph(x, **inputs)
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / graph.num_steps
        replays = min(replays, graph.num_steps)
        counts, window_ms = profile_replays(
            graph.graph, replays, lambda: graph.reset(x), dev,
            want=witness_want(preset))

        with device_profile() as prof:
            t2i.encode(["a lighthouse at dusk"])
            synchronize(dev)
        clip = trace_counts(prof, 1)
        with device_profile() as prof:
            postprocess_images(t2i.vae(final))
            synchronize(dev)
        vae = trace_counts(prof, 1)

        reset_all_counters()
        with FlopCounterMode(display=False) as counter:
            denoise(x, timesteps[0])
        t = read_tallies()
        bf16_flops = counter.get_total_flops() + sum(
            n * 4 * b * h * sq * sk * d
            for (b, sq, sk, h, d), n in t["flash_attention"].items()) + sum(
            n * 18 * b * h * w * c * f
            for (b, h, w, c, f), n in t["gn_silu_conv3x3"].items())
        int8_ops = sum(n * 2 * m * k * nn
                       for (m, k, nn), n in t["int8_matmul"].items()) + sum(
            n * 18 * b * h * w * c * f
            for (b, h, w, c, f), n in t["int8_conv3x3"].items())
    bound_ms = (bf16_flops / PEAK_BF16_FLOPS
                + int8_ops / PEAK_INT8_OPS) * 1e3
    report = {"step_wall_ms": wall_ms, "eager_step_wall_ms": eager_wall_ms,
              "step_bf16_tflop": bf16_flops / 1e12,
              "step_int8_tops": int8_ops / 1e12, "step_bound_ms": bound_ms,
              "bound_share_of_wall": bound_ms / wall_ms}
    if not eager_counts["kernels_per_step"] or not counts["kernels_per_step"]:
        # the profiler saw no device work: no busy time, and no witness
        return {**report, "device_busy_ms": "not measured",
                "graph_witness": {"ok": False, "seen": "no device events"}}
    # idle share against the unprofiled wall (clamped at 0: the traced
    # kernels run a little longer than untraced ones), and unclamped
    # against the profiled window's own wall
    busy = counts["device_busy_ms"]
    report.update(counts, idle_share=max(0.0, 1.0 - busy / wall_ms),
                  window_wall_ms=window_ms,
                  window_idle_share=1.0 - busy / window_ms,
                  bound_share_of_busy=bound_ms / busy,
                  graph_witness=graph_witness(counts, preset))
    report.update({f"eager_{k}": v for k, v in eager_counts.items()})
    eager_busy = eager_counts["device_busy_ms"]
    report.update(
        eager_idle_share=max(0.0, 1.0 - eager_busy / eager_wall_ms),
        eager_window_wall_ms=eager_window_ms,
        eager_window_idle_share=1.0 - eager_busy / eager_window_ms)
    report.update({f"clip_{k}": clip[k] for k in (
        "kernels_per_step", "host_launches_per_step", "device_busy_ms")})
    report.update({f"vae_{k}": vae[k] for k in (
        "kernels_per_step", "host_launches_per_step", "device_busy_ms")})
    return report


# flash launches per replay of each captured body of a graphed loop: a
# step (one full forward); encprop's key forward, and its key forward and
# decoder-only one; DeepCache's full forward and shallow one, and the
# unpaired full step that ends an odd DPM++ count
BODY_FLASH = {"step": 32, "key": 32, "segment": 32 + 18, "pair": 32 + 10,
              "tail": 32}


def profile_loop(svc, preset: str, replays: int = 5) -> dict:
    """Where a graphed loop's time goes, at full width (the encprop,
    DeepCache, fast, turbo and lcm denoise, and img2img's tail): host ms
    of a whole graphed loop (no profiler attached, ending in a sync); for
    each captured body, ``replays`` replays from its first step under
    ``torch.profiler`` (``profile_replays``): host ms, device busy ms,
    device kernels and host launch calls per replay, each kernel's part,
    and the witness that a replay launches the body's flash kernels with
    no host copy or synchronize call between the replays; the loop's busy
    ms (each body's busy ms x its replays in a loop) and idle share; the
    eager VAE decode's kernels, busy ms and fused-conv part, and for
    img2img the eager VAE encoder's."""
    import torch

    from cassmantle_tpu_torch.models.vae import postprocess_images
    from cassmantle_tpu_torch.ops.ddim import cfg_inputs
    from cassmantle_tpu_torch.utils import jax_random
    from cassmantle_tpu_torch.utils.device import synchronize

    t2i = svc.backend.t2i
    dev = t2i.device
    size = t2i.cfg.sampler.image_size
    hw = size // t2i.vae_scale
    report = {"bodies": {}}
    busy_ms, witness_ok = 0.0, True
    with torch.inference_mode():
        inputs = cfg_inputs(**t2i.encode(["a lighthouse at dusk"]))
        x = torch.randn((1, hw, hw, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        graph = (t2i.img2img_graphs[img2img_steps(t2i.cfg), tuple(x.shape)]
                 if preset == "img2img" else t2i.step_graphs[1])
        graph(x, **inputs)                            # warm
        synchronize(dev)
        t0 = time.perf_counter()
        final = graph(x, **inputs)
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        for name, count, start, g in graph.phases:
            n = min(replays, count)
            counts, window_ms = profile_replays(
                g, n, lambda start=start: graph.reset(x, start), dev,
                want={"flash_attention": BODY_FLASH[name]})
            if not counts["kernels_per_step"]:
                return {**report, "device_busy_ms": "not measured",
                        "graph_witness": {"ok": False,
                                          "seen": "no device events"}}
            witness = {
                "want_flash_per_replay": BODY_FLASH[name],
                "seen_flash_per_replay": replay_launches(
                    counts, "flash_attention"),
                "host_copy_calls": counts["host_copy_calls"],
                "host_sync_calls": counts["host_sync_calls"]}
            witness["ok"] = (witness["want_flash_per_replay"]
                             == witness["seen_flash_per_replay"]
                             and counts["host_copy_calls"]
                             == counts["host_sync_calls"] == 0)
            witness_ok = witness_ok and witness["ok"]
            busy_ms += count * counts["device_busy_ms"]
            report["bodies"][name] = {
                "replays_a_denoise": count, "window_host_ms": window_ms,
                **{k: v for k, v in counts.items()
                   if k != "host_launch_calls"},
                "graph_witness": witness}
        with device_profile() as prof:
            postprocess_images(t2i.vae(final))
            synchronize(dev)
        vae = trace_counts(prof, 1)
        if preset == "img2img":
            images = torch.rand((1, size, size, 3), device=dev,
                                generator=torch.Generator(dev).manual_seed(4))
            key = jax_random.PRNGKey(0, dev)
            t2i.vae_enc(images * 2.0 - 1.0, key)        # warm
            synchronize(dev)
            with device_profile() as prof:
                t2i.vae_enc(images * 2.0 - 1.0, key)
                synchronize(dev)
            enc = trace_counts(prof, 1)
            report.update({f"vae_encoder_{k}": v for k, v in enc.items()
                           if k != "host_launch_calls"})
    report.update(
        denoise_wall_ms=wall_ms, denoise_busy_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        graph_witness={"ok": witness_ok},
        **{f"vae_{k}": v for k, v in vae.items()
           if k != "host_launch_calls"})
    return report


def check_graphs(svc, preset: str, card: str) -> bool:
    """The served graphs against the eager steps they replace, on the
    card at full width: the final latents of a whole graphed denoise (for
    img2img its 30-step tail) against the eager step loop on the same
    x_T and conditioning (bit-equal), and for the default, W8A8 and
    Mistral presets the 96
    greedy decode tokens of one prompt (batch bucket 1, prompt bucket 32),
    graphed against eager (equal); with each graph's capture and
    instantiate seconds and its pool's bytes. One [graphs] line."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.utils.device import synchronize

    t2i, gen = svc.backend.t2i, svc.backend.prompt_gen
    dev = t2i.device
    s = t2i.cfg.sampler
    hw = s.image_size // t2i.vae_scale
    if preset == "img2img":
        k = img2img_steps(t2i.cfg)
        loop = lambda x, cond, graphed: t2i.img2img_tail(   # noqa: E731
            x, cond, k, graphed=graphed)
        graphs = {f"{key[1][0]}/tail{key[0]}/{name}": g
                  for key, sg in t2i.img2img_graphs.items()
                  for name, g in sg.graphs.items()}
    else:
        loop = t2i.denoise
        graphs = {f"{b}/{name}": g for b, sg in t2i.step_graphs.items()
                  for name, g in sg.graphs.items()}
    with torch.inference_mode():
        cond = t2i.encode(["A watercolor style piece depicting: a "
                           "lighthouse at dusk."])
        x = torch.randn((1, hw, hw, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        t0 = time.perf_counter()
        eager = loop(x, cond, graphed=False)
        synchronize(dev)
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graphed = loop(x, cond, graphed=True)
        synchronize(dev)
        graphed_s = time.perf_counter() - t0
        diff = (eager - graphed).abs()
    res = {"card": card, "denoise_bit_equal": bool(torch.equal(eager,
                                                              graphed)),
           "denoise_max_abs_diff": diff.max().item(),
           "denoise_values_differing": int((diff > 0).sum().item()),
           "denoise_finite": bool(torch.isfinite(graphed).all()),
           "denoise_eager_s": eager_s, "denoise_graphed_s": graphed_s,
           "denoise_graphs": {name: g.stats() for name, g in graphs.items()}}
    ok = res["denoise_bit_equal"] and res["denoise_finite"]
    if preset in ("default", "w8a8", "mistral", "weights"):
        seed = ["The Night the Trains Sang"]
        t0 = time.perf_counter()
        tok_e, len_e = gen.decode_ids_batch(seed, graphed=False)
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok_g, len_g = gen.decode_ids_batch(seed, graphed=True)
        graphed_s = time.perf_counter() - t0
        equal = (np.array_equal(tok_e, tok_g)
                 and np.array_equal(len_e, len_g))
        res.update(decode_tokens_equal=equal, decode_tokens=tok_g.shape[1],
                   decode_eager_s=eager_s, decode_graphed_s=graphed_s,
                   decode_graphs={str(k): st.graph.stats()
                                  for k, st in gen.decode_graphs.items()
                                  if st.graph is not None})
        ok = ok and equal
    print(f"[graphs] {preset}: {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


LM_TEXT = "The Night the Trains Sang"
SPEC_GAMMA = 4


def mistral_config():
    """``FrameworkConfig()`` with Mistral-7B as the prompt LM, as the
    reference server's ``--lm mistral`` builds it."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig, MistralConfig

    base = FrameworkConfig()
    return base.replace(models=dataclasses.replace(
        base.models, mistral=MistralConfig()))


def lm_inputs(gen, text: str = LM_TEXT):
    """One prompt as ``PromptGenerator.decode_ids_batch`` lays it out at
    batch 1: (ids (1, bucket), prompt_len (1,)) on the card, and EOS."""
    import numpy as np
    import torch

    m, tok = gen.mcfg, gen.tokenizer
    max_new = gen.cfg.sampler.max_new_tokens
    toks = tok.encode(text)
    bucket = gen._bucket_for(len(toks), max_new, m.max_positions - max_new - 1)
    ids = np.full((1, bucket), tok.pad_id % m.vocab_size, dtype=np.int64)
    ids[0, :len(toks)] = np.asarray(toks) % m.vocab_size
    eos = tok.eos_id if tok.eos_id < m.vocab_size else m.vocab_size
    return (torch.from_numpy(ids).cuda(), torch.tensor([len(toks)]).cuda(),
            eos)


def lm_decode_state(gen, ids):
    """The captured greedy decode state the round's prompt decode made."""
    return next(s for k, s in gen.decode_graphs.items()
                if k[:2] == tuple(ids.shape) and k[4] == 0.0
                and s.graph is not None)


def lm_decode_times(gen, reps: int = 5) -> dict:
    """The prompt LM at full width, after a round: its build seconds and
    parameter bytes; the eager prefill of the round's prompt (bucket 32)
    and the graphed greedy decode, ms per token over the 95 replays of a
    decode, between CUDA events; beside it the weight-read bound, the
    parameter bytes at the card's memory rate."""
    import torch

    ids, lens, _ = lm_inputs(gen)
    state = lm_decode_state(gen, ids)
    steps = state.max_new - 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        state.start(ids, lens)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            state.start(ids, lens)
        end.record()
        torch.cuda.synchronize()
        prefill_ms = start.elapsed_time(end) / reps
        start.record()
        for _ in range(steps):
            state.graph.replay()
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / steps
    bound_ms = gen.param_bytes / PEAK_BYTES_PER_S * 1e3
    return {"build_s": gen.build_seconds, "param_bytes": gen.param_bytes,
            "params": sum(p.numel() for p in gen.model.parameters()),
            "prefill_ms": prefill_ms, "prompt_bucket": ids.shape[1],
            "decode_ms_per_token": step_ms,
            "weight_read_bound_ms_per_token": bound_ms,
            "decode_x_bound": step_ms / bound_ms,
            "decode_steps_s": step_ms * steps / 1e3}


def profile_decode(svc, replays: int = 10) -> dict:
    """Where a graphed decode step of the prompt LM goes, at full width:
    host ms per step over a whole graphed decode (no profiler, ending in a
    sync), then ``replays`` replays under ``torch.profiler`` for the
    device's busy ms, idle share and kernels a step; the fp32 LM head
    alone (``_logits`` on one bf16 hidden row, CUDA events) and its
    share of the busy time; the weight-read bound. The witness: a
    replay is one ``cudaGraphLaunch``, with no host copy or synchronize
    between replays."""
    import torch

    from cassmantle_tpu_torch.utils.device import synchronize

    gen = svc.backend.prompt_gen
    dev = gen.device
    ids, lens, _ = lm_inputs(gen)
    state = lm_decode_state(gen, ids)
    steps = state.max_new - 1
    with torch.inference_mode():
        state.start(ids, lens)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state.graph.replay()
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        counts, window_ms = profile_replays(
            state.graph, replays, lambda: state.start(ids, lens), dev)
        hidden = torch.randn((1, 1, gen.mcfg.hidden_size), device=dev,
                             dtype=torch.bfloat16)
        head_ms = time_ms(lambda: gen.model._logits(hidden), 20)
    bound_ms = gen.param_bytes / PEAK_BYTES_PER_S * 1e3
    report = {"step_wall_ms": wall_ms, "window_wall_ms": window_ms,
              "weight_read_bound_ms": bound_ms, "lm_head_ms": head_ms}
    if not counts["kernels_per_step"]:
        return {**report, "device_busy_ms": "not measured",
                "graph_witness": {"ok": False, "seen": "no device events"}}
    busy = counts["device_busy_ms"]
    witness = {"host_launch_calls": counts["host_launch_calls"],
               "host_copy_calls": counts["host_copy_calls"],
               "host_sync_calls": counts["host_sync_calls"]}
    witness["ok"] = (set(counts["host_launch_calls"]) == {"cudaGraphLaunch"}
                     and counts["host_launches_per_step"] == 1
                     and counts["host_copy_calls"] == 0
                     and counts["host_sync_calls"] == 0)
    report.update(counts, idle_share=max(0.0, 1.0 - busy / wall_ms),
                  window_idle_share=1.0 - busy / window_ms,
                  lm_head_share_of_busy=head_ms / busy,
                  busy_x_bound=busy / bound_ms, graph_witness=witness)
    return report


class ChunkRecorder:
    """A target LM whose ``decode_chunk`` logits (and prefill logits, as
    the chunk before the first) are kept with their first cache
    position: what a speculative decode saw at every position it
    verified. Eager only (it reads the position on the host)."""

    def __init__(self, model):
        self.model, self.cfg, self.chunks = model, model.cfg, []

    def new_cache(self, *args):
        return self.model.new_cache(*args)

    def prefill(self, ids, lens, max_len, cache=None):
        logits, cache = self.model.prefill(ids, lens, max_len, cache)
        self.chunks.append((ids.shape[1] - 1, logits[:, None].clone()))
        return logits, cache

    def decode_step(self, *args):
        return self.model.decode_step(*args)

    def decode_chunk(self, tokens, index, cache, valid):
        logits, cache = self.model.decode_chunk(tokens, index, cache, valid)
        self.chunks.append((int(index.reshape(-1)[0]), logits.clone()))
        return logits, cache

    def logits_at(self, position: int):
        """The logits the decode committed from at cache ``position``: the
        last forward that started at or before it."""
        first, logits = [c for c in self.chunks if c[0] <= position][-1]
        return logits[:, position - first]


def stepped_logits(model, ids, lens, tokens, col: int, chunk_width: int,
                   max_len: int):
    """Greedy's chain re-fed one ``decode_step`` at a time over a cache of
    ``max_len`` positions: the logits that picked token ``col``; and a
    ``decode_chunk`` of the ``chunk_width`` tokens before it over that
    same cache, that position's logits again (the chunk's own drift,
    without the chunk-written history of a speculative decode)."""
    import torch

    p = ids.shape[1]
    pos = torch.arange(max_len, device=ids.device)[None, :]
    prompt_valid = pos < lens[:, None]
    with torch.inference_mode():
        logits, cache = model.prefill(ids, lens, max_len)
        stepped = logits
        for j in range(col):
            valid = prompt_valid | ((pos >= p) & (pos <= p + j))
            stepped, cache = model.decode_step(tokens[:, j].long(), p + j,
                                               cache, valid)
        w = min(chunk_width, col)
        chunk_last = stepped
        if w:
            valid = prompt_valid | ((pos >= p) & (pos <= p + col - 1))
            chunk, _ = model.decode_chunk(tokens[:, col - w:col].long(),
                                          p + col - w, cache, valid)
            chunk_last = chunk[:, -1]
    return stepped.float(), chunk_last.float()


def spec_against_greedy(name, model, draft, ids, lens, eos, graphs,
                        spec_graphs):
    """One speculative decode (gamma 4, graphed) against the plain greedy
    decode (graphed) of the same model and prompt, each run twice and
    timed warm; then the same speculative decode eagerly, its verify
    logits recorded (``ChunkRecorder``; its tokens must equal the graphed
    run's). At the first token where greedy and speculative decode part
    (else at the last), the drift between the two forwards that chose it:
    max |verify logits - greedy's stepped logits| of that row. A
    divergence whose greedy top-2 gap exceeds twice that drift fails: two
    forwards that round apart can swap two logits at most twice their
    drift apart, so a wider gap means a fault, not rounding. Returns the
    report and the speculative tokens."""
    import torch

    from cassmantle_tpu_torch.ops.decode import (
        greedy_decode,
        speculative_decode,
    )

    max_new = 96
    p = ids.shape[1]
    times = {}
    with torch.inference_mode():
        for kind, run in (
                ("greedy", lambda: greedy_decode(
                    model, ids, lens, max_new, eos, graphs=graphs)),
                ("spec", lambda: speculative_decode(
                    model, ids, lens, max_new, eos, SPEC_GAMMA, draft,
                    graphs=spec_graphs))):
            for attempt in ("cold", "warm"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                times[f"{kind}_{attempt}_s"] = time.perf_counter() - t0
            times[kind] = out
        (g_tok, g_len), (s_tok, s_len, stats) = times.pop("greedy"), \
            times.pop("spec")
        recorder = ChunkRecorder(model)
        e_tok, _, e_stats = speculative_decode(
            recorder, ids, lens, max_new, eos, SPEC_GAMMA, draft,
            graphed=False)
    state = next(s for k, s in spec_graphs.items()
                 if k[:3] == (1, p, max_new) and k[5] == draft)
    chunks, drafted, accepted = stats.tolist()
    differ = (g_tok != s_tok).nonzero().tolist()
    row, col = differ[0] if differ else (0, max_new - 1)
    greedy_logits, chunk_logits = stepped_logits(
        model, ids, lens, g_tok, col, SPEC_GAMMA + 1, p + max_new)
    # the same steps over the speculative decode's longer cache (its
    # scratch tail of gamma + 1 positions)
    long_logits, _ = stepped_logits(model, ids, lens, g_tok, col,
                                    SPEC_GAMMA + 1,
                                    p + max_new + SPEC_GAMMA + 1)
    spec_logits = recorder.logits_at(p + col - 1).float()
    top2 = greedy_logits[row].topk(2).values
    res = {"tokens_equal": not differ,
           "lengths_equal": bool(torch.equal(g_len, s_len)),
           "tokens_agreeing": int((g_tok == s_tok).sum()),
           "first_divergence": differ[0] if differ else None,
           "eager_spec_equals_graphed": bool(torch.equal(e_tok, s_tok)
                                             and torch.equal(e_stats, stats)),
           "drift_at_step": col,
           "verify_vs_step_drift": float(
               (spec_logits[row] - greedy_logits[row]).abs().max()),
           "same_cache_chunk_vs_step_drift": float(
               (chunk_logits[row] - greedy_logits[row]).abs().max()),
           "longer_cache_step_drift": float(
               (long_logits[row] - greedy_logits[row]).abs().max()),
           "greedy_top2_gap": float(top2[0] - top2[1]),
           "chunks": chunks, "drafted": drafted, "accepted": accepted,
           "accept_rate": accepted / drafted if drafted else 0.0,
           "tokens_per_chunk": max_new / chunks,
           "host_reads": state.host_reads, **times,
           "spec_over_greedy": times["spec_warm_s"] / times["greedy_warm_s"]}
    res["ok"] = res["eager_spec_equals_graphed"] and (
        not differ
        or res["greedy_top2_gap"] <= 2 * res["verify_vs_step_drift"])
    print(f"[spec] {name}: {json.dumps(res)} -> "
          f"{'pass' if res['ok'] else 'FAIL'}", flush=True)
    return res, s_tok


def check_spec(svc) -> bool:
    """Three speculative decodes, each against plain greedy decode on the
    same model and prompt (``spec_against_greedy``):
    ``spec_decode_serving_config()`` (GPT-2-small, n-gram draft, gamma 4;
    its serving path, ``decode_ids_batch``, must take the speculative
    branch and give the same tokens); Mistral-7B (the round's model) with
    the n-gram draft; Mistral-7B with a GPT-2-small draft at vocabulary
    32,000 (``ModelDraft``, seeded random weights, bf16)."""
    import dataclasses

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import (
        GPT2Config,
        spec_decode_serving_config,
    )
    from cassmantle_tpu_torch.models.gpt2 import GPT2LM
    from cassmantle_tpu_torch.ops.decode import ModelDraft, NgramDraft
    from cassmantle_tpu_torch.serving.pipeline import (
        PromptGenerator,
        build_model,
    )

    ok = True
    cfg = spec_decode_serving_config()
    gen = PromptGenerator(cfg)
    ids, lens, eos = lm_inputs(gen)
    res, spec_tok = spec_against_greedy(
        "gpt2 spec_decode_serving_config (ngram)", gen.model, gen.spec_draft,
        ids, lens, eos, gen.decode_graphs, gen.spec_graphs)
    served, _ = gen.decode_ids_batch([LM_TEXT])
    served_ok = (gen.last_spec_stats is not None
                 and np.array_equal(served, spec_tok.cpu().numpy()))
    print(f"[spec] gpt2 serving path: spec branch taken "
          f"{gen.last_spec_stats is not None}, stats {gen.last_spec_stats}, "
          f"tokens equal the decode above {served_ok}", flush=True)
    ok = ok and res["ok"] and served_ok
    del gen
    gc.collect()
    torch.cuda.empty_cache()

    lm = svc.backend.prompt_gen
    ids, lens, eos = lm_inputs(lm)
    spec_graphs = {}
    res, _ = spec_against_greedy("mistral-7b ngram", lm.model,
                                 NgramDraft(ngram=cfg.spec_decode.ngram), ids,
                                 lens, eos, lm.decode_graphs, spec_graphs)
    ok = ok and res["ok"]
    dev = lm.device
    with torch.device(dev):
        draft = build_model(GPT2LM(dataclasses.replace(
            GPT2Config(), vocab_size=lm.mcfg.vocab_size)), "gpt2_draft", dev,
            0, storage_dtype=torch.bfloat16)
    res, _ = spec_against_greedy(
        "mistral-7b gpt2-small draft (vocab 32000)", lm.model,
        ModelDraft(draft), ids, lens, eos, lm.decode_graphs, spec_graphs)
    ok = ok and res["ok"]
    del draft, spec_graphs
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def check_sampled(svc) -> bool:
    """Mistral-7B top-k sampled decode (temperature 0.7, top_k 40): the
    graphed decode equals the eager one for the same generator seed (the
    noise is drawn outside the graph), a second seed samples otherwise,
    and every token up to and with the first EOS lies in its step's top
    40 (the chain re-fed one eager step at a time)."""
    import torch

    from cassmantle_tpu_torch.ops.decode import greedy_decode

    lm = svc.backend.prompt_gen
    model, dev = lm.model, lm.device
    ids, lens, eos = lm_inputs(lm)
    p, max_new, temp, top_k = ids.shape[1], 96, 0.7, 40
    graphs = {}

    def run(graphed, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_decode(model, ids, lens, max_new, eos, graphs=graphs,
                            graphed=graphed, temperature=temp, top_k=top_k,
                            generator=gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        (eager, n_eager), eager_s = run(False, 7)
        (cold, _), cold_s = run(True, 7)
        (warm, n_warm), warm_s = run(True, 7)
        (other, _), _ = run(True, 8)
        n_check = min(int(n_warm[0]) + 1, max_new)
        pos = torch.arange(p + max_new, device=dev)[None, :]
        logits, cache = model.prefill(ids, lens, p + max_new)
        in_top_k = 0
        for j in range(n_check):
            top = logits.topk(top_k, dim=-1).indices
            in_top_k += int((top == warm[:, j:j + 1].long()).any())
            valid = (pos < lens[:, None]) | ((pos >= p) & (pos <= p + j))
            logits, cache = model.decode_step(warm[:, j].long(), p + j,
                                              cache, valid)
    res = {"graphed_equals_eager": bool(torch.equal(eager, cold)
                                        and torch.equal(eager, warm)
                                        and torch.equal(n_eager, n_warm)),
           "other_seed_differs": not bool(torch.equal(other, warm)),
           "checked_tokens": n_check, "in_top_k": in_top_k,
           "gen_len": int(n_warm[0]), "distinct_tokens": int(
               warm.unique().numel()),
           "eager_s": eager_s, "graphed_cold_s": cold_s,
           "graphed_warm_s": warm_s}
    ok = (res["graphed_equals_eager"] and res["other_seed_differs"]
          and in_top_k == n_check)
    print(f"[sampled] mistral-7b T {temp} top_k {top_k}: {json.dumps(res)} "
          f"-> {'pass' if ok else 'FAIL'}", flush=True)
    del graphs
    return ok


# -- the serving seam ([serve], [serve-sdxl]) ---------------------------------

SERVE_GUESSES = 1024
SERVE_ANSWERS = ("lighthouse", "harbor", "comet", "orchard")
SERVE_SEEDS = ("The Night the Trains Sang", "A Winter Without Clocks",
               "Salt Roads and Silver Rivers", "Keeper of the Paper Storms")
SERVE_PROMPT = "A watercolor style piece depicting: a lighthouse at dusk."
# the table build of the first service built here (a later one loads
# the cached file): seconds, bytes, rows
TABLE_BUILD = {}
# [serve]'s device-loss drill on the seeded service: its image of
# SERVE_PROMPT at seed 7 (which the service from files must not give) and
# the rise of max_memory_allocated across its recovery
SERVE_DRILL = {}


def oov_pairs(tag: str, n: int = SERVE_GUESSES) -> list:
    """n one-pair guesses no table holds and no LRU has seen."""
    return [(f"{tag}{i}q{i * 7919 % 104729}x", SERVE_ANSWERS[i % 4])
            for i in range(n)]


def latency_ms(lat: list) -> dict:
    """Percentiles of the served guesses' seconds (None: a guess the
    adaptive admission shed, a 503 with Retry-After to its player)."""
    import numpy as np

    served = [t for t in lat if t is not None]
    out = {"n": len(served), "shed": len(lat) - len(served)}
    if served:
        ms = np.asarray(served) * 1e3
        out.update(p50_ms=float(np.percentile(ms, 50)),
                   p99_ms=float(np.percentile(ms, 99)),
                   max_ms=float(ms.max()))
    return out


def timings_now() -> dict:
    """{histogram: (count, sum of seconds)} of the metrics registry."""
    from cassmantle_tpu_torch.utils.logging import metrics

    return {k: (v["count"], v["count"] * v["mean_s"])
            for k, v in metrics.snapshot()["timings"].items()}


def mean_since(before: dict, name: str):
    """Mean seconds of ``name``'s observations since ``before``."""
    n0, s0 = before.get(name, (0, 0.0))
    n1, s1 = timings_now().get(name, (0, 0.0))
    return (s1 - s0) / (n1 - n0) if n1 > n0 else None


async def timed_guesses(svc, pairs) -> tuple:
    """Each pair as its own awaited ``similarity`` call, all at once:
    (scores, per-call seconds); a shed guess scores NaN and times None."""
    import numpy as np

    from cassmantle_tpu_torch.serving.queue import OverloadShed

    async def one(pair):
        t0 = time.perf_counter()
        try:
            out = await svc.similarity([pair])
        except OverloadShed:
            return np.nan, None
        return out[0], time.perf_counter() - t0

    res = await asyncio.gather(*(one(p) for p in pairs))
    return (np.asarray([r[0] for r in res], dtype=np.float32),
            [r[1] for r in res])


async def guesses_during(svc, work, tag: str) -> tuple:
    """Waves of 1,024 fresh out-of-vocabulary guesses while ``work`` (a
    list of awaitables) runs: (work's results, guess seconds, waves)."""
    task = asyncio.gather(*work)
    lat, waves = [], 0
    while not task.done():
        _, wave = await timed_guesses(svc, oov_pairs(f"{tag}{waves}w"))
        lat += wave
        waves += 1
        if all(t is None for t in wave):
            await asyncio.sleep(0.05)     # shed whole: the limiter's back-off
    return await task, lat, waves


class DispatchRecorder:
    """Wraps the scorer's device rung: the texts and bucket of each
    dispatch."""

    def __init__(self, scorer):
        from cassmantle_tpu_torch.ops.scorer import pick_bucket

        self.scorer, self.real = scorer, scorer._embed_device
        self.calls = []

        def recording(texts, batch=None):
            self.calls.append((len(texts), batch or pick_bucket(
                len(texts), scorer.batch_buckets)))
            return self.real(texts, batch)

        scorer._embed_device = recording

    def close(self):
        self.scorer._embed_device = self.real


def classifier_child() -> dict:
    """A device-side assert in a child process (its CUDA context is lost
    for good; the parent's stays healthy): the child prints what
    ``classify_device_loss`` says of the error."""
    import os

    code = (
        "import json, torch\n"
        "from cassmantle_tpu_torch.serving.device_recovery import "
        "classify_device_loss\n"
        "x = torch.zeros(4, device='cuda')\n"
        "try:\n"
        "    y = x[torch.tensor([1 << 20], device='cuda')]\n"
        "    torch.cuda.synchronize()\n"
        "    out = {'raised': None}\n"
        "except Exception as exc:\n"
        "    out = {'raised': type(exc).__name__, 'msg': str(exc)[:160],\n"
        "           'reason': classify_device_loss(exc)}\n"
        "print(json.dumps(out))\n")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        return {"raised": None, "stderr": proc.stderr[-400:]}
    return json.loads(lines[-1])


def device_loss_drill(svc) -> dict:
    """[serve] (e): corrupt a served UNet weight as a lost device leaves
    it, raise a chaos ``device.lost`` in a score dispatch, and let the
    recovery manager rebuild every model in place and warm (the scorer
    and a replay of the last decode). Returns the recovery seconds, the
    rise of ``max_memory_allocated`` over the allocation before the loss,
    across the whole recovery and across the rebuild alone (what its
    recipes add), whether the image after equals the one before with no
    new capture, and (``image``) that image."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch import chaos
    from cassmantle_tpu_torch.ops import graphs
    from cassmantle_tpu_torch.utils.logging import metrics

    count = metrics.counter_total
    backend = svc.backend
    t2i = backend.t2i
    before = t2i.generate([SERVE_PROMPT], seed=7)
    captures = graphs.capture_count()
    recoveries = count("device.recoveries")
    warm_decodes = []
    real_decode = backend.prompt_gen._decode
    backend.prompt_gen._decode = lambda *a: (
        warm_decodes.append(a[0]) or real_decode(*a))
    with torch.no_grad():              # what a lost device leaves behind
        t2i.unet.conv_in.weight.add_(1.0)
    # the rebuild's own rise, apart from the warm's activations after it
    rebuild_rise = []
    real_rebuild = svc.recovery.rebuild

    def rebuild():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at = torch.cuda.memory_allocated()
        real_rebuild()
        torch.cuda.synchronize()
        rebuild_rise.append(torch.cuda.max_memory_allocated() - at)

    svc.recovery.rebuild = rebuild
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    chaos.configure("seed=11;device.lost=raise:peer=scorer,times=1")
    t0 = time.perf_counter()
    raised = None
    try:
        asyncio.run(svc.similarity([("lost zq guess", "harbor")]))
    except chaos.ChaosInjected as exc:
        raised = type(exc).__name__
    finally:
        chaos.disarm()
    lost_state = svc.supervisor.status()["state"]
    svc.recovery.join(timeout=300)
    recover_s = time.perf_counter() - t0
    peak_rise = torch.cuda.max_memory_allocated() - base
    svc.recovery.rebuild = real_rebuild
    del backend.prompt_gen._decode
    state = svc.supervisor.status()["state"]
    with graphs.no_new_captures():
        after = t2i.generate([SERVE_PROMPT], seed=7)
    e = {"raised": raised, "state_after_loss": lost_state,
         "state_after_recovery": state, "recover_s": recover_s,
         "recovery_peak_rise_bytes": peak_rise,
         "rebuild_peak_rise_bytes": max(rebuild_rise, default=None),
         "recoveries": count("device.recoveries") - recoveries,
         "warm_decode_rows": [len(t) for t in warm_decodes],
         "image_equal": bool(np.array_equal(before, after)),
         "new_captures": graphs.capture_count() - captures}
    e["recovered"] = (raised is not None and state == "ok"
                      and e["recoveries"] == 1 and len(warm_decodes) == 1
                      and not svc.recovery.permanent)
    e["image"] = before
    return e


def check_serve(card: str) -> bool:
    """The serving seam at full width: ``InferenceService(FrameworkConfig())``
    scoring 1,024 concurrent guesses through the device rung (a) and rung
    0 (b), four concurrent rounds, one cold, while guesses are scored (c),
    the integrity drill (d), the device-loss drill (e) and the classifier
    on real CUDA errors (f)."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch import chaos
    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.ops import graphs
    from cassmantle_tpu_torch.serving.device_recovery import (
        classify_device_loss,
    )
    from cassmantle_tpu_torch.serving.service import InferenceService
    from cassmantle_tpu_torch.utils.logging import metrics
    from cassmantle_tpu_torch.utils.text import load_wordlist

    count = metrics.counter_total
    t0 = time.perf_counter()
    svc = InferenceService(FrameworkConfig())
    build_s = time.perf_counter() - t0
    scorer = svc.scorer
    checks, report = {}, {"card": card, "build_s": build_s,
                          "table": TABLE_BUILD or svc.table_stats}

    # (a) 1,024 concurrent guesses through the device rung
    rec = DispatchRecorder(scorer)
    pairs = oov_pairs("a")
    batches, items = count("score.batches"), count("score.items")
    hists = timings_now()
    scores, lat = asyncio.run(timed_guesses(svc, pairs))
    queue_layer = {"queue_wait_mean_s": mean_since(hists,
                                                   "score.queue_wait_s"),
                   "batch_service_mean_s": mean_since(hists,
                                                      "score.batch_s")}
    rec.close()
    scorer._embed_cache.clear()
    direct = scorer.similarity(pairs)
    a = {"score_batches": count("score.batches") - batches,
         "score_items": count("score.items") - items,
         "dispatches": rec.calls, **latency_ms(lat), **queue_layer,
         "max_abs_err_vs_direct": float(np.abs(scores - direct).max())}
    rows, bucket = rec.calls[0]
    ids = torch.zeros((bucket, scorer.seq_len), dtype=torch.long,
                      device="cuda")
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        a["device_ms_per_dispatch"] = time_ms(
            lambda: scorer.model(ids, mask), iters=3)
    checks["a_coalesced"] = (a["shed"] == 0 and a["score_batches"] <= 2
                             and len(rec.calls) == a["score_batches"]
                             and all(b in (1024, 2048)
                                     for _, b in rec.calls))
    checks["a_scores"] = a["max_abs_err_vs_direct"] <= 1e-5
    report["a"] = a

    # (b) the same 1,024 through rung 0: in-vocabulary guesses, answers
    # pinned
    words = [w for w in load_wordlist() if w.isalpha()][:SERVE_GUESSES]
    answers = ("nightglass", "emberfall", "quietude", "moonwharf")
    pinned = svc.pin_answers(answers)
    in_vocab = [(w, answers[i % 4]) for i, w in enumerate(words)]
    batches = count("score.batches")
    hits = count("scorer.table_hits")
    scores_b, lat_b = asyncio.run(timed_guesses(svc, in_vocab))
    texts = list(dict.fromkeys(words + list(answers)))
    emb = dict(zip(texts, scorer._embed_device(texts)[0]))
    fp32 = np.asarray([emb[g] @ emb[t] for g, t in in_vocab])
    b = {"score_batches": count("score.batches") - batches,
         "table_hits": count("scorer.table_hits") - hits,
         "pinned": pinned, **latency_ms(lat_b),
         "max_abs_err_vs_fp32": float(np.abs(scores_b - fp32).max()),
         "table_rows": len(scorer.table)}
    checks["b_no_dispatch"] = b["score_batches"] == 0
    checks["b_table_hits"] = b["table_hits"] == 2 * len(in_vocab)
    checks["b_fidelity"] = b["max_abs_err_vs_fp32"] <= 1e-2
    report["b"] = b

    # (c) four concurrent rounds, one cold, while guesses are scored
    backend = svc.backend
    given = {}
    real_sync = backend.generate_sync

    def recording_sync(seed, is_seed=True, text=None):
        given[seed] = text
        return real_sync(seed, is_seed, text)

    backend.generate_sync = recording_sync
    prompt_batches = count("prompt.batches")
    prompt_items = count("prompt.items")
    captures = graphs.capture_count()
    hists = timings_now()
    reset_all_counters()

    async def rounds():
        async def one(seed):
            t = time.perf_counter()
            rc = await svc.content_backend.generate(seed, True)
            return rc, time.perf_counter() - t

        t = time.perf_counter()
        out, lat_c, waves = await guesses_during(
            svc, [one(s) for s in SERVE_SEEDS], "c")
        return out, lat_c, waves, time.perf_counter() - t

    served, lat_c, waves, wall = asyncio.run(rounds())
    tallies = read_tallies()
    new_captures = graphs.capture_count() - captures
    queue_layer = {f"{q}_{k}": mean_since(hists, f"{q}.{h}")
                   for q in ("score", "prompt")
                   for k, h in (("queue_wait_mean_s", "queue_wait_s"),
                                ("batch_service_mean_s", "batch_s"))}
    del backend.generate_sync        # the class's method again, no cycle
    gen = backend.prompt_gen
    lone = dict(zip(SERVE_SEEDS, gen.generate_batch(list(SERVE_SEEDS))))
    single = {sd: gen.generate(sd) for sd in SERVE_SEEDS}
    same_image = []
    for rc, _ in served:
        again = backend.t2i.generate([rc.image_prompt], seed=rc.image_seed)
        same_image.append(bool(np.array_equal(again[0], rc.image)))
    c = {"round_s": [r[1] for r in served], "wall_s": wall,
         "guess_waves": waves, **latency_ms(lat_c), **queue_layer,
         "idle_p50_ms": a["p50_ms"], "idle_p99_ms": a["p99_ms"],
         "prompt_batches": count("prompt.batches") - prompt_batches,
         "prompt_items": count("prompt.items") - prompt_items,
         "decode_batch_shapes": sorted({k[0] for k in gen.decode_graphs}),
         "captures": new_captures,
         "flash_launches": sum(tallies["flash_attention"].values()),
         "texts_equal_lone_batch": [given.get(sd) == lone[sd]
                                    for sd in SERVE_SEEDS],
         "texts_equal_lone_single": [lone[sd] == single[sd]
                                     for sd in SERVE_SEEDS],
         "images_equal_lone": same_image,
         "image_seeds": [rc.image_seed for rc, _ in served]}
    checks["c_one_decode_batch"] = (c["prompt_batches"] == 1
                                    and c["prompt_items"] == 4
                                    and 4 in c["decode_batch_shapes"])
    checks["c_texts"] = all(c["texts_equal_lone_batch"])
    checks["c_images"] = all(same_image) and sorted(
        c["image_seeds"]) == [1, 2, 3, 4]
    checks["c_cold_captured"] = c["captures"] >= 2
    checks["c_flash"] = c["flash_launches"] == 4 * sum(
        ROUND_FLASH["sd15"].values())

    # the same four rounds warm, under the guess waves and alone: what the
    # guesses' host work costs the rounds
    async def warm_rounds(waves_on: bool):
        async def one(seed):
            t = time.perf_counter()
            await svc.content_backend.generate(seed, True)
            return time.perf_counter() - t

        t = time.perf_counter()
        work = [one(sd) for sd in SERVE_SEEDS]
        if waves_on:
            out, lat_w, _ = await guesses_during(svc, work, "cw")
        else:
            out, lat_w = await asyncio.gather(*work), []
        return out, lat_w, time.perf_counter() - t

    warm, lat_w, wall_w = asyncio.run(warm_rounds(True))
    alone, _, wall_alone = asyncio.run(warm_rounds(False))
    c["warm_under_guesses"] = {"round_s": warm, "wall_s": wall_w,
                               **latency_ms(lat_w)}
    c["warm_alone"] = {"round_s": alone, "wall_s": wall_alone,
                       "stages_s": backend.t2i.last_stage_seconds,
                       "decode_s": gen.last_seconds}
    report["c"] = c

    # (d) integrity: one poisoned member of one score batch
    pairs_d = oov_pairs("d", 64)
    invalid = count("pipeline.output_invalid")
    chaos.configure("seed=10;device.poison=raise:peer=scorer,times=1")
    try:
        scores_d, _ = asyncio.run(timed_guesses(svc, pairs_d))
    finally:
        chaos.disarm()
    scorer._embed_cache.clear()
    direct_d = scorer.similarity(pairs_d)
    floored = np.nonzero(scores_d == 0.0)[0]
    keep = np.ones(len(pairs_d), bool)
    keep[floored] = False
    d = {"floored": floored.tolist(),
         "output_invalid": count("pipeline.output_invalid") - invalid,
         "max_abs_err_others": float(np.abs(scores_d[keep]
                                            - direct_d[keep]).max())}
    checks["d_one_member"] = len(floored) == 1 and d["output_invalid"] == 1
    checks["d_others_real"] = d["max_abs_err_others"] <= 1e-5
    report["d"] = d

    # (e) the device-loss drill
    e = device_loss_drill(svc)
    SERVE_DRILL["image"] = e.pop("image")
    SERVE_DRILL["peak_rise_bytes"] = e["rebuild_peak_rise_bytes"]
    checks["e_recovered"] = e.pop("recovered")
    checks["e_same_image"] = e["image_equal"] and e["new_captures"] == 0
    report["e"] = e

    # (f) the classifier on real CUDA errors
    child = classifier_child()
    try:
        torch.empty(1 << 50, dtype=torch.uint8, device="cuda")
        oom = {"raised": None}
    except torch.OutOfMemoryError as exc:
        oom = {"raised": type(exc).__name__,
               "reason": classify_device_loss(exc)}
    torch.cuda.empty_cache()
    report["f"] = {"child": child, "oom": oom}
    checks["f_assert_is_loss"] = bool(child.get("reason"))
    checks["f_oom_is_not"] = (oom["raised"] == "OutOfMemoryError"
                              and oom["reason"] is None)

    asyncio.run(svc.stop())
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[serve] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def check_serve_sdxl(svc, card: str) -> bool:
    """``BASELINE.json``'s fifth configuration on one card: one SDXL round
    served while waves of 1,024 concurrent guesses are scored, on the
    service the ``[round-sdxl]`` phase built."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()

    async def run():
        t = time.perf_counter()
        out, lat, waves = await guesses_during(
            svc, [svc.content_backend.generate(SERVE_SEEDS[1], True)], "x")
        return out[0], lat, waves, time.perf_counter() - t

    rc, lat, waves, round_s = asyncio.run(run())
    flash = sum(read_tallies()["flash_attention"].values())
    asyncio.run(svc.stop())
    res = {"card": card, "round_s": round_s, "guess_waves": waves,
           **latency_ms(lat), "flash_launches": flash,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "image_shape": list(rc.image.shape)}
    ok = (flash == sum(ROUND_FLASH["sdxl"].values())
          and rc.image.shape == (1024, 1024, 3) and res["n"] > 0)
    print(f"[serve-sdxl] {json.dumps(res)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    return ok


# -- weights from a directory ------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
MANIFEST_DIR = os.path.join(REPO, "data", "manifests")
# where the weights phases write their files (git-ignored), removed after
WEIGHTS_DIR = os.path.join(REPO, "cassmantle_tpu_torch", "_build",
                           "smoke_weights")
# the SD1.5 service's files and the manifests of their published tensors
SD15_FILES = {"clip_text": ("clip_text.safetensors", "clip_full"),
              "unet": ("unet.safetensors", "unet_sd15"),
              "vae": ("vae.safetensors", "vae_sd15"),
              "gpt2": ("gpt2.safetensors", "gpt2"),
              "minilm": ("minilm.safetensors", "minilm")}
WEIGHT_STD = 0.02              # N(0, 0.02) leaves; norm scales 1, biases 0
POOL_VALUES = 1 << 24          # the seeded pool windows are cut from
MISTRAL_SMOKE_LAYERS = 4       # [weights-mistral]'s depth cut (of 32)
ST_DTYPES = {"F16": ("float16", 2), "BF16": ("bfloat16", 2)}


def load_manifest(name: str) -> dict:
    with open(os.path.join(MANIFEST_DIR, f"{name}.json")) as f:
        return json.load(f)


def leaf_fill(key: str, shape) -> str:
    """How the smoke checkpoints fill a published tensor, at the scale of
    the port's seeded init: "zeros" for biases, "ones" for the norms'
    scales (every 1-D weight of these models), else "normal"."""
    if key.endswith(".bias"):
        return "zeros"
    if key.endswith(".weight") and len(shape) == 1:
        return "ones"
    return "normal"


def value_pool(dtype: str, seed: int):
    """POOL_VALUES draws of N(0, WEIGHT_STD) from a seeded numpy
    generator, as the bytes of ``dtype`` ("F16" or "BF16")."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(POOL_VALUES, dtype=np.float32)
                         * np.float32(WEIGHT_STD))
    return x.to(getattr(torch, ST_DTYPES[dtype][0])).view(
        torch.int16).numpy().tobytes()


def write_safetensors(path: str, shapes: dict, dtype: str, pool: bytes,
                      seed: int) -> dict:
    """A safetensors file of ``shapes`` (name -> shape) in ``dtype``,
    written here without the safetensors package: the 8-byte header
    length, the JSON header, then each tensor's bytes in name order.
    Biases are 0 and norm scales 1 (:func:`leaf_fill`); every other
    tensor is the pool read from a seeded offset onwards, wrapping.
    Returns {name: pool offset in values} of the pooled tensors."""
    import numpy as np
    import torch

    itemsize = ST_DTYPES[dtype][1]
    one = torch.ones((), dtype=getattr(torch, ST_DTYPES[dtype][0])).view(
        torch.int16).item()
    header, offsets, pos = {}, {}, 0
    for key in sorted(shapes):
        n = math.prod(shapes[key]) * itemsize
        header[key] = {"dtype": dtype, "shape": list(shapes[key]),
                       "data_offsets": [pos, pos + n]}
        pos += n
    blob = json.dumps({"__metadata__": {"format": "pt"}, **header}).encode()
    blob += b" " * (-len(blob) % 8)
    rng = np.random.default_rng(seed)
    zeros = bytes(1 << 24)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for key in sorted(shapes):
            numel = math.prod(shapes[key])
            fill = leaf_fill(key, shapes[key])
            if fill == "ones":
                f.write(np.full(numel, one, np.int16).tobytes())
                continue
            left = numel * itemsize
            if fill == "zeros":
                while left:
                    f.write(zeros[:min(left, len(zeros))])
                    left -= min(left, len(zeros))
                continue
            start = int(rng.integers(0, POOL_VALUES))
            offsets[key] = start
            at = start * itemsize
            while left:
                chunk = pool[at:at + left]
                f.write(chunk)
                left -= len(chunk)
                at = 0
    return offsets


def pool_values(pool: bytes, dtype: str, start: int, numel: int):
    """What :func:`write_safetensors` wrote for a pooled tensor, as a
    flat CPU tensor."""
    import numpy as np
    import torch

    bits = np.frombuffer(pool, dtype=np.int16)
    idx = (np.arange(numel, dtype=np.int64) + start) % POOL_VALUES
    return torch.from_numpy(bits[idx].copy()).view(
        getattr(torch, ST_DTYPES[dtype][0]))


def greedy_merges(seqs, n: int) -> list:
    """``n`` greedy most-frequent-pair BPE merges over symbol sequences."""
    counts = collections.Counter(tuple(q) for q in seqs)
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for sym, c in counts.items():
            for pair in zip(sym, sym[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        merged = collections.Counter()
        for sym, c in counts.items():
            out, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            merged[tuple(out)] += c
        counts = merged
    return merges


def write_vocab_files(path: str, n_merges: int = 96) -> None:
    """Small synthetic vocabularies under the reference's file names, from
    the game's seeds and styles: byte-level BPE for GPT-2 and CLIP (its
    word-final ``</w>``), a WordPiece list for MiniLM and a SentencePiece
    BPE ``tokenizer.json`` (``▁`` marks, byte fallback) for Mistral."""
    from cassmantle_tpu_torch.utils.tokenizers import (
        SentencePieceBPETokenizer,
        _bytes_to_unicode,
    )

    text = []
    for name in ("seeds.txt", "styles.txt"):
        with open(os.path.join(REPO, "data", name), encoding="utf-8") as f:
            text += f.read().lower().split()
    b2u = _bytes_to_unicode()
    for kind, end in (("gpt2", ""), ("clip", "</w>")):
        seqs = []
        for w in text:
            sym = [b2u[b] for b in w.encode("utf-8")]
            sym[-1] += end
            seqs.append(sym)
        merges = greedy_merges(seqs, n_merges)
        symbols = list(b2u.values()) + [s + end for s in b2u.values()
                                        if end] + [a + b for a, b in merges]
        vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
        if kind == "clip":
            vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        with open(os.path.join(path, f"{kind}_vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(path, f"{kind}_merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            f.writelines(f"{a} {b}\n" for a, b in merges)
    chars = sorted({c for w in text for c in w if c.isalnum()})
    common = [w for w, _ in collections.Counter(text).most_common(300)
              if w.isalnum()]
    pieces = (["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + chars
              + [f"##{c}" for c in chars] + common)
    with open(os.path.join(path, "minilm_vocab.txt"), "w") as f:
        f.writelines(f"{p}\n" for p in dict.fromkeys(pieces))
    mark = SentencePieceBPETokenizer.WORD_MARK
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    words = [mark + w for w in text]
    for c in sorted({c for w in words for c in w}):
        vocab.setdefault(c, len(vocab))
    merges = greedy_merges([list(w) for w in words], n_merges)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    with open(os.path.join(path, "mistral_tokenizer.json"), "w") as f:
        json.dump({"model": {"type": "BPE", "vocab": vocab,
                             "merges": [f"{a} {b}" for a, b in merges]},
                   "added_tokens": [{"content": "<s>", "id": 1},
                                    {"content": "</s>", "id": 2}]}, f)


class LogCollector(logging.Handler):
    """The records of one ``cassmantle.*`` logger (that tree does not
    propagate to the root)."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self.records = []
        self.logger = logging.getLogger(name)
        self.logger.addHandler(self)

    def emit(self, record) -> None:
        self.records.append(record)

    def close(self) -> None:
        self.logger.removeHandler(self)
        super().close()


def served_equals_files(module, plan) -> bool:
    """Every tensor ``module`` serves equals, bit for bit, the converted
    checkpoint ``plan`` cast to the served tensor's dtype."""
    import torch

    served = module.state_dict()
    if set(served) != set(plan):
        return False
    return all(torch.equal(t, plan[k].to(t.device, t.dtype))
               for k, t in served.items())


def check_weights(card: str):
    """[weights] and [weights-rebuild]: ``InferenceService(FrameworkConfig(),
    weights_dir=...)`` from fp16 checkpoints under the published names and
    shapes of ``data/manifests`` (seeded values at the scale of the
    port's init) and synthetic vocabularies. Checks (a) every manifest
    key consumed or ignored by design, (b) every served tensor equal to
    the converter's output of its file, (c) ``loaded_real_weights`` and
    the BPE and WordPiece tokenizers, (d) the round checks of
    [round-default] and graphed = eager, (e) an image other than the
    seeded service's, then the device-loss drill from the files, and (f)
    a second boot verifying the recorded sidecars. Returns (passed, the
    round's launch tallies)."""
    import shutil

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.models import weights as pw
    from cassmantle_tpu_torch.serving.service import InferenceService
    from cassmantle_tpu_torch.utils import checkpoint
    from cassmantle_tpu_torch.utils.logging import metrics
    from cassmantle_tpu_torch.utils.tokenizers import (
        BPETokenizer,
        WordPieceTokenizer,
    )

    cfg = FrameworkConfig()
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    pool = value_pool("F16", 21)
    t0 = time.perf_counter()
    written, pooled = {}, {}
    for i, (kind, (name, manifest)) in enumerate(SD15_FILES.items()):
        inv = load_manifest(manifest)["tensors"]
        path = os.path.join(WEIGHTS_DIR, name)
        pooled[kind] = write_safetensors(path, inv, "F16", pool, 100 + i)
        written[kind] = os.path.getsize(path)
    write_vocab_files(WEIGHTS_DIR)
    write_s = time.perf_counter() - t0
    report = {"card": card, "write_s": write_s,
              "file_bytes": written}
    checks = {}

    # (a) every published key consumed or ignored by design, with the
    # manifests' optional keys as meta stubs beside the file's tensors
    logs = LogCollector("cassmantle.weights")
    plans, read_bytes = {}, {}
    stub = torch.empty((), device="meta")
    for kind, (name, manifest) in [*SD15_FILES.items(),
                                   ("vae_enc", SD15_FILES["vae"])]:
        tensors = pw.load_checkpoint_tensors(WEIGHTS_DIR, name, kind)
        extra = {k: stub.expand(tuple(v)) for k, v in
                 load_manifest(manifest)["optional"].items()}
        pw.converter_for(kind, cfg.models)({**tensors, **extra})
        if kind == "vae_enc":
            continue
        plans[kind] = plan = pw.converter_for(kind, cfg.models)(tensors)
        read_bytes[kind] = sum(
            tensors[k].numel() * tensors[k].element_size()
            for k in {src for key in plan for src in plan.sources(key)})
        # the reader gives back what was written
        for key in sorted(pooled[kind])[:3]:
            want = pool_values(pool, "F16", pooled[kind][key],
                               tensors[key].numel())
            checks[f"a_read_{kind}"] = checks.get(f"a_read_{kind}", True) \
                and torch.equal(tensors[key].reshape(-1), want)
    logs.close()
    warned = [r.getMessage() for r in logs.records
              if r.levelno >= logging.WARNING]
    checks["a_consumed_or_ignored"] = not warned
    report["a_warnings"] = warned[:4]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mismatches = metrics.counter_total("checkpoint.fingerprint_mismatch")
    t0 = time.perf_counter()
    svc = InferenceService(cfg, weights_dir=WEIGHTS_DIR)
    torch.cuda.synchronize()
    report["boot_s"] = time.perf_counter() - t0
    report["boot_peak_gib"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 30
    report["served_gib"] = (torch.cuda.memory_allocated() - base) / 2 ** 30
    t2i, gen, scorer = svc.backend.t2i, svc.backend.prompt_gen, svc.scorer
    served = {"clip_text": t2i.clip, "unet": t2i.unet, "vae": t2i.vae,
              "gpt2": gen.model, "minilm": scorer.model}

    # (b) served = converter output of the file, cast to storage
    checks["b_served_equal_files"] = all(
        served_equals_files(served[k], plans[k]) for k in SD15_FILES)
    # (c)
    checks["c_loaded_real_weights"] = bool(
        t2i.loaded_real_weights and gen.loaded_real_weights
        and scorer.loaded_real_weights)
    checks["c_tokenizers"] = (isinstance(t2i.tokenizer, BPETokenizer)
                              and isinstance(gen.tokenizer, BPETokenizer)
                              and isinstance(scorer.tokenizer,
                                             WordPieceTokenizer))
    # each file's load as boot runs it after building the module: read
    # under the fingerprint, convert, copy into the served tensors
    loads = {}
    for kind, (name, _) in SD15_FILES.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.fill_(served[kind], pw.reread(
            WEIGHTS_DIR, name, pw.converter_for(kind, cfg.models), kind))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loads[name] = {"s": dt, "bytes_read": read_bytes[kind],
                       "gb_per_s": read_bytes[kind] / dt / 1e9}
    report["load"] = loads
    checks["b_served_equal_after_reload"] = all(
        served_equals_files(served[k], plans[k]) for k in SD15_FILES)
    del plans

    # (d) the round checks of [round-default], and graphed = eager
    svc, tallies, bad = run_round(card, "weights", cfg, svc=svc)
    checks["d_round"] = not bad
    report["d_failed"] = bad
    checks["d_graphs"] = check_graphs(svc, "weights", card)
    # (e) not the seeded service's image
    image = t2i.generate([SERVE_PROMPT], seed=7)
    checks["e_other_than_seeded"] = (
        "image" in SERVE_DRILL
        and not np.array_equal(image, SERVE_DRILL["image"]))

    # [weights-rebuild]: the device-loss drill, its recipes from files
    drill = device_loss_drill(svc)
    drill.pop("image")
    largest = max(t.numel() for m in served.values()
                  for t in m.state_dict().values())
    bound = 4 * largest + (64 << 20)
    rebuild_ok = (drill.pop("recovered") and drill["image_equal"]
                  and drill["new_captures"] == 0
                  and drill["rebuild_peak_rise_bytes"] <= bound)
    line = {"card": card, **drill, "bound_bytes": bound,
            "seeded_recipe_peak_rise_bytes": SERVE_DRILL.get(
                "peak_rise_bytes")}
    print(f"[weights-rebuild] {json.dumps(line)} -> "
          f"{'pass' if rebuild_ok else 'FAIL'}", flush=True)
    asyncio.run(svc.stop())
    del svc, t2i, gen, scorer, served
    gc.collect()
    torch.cuda.empty_cache()

    # (f) a second boot from the same directory verifies the sidecars
    sidecars = {}
    for name, _ in SD15_FILES.values():
        path = os.path.join(WEIGHTS_DIR, name)
        sidecars[name] = (checkpoint.read_fingerprint(path)
                          == checkpoint.fingerprint_file(path))
    t0 = time.perf_counter()
    again = InferenceService(cfg, weights_dir=WEIGHTS_DIR)
    report["second_boot_s"] = time.perf_counter() - t0
    checks["f_sidecars_recorded"] = all(sidecars.values())
    checks["f_second_boot_verified"] = (
        again.backend.t2i.loaded_real_weights
        and metrics.counter_total("checkpoint.fingerprint_mismatch")
        == mismatches)
    asyncio.run(again.stop())
    del again
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[weights] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    return ok and rebuild_ok, tallies


def check_weights_mistral(card: str) -> bool:
    """[weights-mistral]: ``mistral_config()`` at full width with its
    depth cut to MISTRAL_SMOKE_LAYERS, from two BF16 shards under the
    published names of ``data/manifests/mistral.json`` and a synthetic
    ``mistral_tokenizer.json``, built through ``build_streamed``: the
    build's peak at or below the stored bf16 footprint plus the largest
    submodule in fp32, the served tensors bit-equal to the shards', and
    one graphed greedy decode equal to the eager one."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from cassmantle_tpu_torch.models import weights as pw
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator
    from cassmantle_tpu_torch.utils.tokenizers import (
        SentencePieceBPETokenizer,
    )

    base = mistral_config()
    m = dataclasses.replace(base.models.mistral,
                            num_layers=MISTRAL_SMOKE_LAYERS)
    cfg = base.replace(models=dataclasses.replace(base.models, mistral=m))
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    inv = load_manifest("mistral")["tensors"]
    keep = {k: v for k, v in inv.items()
            if not k.startswith("model.layers.")
            or int(k.split(".")[2]) < MISTRAL_SMOKE_LAYERS}
    keys = sorted(keep)
    pool = value_pool("BF16", 31)
    t0 = time.perf_counter()
    nbytes = 0
    for i, part in enumerate((keys[: len(keys) // 2],
                              keys[len(keys) // 2:])):
        path = os.path.join(WEIGHTS_DIR, f"mistral-{i + 1:05d}.safetensors")
        write_safetensors(path, {k: keep[k] for k in part}, "BF16", pool,
                          200 + i)
        nbytes += os.path.getsize(path)
    write_vocab_files(WEIGHTS_DIR)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = PromptGenerator(cfg, weights_dir=WEIGHTS_DIR)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_bytes
    stored = sum(t.numel() * t.element_size()
                 for t in gen.model.state_dict().values())
    largest_fp32 = max(sum(t.numel() for t in c.state_dict().values()) * 4
                       for c in gen.model.children())
    plan = pw.maybe_load(WEIGHTS_DIR, "mistral.safetensors",
                         pw.converter_for("mistral", cfg.models), "mistral")
    # the rebuild's path over the same shards, now in the page cache:
    # straight into the served bf16 tensors, no fp32 submodule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw.fill_(gen.model, plan)
    torch.cuda.synchronize()
    refill_s = time.perf_counter() - t0
    seed = [LM_TEXT]
    tok_e, len_e = gen.decode_ids_batch(seed, graphed=False)
    tok_g, len_g = gen.decode_ids_batch(seed, graphed=True)
    checks = {
        "loaded_real_weights": bool(gen.loaded_real_weights),
        "sentencepiece": isinstance(gen.tokenizer, SentencePieceBPETokenizer),
        "peak_within_bound": peak <= stored + largest_fp32,
        "served_equal_shards": served_equals_files(gen.model, plan),
        "graphed_equals_eager": bool(np.array_equal(tok_e, tok_g)
                                     and np.array_equal(len_e, len_g)),
    }
    report = {"card": card,
              "depth": f"{MISTRAL_SMOKE_LAYERS} of 32 layers (cut)",
              "shards": 2, "shard_bytes": nbytes, "write_s": write_s,
              "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
              "refill_s": refill_s,
              "refill_gb_per_s": nbytes / refill_s / 1e9,
              "peak_bytes": peak, "stored_bytes": stored,
              "largest_submodule_fp32_bytes": largest_fp32,
              "decode_tokens": int(len_g[0]),
              "checks": {k: bool(v) for k, v in checks.items()}}
    del gen, plan
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    ok = all(checks.values())
    print(f"[weights-mistral] {json.dumps(report)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


def kernel_entries(kernel, rows, tally, source, replaces):
    """The kernels-line entries of one kernel: every checked shape, with
    its launches in its path's round."""
    return [{"name": f"{kernel}[{'x'.join(map(str, shape))}]",
             "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": tally.get(shape, 0),
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "ok": r["ok"]} for shape, r in rows.items()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run "
             "needs an NVIDIA card")
    for switch in ("CASSMANTLE_NO_FUSED_CONV", "CASSMANTLE_NO_W8A8"):
        if os.environ.get(switch, "").lower() not in ("", "0", "false",
                                                      "no", "off"):
            fail(f"{switch} is set: the smoke run drives the kernels")
    card = card_line()
    print(f"[card] {card}", flush=True)

    from cassmantle_tpu_torch.config import (
        FrameworkConfig,
        deepcache_serving_config,
        encprop_serving_config,
        fast_serving_config,
        fusedconv_serving_config,
        lcm_serving_config,
        sdxl_config,
        turbo_serving_config,
        w8a8_serving_config,
    )
    from cassmantle_tpu_torch.ops import _build
    from cassmantle_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")        # TF32 off: the plain fp32 convs are fp32
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(libs)} in {build_s:.1f} s", flush=True)
    for line in kernel_build_report(libs):
        print(line, flush=True)

    rows = check_flash_kernel()
    if not all(r["ok"] for r in rows.values()):
        fail("flash kernel disagrees with its plain version")
    checked = {"gn_silu_conv3x3": check_fused_conv_kernel(),
               "int8_matmul": check_int8_matmul_kernel(),
               "int8_conv3x3": check_int8_conv_kernel()}
    for kernel, kernel_rows in checked.items():
        bad = [s for s, r in kernel_rows.items() if not r["ok"]]
        if bad:
            fail(f"{kernel} disagrees with its plain version at {bad}")

    if not check_small_agreement():
        fail("tiny geometry: card and CPU disagree")
    if not check_small_fused_and_w8a8():
        fail("tiny geometry, fused conv or W8A8: card and CPU disagree")
    if not check_small_sdxl():
        fail("tiny geometry, SDXL: card and CPU disagree")
    if not check_jax_random():
        fail("jax_random: the card's keys, bits or uniforms differ from "
             "the CPU's")
    if not check_small_samplers():
        fail("tiny geometry, a sampler loop: card and CPU disagree")
    if not check_small_mistral():
        fail("tiny geometry, Mistral: card and CPU disagree")

    presets = (("default", FrameworkConfig()),
               ("fusedconv", fusedconv_serving_config()),
               ("w8a8", w8a8_serving_config()),
               ("sdxl", sdxl_config()),
               ("encprop", encprop_serving_config()),
               ("deepcache", deepcache_serving_config()),
               ("fast", fast_serving_config()),
               ("turbo", turbo_serving_config()),
               ("lcm", lcm_serving_config()),
               ("img2img", img2img_config()))
    tallies = {}
    for preset, cfg in presets:
        run = run_img2img if preset == "img2img" else run_round
        svc, tallies[preset], bad = run(card, preset, cfg)
        if bad:
            fail(f"round-{preset} checks failed: {bad}")
        if not check_graphs(svc, preset, card):
            fail(f"{preset}: the graphed loops disagree with the eager "
                 f"steps")
        if preset in SAMPLER_FORWARDS:
            prof = profile_loop(svc, preset)
            print(f"[profile] {preset} graphed denoise at full width "
                  f"({card}): {json.dumps(prof)}", flush=True)
        else:
            prof = profile_denoise(svc, preset)
            print(f"[profile] {preset} denoise step at full width ({card}): "
                  f"{json.dumps(prof)}", flush=True)
        if not prof["graph_witness"]["ok"]:
            fail(f"{preset}: the profiled graph replays did not launch the "
                 f"step's kernels: {prof['graph_witness']}")
        if preset == "sdxl" and not check_serve_sdxl(svc, card):
            fail("serve-sdxl: the SDXL round under 1,024 concurrent "
                 "guesses failed its checks")
        # the graphs' closures hold the service in reference cycles:
        # collect them, so the next round's peak memory is its own
        del svc, prof
        gc.collect()
        torch.cuda.empty_cache()

    # the serving seam: queues, supervisor, integrity, device-loss recovery
    # and the int8 table at FrameworkConfig()
    if not check_serve(card):
        fail("serve: the serving seam failed a check")
    gc.collect()
    torch.cuda.empty_cache()

    # the same service from a weights directory, its rebuild from the
    # files, and Mistral from two shards
    ok, tallies["weights"] = check_weights(card)
    if not ok:
        fail("weights: the service from a weights directory failed a check")
    if not check_weights_mistral(card):
        fail("weights-mistral: Mistral from its shards failed a check")

    # Mistral-7B as the round's prompt LM, at full width in bf16; its
    # decode-step profile, then speculative and sampled decodes over it
    svc, tallies["mistral"], bad = run_round(card, "mistral",
                                             mistral_config())
    if bad:
        fail(f"round-mistral checks failed: {bad}")
    if not check_graphs(svc, "mistral", card):
        fail("mistral: the graphed decode disagrees with the eager steps")
    prof = profile_decode(svc)
    print(f"[profile] mistral decode step at full width ({card}): "
          f"{json.dumps(prof)}", flush=True)
    if not prof["graph_witness"]["ok"]:
        fail(f"mistral: a decode-step replay is not one graph launch "
             f"free of host copies and syncs: {prof['graph_witness']}")
    if not check_spec(svc):
        fail("speculative decode parted from greedy beyond the "
             "step-vs-chunk drift")
    if not check_sampled(svc):
        fail("mistral: the sampled decode's graph disagrees with the eager "
             "steps, or a token left its top-k")
    del svc, prof
    gc.collect()
    torch.cuda.empty_cache()

    by_shape = {(b, sq, sk, h, d): name
                for name, (b, sq, sk, h, d, _) in FLASH_SHAPES.items()}
    for preset in tallies:
        shapes = tallies[preset]["flash_attention"]
        want = round_flash_shapes(preset)
        unknown = set(shapes) - set(want)
        missing = set(want) - set(shapes)
        if unknown or missing:
            fail(f"{preset}: main-path flash shapes differ from the checked "
                 f"ones: unexpected {sorted(unknown)}, never launched "
                 f"{sorted(missing)}")
        # each shape ran in the round on the path its check took
        for (shape, path), n in tallies[preset]["flash_paths"].items():
            name = by_shape[shape]
            if path != rows[name]["path"]:
                fail(f"{preset}: flash {name} took {path} {n} times in the "
                     f"round, {rows[name]['path']} in its check")
    for kernel, kernel_rows in checked.items():
        for preset in tallies:
            unchecked = set(tallies[preset][kernel]) - set(kernel_rows)
            if unchecked:
                fail(f"{preset}: {kernel} launched at unchecked shapes "
                     f"{sorted(unchecked)}")

    kernels = []
    for key, name in by_shape.items():
        r = rows[name]
        # launches and path from the first round whose model runs the
        # shape: default for SD1.5's, sdxl, encprop for the batch-4 ones
        preset = next(p for p in ("default", "sdxl", "encprop")
                      if name in ROUND_FLASH[PRESET_MODEL[p]])
        round_paths = tallies[preset]["flash_paths"]
        (path,) = {p for (shape, p) in round_paths if shape == key}
        kernels.append({
            "name": f"flash_attention[{name}]", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": sum(n for (shape, _), n in round_paths.items()
                            if shape == key),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "path": path, "ok": r["ok"]})
    for kernel, presets, source, replaces in (
            ("gn_silu_conv3x3", ("fusedconv", "encprop", "img2img"),
             FUSED_SOURCE, FUSED_REPLACES),
            ("int8_matmul", ("w8a8",), INT8_SOURCE, MATMUL_REPLACES),
            ("int8_conv3x3", ("w8a8",), INT8_SOURCE, CONV_REPLACES)):
        # launches in the rounds of the presets that serve the kernel
        # (the UNet's shapes at fusedconv, the VAE decoder's at encprop,
        # at img2img the encoder's and the decoder's again)
        tally = sum((tallies[p][kernel] for p in presets),
                    collections.Counter())
        kernels += kernel_entries(kernel, checked[kernel], tally, source,
                                  replaces)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
