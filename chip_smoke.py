"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``cassmantle_tpu_torch`` only (nothing of JAX or ``cassmantle_tpu``):

0. prints the card's name and power limit; fails without CUDA, or with a
   kill switch (CASSMANTLE_NO_FUSED_CONV, CASSMANTLE_NO_W8A8) set; derives
   from each served preset's config, at full quality and at every
   brownout tier (``degraded_sampler_cfg``), the shapes its round
   launches each kernel at, and fails if phase 2 does not check one of
   them or a round's table below differs from the derivation;
1. builds every kernel of ``cassmantle_tpu_torch/csrc/`` with ``nvcc``
   (one process per source, all at once) into the git-ignored
   ``cassmantle_tpu_torch/_build/``, and reports each kernel's registers
   and spills and, with ``cuobjdump``, its warpgroup MMA instructions
   (fails if a wgmma kernel spills or issues none);
2. holds each kernel (flash attention, the fused GroupNorm-affine + SiLU +
   conv3x3, the int8 matmul, the int8 conv3x3) against its plain PyTorch
   version at every shape the main paths give it (the fused conv also at
   the SD1.5 and SDXL VAE decoders' widths, 64 to 1024; flash also at the
   decoder-only forward's batch 4; and the brownout tiers' shapes: flash
   at SD1.5 256x256 down to the mid block's S = 16, at SDXL 512x512 and
   at the decoder-only forward's batch 8 at 512x512 and 256x256, kernels
   2 and 4 at the 256x256 UNet's convs down to W = 4, kernel 2 at the
   SD1.5 VAE decoder's at 256x256, kernel 3 at its M), and times the
   kernel, the plain version and one PyTorch library call (a yardstick
   the port never calls) beside the card's bound for the work (for flash
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
7. serves a round with Mistral-7B as the prompt LM ([round-mistral]:
   its published widths, 4096, GQA 32/8, cut to 8 of its 32 layers
   (``ROUND_MISTRAL_LAYERS``), bf16, seeded random weights built submodule
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
   files are removed after;
12. the brownout ladder ([brownout]): the ladder stepped by its drill
   lever (the ``overload.brownout`` fault point, through an SLO engine)
   and one round served at each tier that changes the config:
   ``FrameworkConfig()`` at tiers 1 (DDIM-30) and 4 (256x256), with
   ``consistency_available`` at tier 3 (four consistency steps),
   ``fusedconv_serving_config()`` and ``w8a8_serving_config()`` at tier
   4, ``encprop_serving_config()`` at tiers 2 (stride 5) and 4 (stride
   5 at 256x256: the decoder-only forward at batch 8 and the fused VAE
   decoder at 256x256) and ``sdxl_config()`` at tiers 1 and 4
   (512x512): the image size, the
   tier variant's graph replays and every kernel's launches per shape
   against the tier's config, at checked shapes only; the tier graph's
   final latents bit-equal to the eager loop's; a repeated tier reusing
   its variant with no new capture; back at tier 0, the image bit-equal
   to the one before the ladder moved; at the default preset, the tier
   graphs still valid after a rebuild of every model and its warm; and
   ``pipeline.brownout_delta_unusable`` 0. Each tier's round, capture
   seconds, pool MB and peak GiB;
13. the game ([game]): a ``Game`` on the ``[serve]`` service (its content
   backend, embed, similarity, blur, supervisor and answer pins; a
   ``MemoryStore``; 8 s rounds): startup and a buffered next round, 1,024
   sessions (``init_client``, ``fetch_prompt_json``, a guess at both
   masks, half on rung 0 and half on the device rung, the masked image),
   scores equal to direct similarity (1e-5 on the device rung, 1e-2 of
   fp32 on rung 0), one promotion through the round timer (sessions
   reset, the buffered text current), and at tier 5 coarser blur buckets
   rounding up and the next buffered round at 256x256 under guess waves,
   counted in ``pipeline.brownout_images`` with its launches. Guess p50
   and p99, render p50 and promotion seconds;
14. the game server in this process ([server]): ``build_fabric`` and
   ``create_app(fabric, cfg, device_health=True)`` on 127.0.0.1 at a
   port the kernel picks, at ``FrameworkConfig()`` with 12 s rounds and
   an SLO loop at 0.5 s over 10 s and 60 s windows with a 1 ms p99
   threshold: /healthz's CUDA probe, /readyz, 64 sessions in parallel
   (/init, /fetch/contents, /compute_score, /client/status), a
   malformed body's 400, /clock through a rotation, the new round
   served, /metrics as JSON and Prometheus text (the device gauges from
   ``torch.cuda.memory_stats``), a ``traceparent`` continued and its
   spans at /debugz, /sloz; real burn (waves of 1,024 out-of-vocabulary
   guesses) until the app's own SLO loop has stepped the ladder, and
   the round the server then generates at the tier. Every round the
   server generates is tallied around ``t2i.generate``: at full quality
   as ``[round-default]``, at a tier as ``derived_round`` says, flash
   only at shapes phase 2 checks, on their checked paths. Throughout, the
   canary prober at 0.5 s ([canary]): at least 10 probes through the
   listener, all passing, those across the capture below too
   (``probe.e2e_s`` p50/p99, also of those across the capture; the near
   guess's rung), /readyz's
   canary block ok, /sloz's probe objectives with their
   traffic; a probe failing at leg ``score`` while every score dispatch
   raises (counted, ``probe.fail``, its trace at /debugz); a second app
   under ``CASSMANTLE_NO_PROBER=1`` leaving no probe artifact. And
   ([debug-trace]) ``POST /debug/trace?seconds=4`` while a round runs:
   200, a trace naming the flash kernel among its device events, a second
   POST meanwhile 409;
15. ``python -m cassmantle_tpu_torch serve`` as a child process
   ([serve-cli]) on a port picked by binding 127.0.0.1:0 (picked once
   more if the child cannot bind it), its output in the git-ignored
   ``_build/serve_cli.log``: /readyz 200 within 240 s, one session,
   /healthz's CUDA probe, its own canary prober's verdict ok at /readyz,
   then SIGINT: exit 0 within 30 s after the graceful handoff (SIGKILL and
   reaped otherwise, on every path), under ``CASSMANTLE_LEAK_SENTINEL=1``
   with its ``leaks.*`` counters reported. Boot-to-ready seconds;
16. a card worker in a two-worker fleet ([cluster]): the server of phase
   14 in this process at ``FrameworkConfig()`` (full width, 60 s rounds,
   4 rooms) over a replicated store of two mantlestore nodes of the
   port's own build (a leader and a follower, 1.5 s lease), with a
   ``--fake`` peer worker as a child process, both advertising their
   addresses and canary-probing at 2 s: the rooms spread over both
   workers; the peer answers a card room 307 to the card worker, the
   followed fetch the card's 512x512 JPEG in the same trace (the
   redirect's added milliseconds); ``/metrics?scope=cluster`` of each
   worker equal to ``merge_states`` of both workers' ``?format=state``;
   the canary of each worker ok on both; the store leader SIGKILLed
   under 16 guessing players: every guess answered, both workers on the
   follower within the failover grace, every round and a won score as
   before; the peer SIGINTed: its graceful handoff met, the card worker
   owning every room within ``handoff_grace_s``, then the next round of
   an adopted room generated on the card with a full round's launches.
   Every round the card worker generates is tallied as in phase 14, and
   the seconds of each step are printed;
17. the staged image server ([staged], ``serving/stages.py``):
   ``staged_serving_config()`` through ``InferenceService`` (a round's
   image on the staged path); solo images bit-equal to the monolithic
   path's for DDIM (one and two prompts), DPM++(2M), Euler, consistency
   and SDXL at 1024²; a mixed run (A; B, two prompts, admitted 5 steps
   in; C 5 steps after A retires) through widths 4, 2 and 1, each image
   within the monolithic path's own batch variance (row 0 of a
   two-prompt batch against the solo image) plus 0.5 of a level on the
   mean and 2 at the max, each width's graph captured once and
   bit-equal to its eager step (and widths 1 and 2 on identical rows
   reported); a deadline preempting at a step boundary beside a
   neighbour that finishes within the yardstick; a poisoned slot
   quarantined, scrubbed and clean for the next request; a profiled
   window at occupancy 4 (idle share <= 0.10, no synchronize call);
   each width's step ms, capture s and pool; the reference's Poisson
   A/B (12 requests at 0.6 a second, sizes 1, 1, 2) staged against
   monolithic on one pipeline; the fused-conv and W8A8 UNets staged
   (solo parity, a two-request run). Every staged launch is held to the
   shapes phase 2 checks, on the flash path its check took;
18. device observability ([obs-device], ``obs/costmodel.py``,
   ``utils/profiling.py``): every count the run reads is made from the
   configs on meta tensors in a child process while the kernels build.
   Each round of phase 4 and Mistral's attributes its two images'
   products, ``request.device_flops{t2i|sdxl}`` = the count x 2, its
   prompt decodes and guess encodes theirs (whole padded rows), each
   ``pipeline.mxu_utilization`` in (0, 1]; in [staged]'s A/B every
   retirement attributes one request's count and the monolithic arm its
   images'. The closing line sets each count beside the reference's
   committed entry (``data/cost_model.json``), the difference explained.
19. training on the card ([train-diffusion]): ``DiffusionTrainer`` on
   SD1.5 at 512x512, batch 2, bf16 compute over fp32 parameters: a
   differentiated forward outside ``plain_only`` refused by the flash
   kernel, which has no backward; the trainer's forward launching none;
   its gradient at one fixed draw against the fp32-compute gradient of
   the same parameters (cosine >= 0.99, every attention projection's
   gradient nonzero); ten steps at a fixed batch and draw lowering the
   loss; step ms (forward and backward, optimizer), peak GiB;
20. consistency distillation ([distill]): ``ConsistencyDistillTrainer``
   on SD1.5 for three steps, the teacher's and EMA target's forwards
   launching flash (two full forwards a step, shape for shape), then the
   student's ``state_dict`` serving a 4-step lcm round through
   ``Text2ImagePipeline`` (its UNet the student's weights, flash 129);
21. LM training ([train-lm]): the ``train-lm`` command (GPT-2 small, seq
   256, batch 8) four steps with a checkpoint directory, then ``python -m
   cassmantle_tpu_torch train-lm`` resuming at step 2 with the
   uninterrupted run's losses; Mistral-7B at its published widths cut to
   2 of 32 layers through ``LMTrainer``; tokens/s of each;
22. the quality gate ([clip]): the ViT-L/14 harness (fp32: its attention
   on the plain path) written as one seeded fp16 CLIPModel file and read
   back through the converters (every tensor equal); ``clip-report`` over
   the six presets, eight images each, on seeded weights (advisory);
   ``w8a8_quality_report`` on eight prompts; images/s of the scoring;
   the launches of kernels 1-4; then each kernel against its plain
   version at every shape phases 20 and 22 launch that phase 2 does not
   check ([kernel-spot]: flash at batch 16 and 32, kernel 2 at the
   batch-8 VAE and the batch-16 fused UNet, kernels 3 and 4 at the
   batch-16 W8A8 UNet).

Prints a ``[time]`` line after each phase, its total seconds, one
``kernels`` JSON line (each entry's launches and its ``staged_launches``),
the card line, and
as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
prints no result.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import faulthandler
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

from cassmantle_tpu_torch.config import UNetConfig

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# The SDXL builds [round-sdxl_*] serve: the UNet with the fused conv,
# W8A8 (bench.py:775-786: fused, conv_pad_to 128) and weights-only int8;
# and the reference's benched sdxl_encprop and sdxl_turbo rounds
SDXL_BUILDS = ("fused", "w8a8", "int8")
SDXL_ROUNDS = tuple(f"sdxl_{b}" for b in SDXL_BUILDS) + ("sdxl_encprop",
                                                       "sdxl_turbo")

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
    # the brownout tiers' shapes (serving/overload.py DEFAULT_TIERS). SD1.5
    # at 256x256 (tier 4: latent 32x32, so the UNet's levels at 32, 16 and
    # 8 and its mid block at 4; level 2 at 8x8 is self_mid's shape) and its
    # VAE mid block at 32x32
    "self_l0_256": (2, 1024, 1024, 8, 40, "self"),
    "cross_l0_256": (2, 1024, 77, 8, 40, "cross"),
    "self_l1_256": (2, 256, 256, 8, 80, "self"),
    "cross_l1_256": (2, 256, 77, 8, 80, "cross"),
    "self_mid_256": (2, 16, 16, 8, 160, "self"),
    "cross_mid_256": (2, 16, 77, 8, 160, "cross"),
    "vae_mid_256": (1, 1024, 1024, 1, 512, "separate"),
    # SDXL at 512x512 (tier 4: latent 64x64; its VAE mid block at 64x64
    # is vae_mid's shape)
    "self_x1_512": (2, 1024, 1024, 10, 64, "self"),
    "cross_x1_512": (2, 1024, 77, 10, 64, "cross"),
    "self_x2_512": (2, 256, 256, 20, 64, "self"),
    "cross_x2_512": (2, 256, 77, 20, 64, "cross"),
    # encoder propagation at stride 5 (tier 2): 4 propagated steps a
    # segment, so the decoder-only forward at batch 8
    "self_l0_b8": (8, 4096, 4096, 8, 40, "self"),
    "cross_l0_b8": (8, 4096, 77, 8, 40, "cross"),
    "self_l1_b8": (8, 1024, 1024, 8, 80, "self"),
    "cross_l1_b8": (8, 1024, 77, 8, 80, "cross"),
    "self_l2_b8": (8, 256, 256, 8, 160, "self"),
    "cross_l2_b8": (8, 256, 77, 8, 160, "cross"),
    # and at 256x256 (tiers 4 and 5 of the encprop preset)
    "self_l0_256_b8": (8, 1024, 1024, 8, 40, "self"),
    "cross_l0_256_b8": (8, 1024, 77, 8, 40, "cross"),
    "self_l1_256_b8": (8, 256, 256, 8, 80, "self"),
    "cross_l1_256_b8": (8, 256, 77, 8, 80, "cross"),
    "self_l2_256_b8": (8, 64, 64, 8, 160, "self"),
    "cross_l2_256_b8": (8, 64, 77, 8, 160, "cross"),
    # the staged server (serving/stages.py, 4 slots): a step runs the full
    # UNet at batch 2w for widths 1, 2 and 4, so at batch 4 and 8 too
    # (levels 0-2 are the *_b4 and *_b8 shapes above; the mid block
    # here), and the decode stage's VAE at batch 2 and 4
    "self_mid_b4": (4, 64, 64, 8, 160, "self"),
    "cross_mid_b4": (4, 64, 77, 8, 160, "cross"),
    "self_mid_b8": (8, 64, 64, 8, 160, "self"),
    "cross_mid_b8": (8, 64, 77, 8, 160, "cross"),
    "vae_mid_b2": (2, 4096, 4096, 1, 512, "separate"),
    "vae_mid_b4": (4, 4096, 4096, 1, 512, "separate"),
    # SDXL's decoder-only forward under encoder propagation (the up
    # path's levels 2 and 1) at batch 4 (stride 3, the sdxl_encprop
    # build) and 8 (stride 5, its brownout tiers), and at 512x512
    "self_x1_b4": (4, 4096, 4096, 10, 64, "self"),
    "cross_x1_b4": (4, 4096, 77, 10, 64, "cross"),
    "self_x2_b4": (4, 1024, 1024, 20, 64, "self"),
    "cross_x2_b4": (4, 1024, 77, 20, 64, "cross"),
    "self_x1_b8": (8, 4096, 4096, 10, 64, "self"),
    "cross_x1_b8": (8, 4096, 77, 10, 64, "cross"),
    "self_x2_b8": (8, 1024, 1024, 20, 64, "self"),
    "cross_x2_b8": (8, 1024, 77, 20, 64, "cross"),
    "self_x1_512_b8": (8, 1024, 1024, 10, 64, "self"),
    "cross_x1_512_b8": (8, 1024, 77, 10, 64, "cross"),
    "self_x2_512_b8": (8, 256, 256, 20, 64, "self"),
    "cross_x2_512_b8": (8, 256, 77, 20, 64, "cross"),
    # the spatially partitioned UNet at sp = 2 (parallel/spatial.py;
    # [mesh] (b) and (d)): each shard's queries, half the rows, against
    # every token's keys and values, gathered over sp ("spatial": q a view
    # of the shard's fused qkv, k and v the gathered copies), and the
    # shard's queries against the context. SD1.5 at 512², SDXL at 1024²
    "self_l0_sp2": (2, 2048, 4096, 8, 40, "spatial"),
    "cross_l0_sp2": (2, 2048, 77, 8, 40, "cross"),
    "self_l1_sp2": (2, 512, 1024, 8, 80, "spatial"),
    "cross_l1_sp2": (2, 512, 77, 8, 80, "cross"),
    "self_l2_sp2": (2, 128, 256, 8, 160, "spatial"),
    "cross_l2_sp2": (2, 128, 77, 8, 160, "cross"),
    "self_mid_sp2": (2, 32, 64, 8, 160, "spatial"),
    "cross_mid_sp2": (2, 32, 77, 8, 160, "cross"),
    "self_x1_sp2": (2, 2048, 4096, 10, 64, "spatial"),
    "cross_x1_sp2": (2, 2048, 77, 10, 64, "cross"),
    "self_x2_sp2": (2, 512, 1024, 20, 64, "spatial"),
    "cross_x2_sp2": (2, 512, 77, 20, 64, "cross"),
}
# the shapes only the [mesh] phase launches
SPATIAL_FLASH = tuple(name for name in FLASH_SHAPES
                      if name.endswith("_sp2"))
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
# The brownout tiers' forwards: SD1.5's full forward at 256x256, the
# decoder-only forward at batch 8 at 512x512 and 256x256, and SDXL's
# full forward at 1024 and 512 (5 x 2 blocks at level 1, 5 x 10 + 10 mid
# at level 2).
TIER_UNET_FLASH = {
    "full_256": {"self_l0_256": 5, "cross_l0_256": 5, "self_l1_256": 5,
                 "cross_l1_256": 5, "self_mid": 5, "cross_mid": 5,
                 "self_mid_256": 1, "cross_mid_256": 1},
    "decoder_only_b8": {"self_l0_b8": 3, "cross_l0_b8": 3, "self_l1_b8": 3,
                        "cross_l1_b8": 3, "self_l2_b8": 3, "cross_l2_b8": 3},
    "decoder_only_b8_256": {
        "self_l0_256_b8": 3, "cross_l0_256_b8": 3, "self_l1_256_b8": 3,
        "cross_l1_256_b8": 3, "self_l2_256_b8": 3, "cross_l2_256_b8": 3},
    "sdxl_full": {"self_x1": 10, "cross_x1": 10, "self_x2": 60,
                  "cross_x2": 60},
    "sdxl_full_512": {"self_x1_512": 10, "cross_x1_512": 10,
                      "self_x2_512": 60, "cross_x2_512": 60},
    # SDXL's decoder-only forward: the up path's 3 transformers at level
    # 1 (depth 2) and 3 at level 2 (depth 10); its DeepCache shallow
    # forward runs level 0 alone, which has no attention
    "sdxl_decoder_only_b4": {"self_x1_b4": 6, "cross_x1_b4": 6,
                             "self_x2_b4": 30, "cross_x2_b4": 30},
    "sdxl_decoder_only_b8": {"self_x1_b8": 6, "cross_x1_b8": 6,
                             "self_x2_b8": 30, "cross_x2_b8": 30},
    "sdxl_decoder_only_b8_512": {
        "self_x1_512_b8": 6, "cross_x1_512_b8": 6, "self_x2_512_b8": 30,
        "cross_x2_512_b8": 30},
    "sdxl_shallow": {},
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


def tier_flash(forwards: dict, vae: str) -> dict:
    """Flash launches per shape name of one round at a brownout tier: its
    UNet forwards by mode, and its VAE mid block's shape."""
    out = {vae: 1}
    for mode, n in forwards.items():
        for name, k in {**UNET_FLASH, **TIER_UNET_FLASH}[mode].items():
            out[name] = out.get(name, 0) + k * n
    return out


# The [brownout] cells (preset@tier; serving/overload.py DEFAULT_TIERS
# through degraded_sampler_cfg): DDIM at 30 steps (0.6 x 50) from tier 1,
# 961 launches (30 x 32 + 1) at 512x512 or 256x256; four consistency
# steps at tier 3 where the UNet is declared a distilled student, 129;
# encprop's stride 3 + 2 = 5 from tier 2, 10 key forwards and 5
# decoder-only ones at batch 8, 411 (10 x 32 + 5 x 18 + 1) at 512x512 or
# 256x256; SDXL at 30 steps, 4,201 (30 x 140 + 1) at 1024x1024 or
# 512x512.
ROUND_FLASH.update({
    "default@t1": tier_flash({"full": 30}, "vae_mid"),
    "default@t4": tier_flash({"full_256": 30}, "vae_mid_256"),
    "consistency@t3": tier_flash({"full": 4}, "vae_mid"),
    "encprop@t2": tier_flash({"full": 10, "decoder_only_b8": 5}, "vae_mid"),
    "encprop@t4": tier_flash({"full_256": 10, "decoder_only_b8_256": 5},
                             "vae_mid_256"),
    "sdxl@t1": tier_flash({"sdxl_full": 30}, "vae_mid_xl"),
    "sdxl@t4": tier_flash({"sdxl_full_512": 30}, "vae_mid"),
})
# The staged server's shapes ([staged], 4 slots): one step at each width
# 1, 2 and 4 (a full SD1.5 forward at batch 2, 4 and 8: levels 0-2 at the
# *_b4 and *_b8 shapes, the mid block at its own) and one decode at each
# decode batch 1, 2 and 4 (the VAE mid block). Its runs' launches are
# tallied as they ran (staged_shape_gaps holds them to phase 2's shapes).
ROUND_FLASH["staged"] = {
    **UNET_FLASH["full"],
    **{f"{name}_b{b}": n for b in (4, 8)
       for name, n in UNET_FLASH["full"].items()},
    "vae_mid": 1, "vae_mid_b2": 1, "vae_mid_b4": 1}
# The SDXL builds of this slice (sdxl_config() as the reference benches
# them, one seeded weight set): fused conv, W8A8 and weights-only int8
# run DDIM-50 as [round-sdxl] does (7,001); sdxl_encprop 20 key forwards
# and 15 decoder-only ones at batch 4 (20 x 140 + 15 x 72 + 1 = 3,881);
# sdxl_turbo DPM++(2M)-24 with DeepCache, 12 full and 12 shallow
# forwards (12 x 140 + 1 = 1,681)
ROUND_FLASH.update({
    "sdxl_encprop": tier_flash({"sdxl_full": 20,
                                "sdxl_decoder_only_b4": 15}, "vae_mid_xl"),
    "sdxl_turbo": tier_flash({"sdxl_full": 12, "sdxl_shallow": 12},
                             "vae_mid_xl"),
    # its brownout tiers (derived and checked, not driven): stride 5 at
    # 1024 (tier 2) and at 512 (tier 4), decoder-only forwards at batch 8
    "sdxl_encprop@t2": tier_flash({"sdxl_full": 10,
                                   "sdxl_decoder_only_b8": 5}, "vae_mid_xl"),
    "sdxl_encprop@t4": tier_flash({"sdxl_full_512": 10,
                                   "sdxl_decoder_only_b8_512": 5},
                                  "vae_mid"),
})
# one row's round at sp = 2 ([mesh] (d), SD1.5; SDXL's at its (b)
# forward's shapes): every UNet site once a position, at the spatial
# shapes; the VAE decodes the gathered latents
for _model in ("sd15", "sdxl"):
    ROUND_FLASH[f"{_model}_sp2"] = {
        (name if name.startswith("vae") else f"{name}_sp2"):
        (n if name.startswith("vae") else 2 * n)
        for name, n in ROUND_FLASH[_model].items()}
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
                **{sampler: sampler for sampler in SAMPLER_FORWARDS},
                **{cell: cell for cell in ROUND_FLASH if "@" in cell},
                "fusedconv@t4": "default@t4", "w8a8@t4": "default@t4",
                "game@t5": "default@t4",
                **{f"sdxl_{b}": "sdxl" for b in SDXL_BUILDS},
                "sdxl_encprop": "sdxl_encprop", "sdxl_turbo": "sdxl_turbo"}
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


def conv_shapes_at(shapes: dict, size: int, base: int = 512) -> dict:
    """A table of conv3x3 shapes at ``base`` pixels, at ``size``: the same
    layers at the scaled height and width."""
    return {(b, h * size // base, w * size // base, c, f): n
            for (b, h, w, c, f), n in shapes.items()}


def arch_conv_shapes(unet: UNetConfig, size: int, batch: int = 2) -> dict:
    """Every ResBlock conv3x3 of one UNet forward at ``size`` pixels, from
    its config (``models/unet.py``'s layout): (B, H, W, C, F) ->
    launches. Each ResBlock runs conv1 (C -> F) and conv2 (F -> F); the
    down path's blocks, a downsample between levels, the mid block's two
    ResBlocks, then the up path's blocks + 1 a level, each on the skip
    concatenated."""
    chans = [unet.base_channels * m for m in unet.channel_mults]
    out = collections.Counter()
    h, ch = size // 8, unet.base_channels
    skips = [ch]
    for level, c in enumerate(chans):
        for _ in range(unet.blocks_per_level):
            out[(batch, h, h, ch, c)] += 1
            out[(batch, h, h, c, c)] += 1
            ch = c
            skips.append(ch)
        if level < len(chans) - 1:
            h //= 2
            skips.append(ch)
    out[(batch, h, h, ch, ch)] += 4
    for level in reversed(range(len(chans))):
        c = chans[level]
        for _ in range(unet.blocks_per_level + 1):
            out[(batch, h, h, ch + skips.pop(), c)] += 1
            out[(batch, h, h, c, c)] += 1
            ch = c
        if level:
            h *= 2
    return dict(out)


def arch_matmul_shapes(unet: UNetConfig, size: int, batch: int = 2,
                       context_tokens: int = 77) -> dict:
    """Every W8A8 dense site of one UNet forward at ``size`` pixels, from
    its config: (M, K, N) -> launches. A level with attention runs a
    transformer of its depth after each down ResBlock and each up one
    (blocks + 1), the mid block one of the deepest attended depth; each
    transformer block runs self qkv and out, cross q, kv (over the
    batch's 77 context tokens) and out, GEGLU proj and out."""
    out = collections.Counter()
    lat = size // 8
    attended = [(level, depth) for level, (on, depth) in enumerate(zip(
        unet.attention_levels, unet.transformer_depth)) if on and depth]
    sites = [(unet.base_channels * unet.channel_mults[level], lat >> level,
              depth * (2 * unet.blocks_per_level + 1))
             for level, depth in attended]
    deepest = len(unet.channel_mults) - 1
    sites.append((unet.base_channels * unet.channel_mults[-1],
                  lat >> deepest, max([d for _, d in attended] or [1])))
    for c, h, blocks in sites:
        m = batch * h * h
        for shape, n in (((m, c, 3 * c), 1), ((m, c, c), 3),
                         ((m, c, 8 * c), 1), ((m, 4 * c, c), 1),
                         ((batch * context_tokens, unet.context_dim, 2 * c),
                          1)):
            out[shape] += n * blocks
    return dict(out)


SD15_UNET, SDXL_UNET = UNetConfig(), UNetConfig.sdxl()
# Every ResBlock conv3x3 of one SD1.5-512 UNet forward with CFG (44: 22
# ResBlocks) and its 112 W8A8 dense sites (16 transformer blocks x 7);
# the fused kernel runs the convs under fusedconv_serving_config(), the
# int8 conv and matmul under w8a8_serving_config().
CONV_SHAPES = arch_conv_shapes(SD15_UNET, 512)
UNET_MATMUL_SHAPES = arch_matmul_shapes(SD15_UNET, 512)
# SDXL's at 1024x1024 (34 convs: 17 ResBlocks; 490 dense sites: 70
# transformer blocks x 7) and the VAE decoder's under sdxl_encprop
SDXL_CONV_SHAPES = arch_conv_shapes(SDXL_UNET, 1024)
SDXL_MATMUL_SHAPES = arch_matmul_shapes(SDXL_UNET, 1024)
# GPT-2's W8A8 projections per layer (q, k, v, out, fc1, fc2) at M = 32
# (prefill: one prompt in the 32-token bucket) and M = 1 (decode).
GPT2_KN = {(768, 768): 4, (768, 3072): 1, (3072, 768): 1}
GPT2_LAYERS = 12
LM_MATMUL_SHAPES = {(m, k, n): c * GPT2_LAYERS * (1 if m == 32 else 95)
                    for m in (32, 1) for (k, n), c in GPT2_KN.items()}
# the UNet's conv3x3 and W8A8 dense sites at 256x256 (brownout tier 4):
# the same layers at half the width and height, M a quarter; and the
# SD1.5 VAE decoder's (the encprop preset's fused decoder) at 256x256
TIER_CONV_SHAPES = conv_shapes_at(CONV_SHAPES, 256)
TIER_UNET_MATMUL_SHAPES = arch_matmul_shapes(SD15_UNET, 256)
VAE_CONV_SHAPES["sd15_256"] = conv_shapes_at(VAE_CONV_SHAPES["sd15"],
                                             256)
# the staged server's two-request runs of the fused-conv and W8A8 presets
# (widths 1 and 2): the UNet's convs and W8A8 sites at batch 4 beside 2
STAGED_CONV_SHAPES = {(4,) + shape[1:]: n for shape, n in CONV_SHAPES.items()}
STAGED_UNET_MATMUL_SHAPES = arch_matmul_shapes(SD15_UNET, 512, batch=4)
# [calibrate]'s eager forwards of the fused SD1.5 UNet over 8 prompts
CALIBRATE_CONV_SHAPES = {(8,) + shape[1:]: n
                         for shape, n in CONV_SHAPES.items()}
# the SDXL builds' brownout tier 4 (512x512): the same layers at 64x64
# latents (its convs are SD1.5's at 512x512, W8A8's M a quarter)
SDXL_TIER_CONV_SHAPES = arch_conv_shapes(SDXL_UNET, 512)
SDXL_TIER_MATMUL_SHAPES = arch_matmul_shapes(SDXL_UNET, 512)
# the shapes phase 2 holds each kernel at against its plain version
FUSED_CHECK_SHAPES = list(dict.fromkeys(
    [*CONV_SHAPES, *TIER_CONV_SHAPES,
     *(shape for table in VAE_CONV_SHAPES.values() for shape in table),
     *STAGED_CONV_SHAPES, *SDXL_CONV_SHAPES, *SDXL_TIER_CONV_SHAPES,
     *CALIBRATE_CONV_SHAPES]))
MATMUL_CHECK_SHAPES = list(dict.fromkeys(
    [*UNET_MATMUL_SHAPES, *TIER_UNET_MATMUL_SHAPES, *LM_MATMUL_SHAPES,
     *STAGED_UNET_MATMUL_SHAPES, *SDXL_MATMUL_SHAPES,
     *SDXL_TIER_MATMUL_SHAPES]))
INT8_CONV_CHECK_SHAPES = list(dict.fromkeys([*CONV_SHAPES,
                                             *TIER_CONV_SHAPES,
                                             *STAGED_CONV_SHAPES,
                                             *SDXL_CONV_SHAPES,
                                             *SDXL_TIER_CONV_SHAPES]))
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


# launches a [kernel] timing captures in one graph (it was 20: cut with
# the replays to 2 to make room for the training phases)
KERNEL_ITERS = 10


def time_ms(fn, iters: int, replays: int = 2) -> float:
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
    elif layout == "spatial":
        q = torch.randn((b, sq, 3 * inner), **kw).split(inner, dim=-1)[0]
        k, v = (torch.randn((b, sk, inner), **kw) for _ in range(2))
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
        ms = time_ms(lambda: flash_attention(q, k, v), KERNEL_ITERS)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), 2)
        # the library yardstick: one SDPA call on (B, H, S, D) copies
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            KERNEL_ITERS)
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
    """Kernel 2 vs plain at the UNet's ResBlock conv shapes at 512x512 and
    256x256 (brownout tier 4, down to W = 4), the VAE
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
    for shape in FUSED_CHECK_SHAPES:
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
        ms = time_ms(lambda: gn_silu_conv3x3(x, a, shift, kernel, bias),
                     KERNEL_ITERS)
        plain_ms = time_ms(
            lambda: gn_silu_conv3x3_plain(x, a, shift, kernel, bias), 2)
        act = F.silu(x.float() * a[:, None, None] + shift[:, None, None]) \
            .bfloat16().permute(0, 3, 1, 2)
        w_oihw = ohwi.permute(0, 3, 1, 2)
        bias16 = bias.bfloat16()
        library_ms = time_ms(
            lambda: F.conv2d(act, w_oihw, bias16, padding=1), KERNEL_ITERS)
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
    """Kernel 3 vs plain at the UNet's (M, K, N) at 512x512 and at the
    brownout tiers' 256x256 (one per-tensor scale, stride 0) and the
    GPT-2 prefill and decode shapes (per-token scales),
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
    for shape in MATMUL_CHECK_SHAPES:
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
        ms = time_ms(lambda: int8_matmul(*args), KERNEL_ITERS)
        plain_ms = time_ms(lambda: int8_matmul_plain(*args), 2)
        library_ms = (time_ms(lambda: torch._int_mm(x_q, w_q),
                              KERNEL_ITERS)
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
    """Kernel 4 vs plain at the ResBlock conv shapes of the 512x512 and
    256x256 (brownout tier 4) UNet, int8 operands
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
    for shape in INT8_CONV_CHECK_SHAPES:
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
        ms = time_ms(lambda: int8_conv3x3(*args), KERNEL_ITERS)
        plain_ms = time_ms(lambda: int8_conv3x3_plain(*args), 2)
        cols = int8_im2col(x_q)
        w_kn = kernel.permute(3, 0, 1, 2).reshape(f, 9 * c).t()
        library_ms = time_ms(lambda: torch._int_mm(cols, w_kn), KERNEL_ITERS)
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


# fp8 (e4m3) operands: the card's tensor cores keep about 14 bits of an
# fp8 product's fp32 sum (not a full fp32 accumulator), so the library
# product stays within 2^-10 of max |plain| where the plain fp32 one is
# exact to 2^-24 at these depths
FP8_MAX_REL = 2.0 ** -10


def check_w8a8_entry_points():
    """The W8A8 entry points at SDXL's shapes, the site's static scale
    beside the dynamic absmax (the static path skips the absmax pass
    before kernels 3 and 4), each against its plain composition (the
    same quantize, then the kernel's plain version; equal); and one fp8
    row: ``torch._scaled_mm`` (``ops/quant_matmul.py::fp8_matmul``)
    against the plain fp32 product of the same fp8 operands. [kernel]
    lines; returns {label: row}."""
    import torch

    from cassmantle_tpu_torch.ops import quant
    from cassmantle_tpu_torch.ops import quant_matmul as qm

    rows = {}
    gen = torch.Generator("cuda").manual_seed(4)
    kw = dict(generator=gen, device="cuda")
    # dense: SDXL's level-1 self-attention out projection (M 8192, 640)
    m, k, n = 8192, 640, 640
    x = torch.randn((m, k), dtype=torch.bfloat16, **kw)
    w = torch.randn((k, n), **kw) / k ** 0.5
    bias = torch.randn((n,), **kw) * 0.1
    absmax = float(x.float().abs().max())
    for mode in ("dynamic", "static"):
        act = None if mode == "dynamic" else quant.act_scale_from_absmax(
            absmax).cuda()
        q = quant.quantize_tensor_act(w, axis=-1, act_scale=act)
        # the modules' (out, in) memory, as Dense hands it over
        q = q._replace(data=q.data.t().contiguous().t())
        out = qm.w8a8_dense(x, q, bias)
        scale = (quant.act_scale_from_absmax(quant.act_absmax(x))
                 if act is None else act)
        ref = qm.int8_matmul_plain(quant.quantize_act(x, scale), q.data,
                                   scale, q.scale, bias, torch.bfloat16)
        agree = exact_agreement(out, ref)
        ms = time_ms(lambda: qm.w8a8_dense(x, q, bias), KERNEL_ITERS)
        plain_ms = time_ms(lambda: qm.int8_matmul_plain(
            quant.quantize_act(x, scale), q.data, scale, q.scale, bias,
            torch.bfloat16), 2)
        rows[f"w8a8_dense[{mode}]"] = report_row(
            f"w8a8_dense[{mode}]", "(M, K, N)", (m, k, n), agree, ms,
            plain_ms, None, "", 2 * m * k * n,
            2 * m * k + k * n + 2 * m * n, PEAK_INT8_OPS)
    # conv: SDXL's level-0 ResBlock conv (128x128, 320 -> 320)
    b, h, wd, c, f = 2, 128, 128, 320, 320
    act_in = torch.randn((b, h, wd, c), dtype=torch.bfloat16, **kw)
    wk = torch.randn((3, 3, c, f), **kw) / (9 * c) ** 0.5
    cb = torch.randn((f,), **kw) * 0.1
    amax = float(act_in.float().abs().max())
    for mode in ("dynamic", "static"):
        act = None if mode == "dynamic" else quant.act_scale_from_absmax(
            amax).cuda()
        q = quant.quantize_tensor_act(wk, axis=-1, act_scale=act)
        # the modules' OHWI memory (OIHW channels-last)
        q = q._replace(data=q.data.permute(3, 0, 1, 2).contiguous()
                       .permute(1, 2, 3, 0))
        out = qm.w8a8_conv3x3(act_in, q, cb)
        scale = (quant.act_scale_from_absmax(quant.act_absmax(act_in))
                 if act is None else act)
        ref = qm.int8_conv3x3_plain(quant.quantize_act(act_in, scale),
                                    q.data, scale * q.scale, cb,
                                    torch.bfloat16)
        agree = exact_agreement(out, ref)
        ms = time_ms(lambda: qm.w8a8_conv3x3(act_in, q, cb), KERNEL_ITERS)
        plain_ms = time_ms(lambda: qm.int8_conv3x3_plain(
            quant.quantize_act(act_in, scale), q.data, scale * q.scale, cb,
            torch.bfloat16), 2)
        rows[f"w8a8_conv3x3[{mode}]"] = report_row(
            f"w8a8_conv3x3[{mode}]", "(B, H, W, C, F)", (b, h, wd, c, f),
            agree, ms, plain_ms, None, "", 18 * b * h * wd * c * f,
            2 * b * h * wd * c + 9 * c * f + 2 * b * h * wd * f,
            PEAK_INT8_OPS)
    # fp8: the library product of an fp8 leaf against its plain version
    fp8 = torch.float8_e4m3fn
    q = quant.quantize_tensor_act(w, axis=-1, dtype=fp8)
    xs = quant.act_scale_from_absmax(quant.act_absmax(x), fp8)
    x8 = quant.quantize_act(x, xs, fp8)
    out = qm.fp8_matmul(x8, q.data)
    ref = qm.fp8_matmul_plain(x8, q.data)
    err = (out - ref).abs().max().item()
    limit = FP8_MAX_REL * ref.abs().max().item()
    agree = dict(max_abs_err=err, ok=err <= limit, text=(
        f"max_abs_err {err:.3e} (limit 2^-10 of max |plain| = "
        f"{limit:.3e})"))
    ms = time_ms(lambda: qm.fp8_matmul(x8, q.data), KERNEL_ITERS)
    plain_ms = time_ms(lambda: qm.fp8_matmul_plain(x8, q.data), 2)
    rows["fp8_matmul"] = report_row(
        "fp8_matmul (torch._scaled_mm, a library call)", "(M, K, N)",
        (m, k, n), agree, ms, plain_ms, ms, "torch._scaled_mm",
        # the H100's fp8 peak is its int8 peak
        2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8_OPS)
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
                  else gpu.full_variant.step_graphs)
        res = dict(card_vs_fp32_max=int(d_gpu.max()),
                   card_vs_fp32_mean=float(d_gpu.mean()),
                   cpu_bf16_vs_fp32_max=int(d_cpu.max()),
                   cpu_bf16_vs_fp32_mean=float(d_cpu.mean()),
                   card_decoded_finite=gpu.last_decoded_finite,
                   sampler_mode=gpu.full_variant.mode,
                   encprop_step_counts=gpu.full_variant.encprop_counts,
                   graphs={str(k): sorted(g.graphs)
                           for k, g in graphs.items()},
                   flash_launches=flash_attention.flash_attention.launches,
                   fused_conv_launches=fused_conv.gn_silu_conv3x3.launches)
        ok = (d_gpu.mean() <= d_cpu.mean() + 0.5
              and d_gpu.max() <= d_cpu.max() + 2 and gpu.last_decoded_finite
              and gpu.full_variant.mode == mode == cpu.full_variant.mode
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
    ``preset`` (or of a [brownout] cell)."""
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
    sdxl_convs = scaled(SDXL_CONV_SHAPES, UNET_FORWARDS)
    if preset == "sdxl_fused":
        return {**base, "gn_silu_conv3x3": sdxl_convs}
    if preset == "sdxl_w8a8":
        return {**base, "int8_conv3x3": sdxl_convs, "int8_matmul": scaled(
            SDXL_MATMUL_SHAPES, UNET_FORWARDS)}
    if preset == "sdxl_encprop":     # SDXL's fused VAE decoder, once
        return {**base, "gn_silu_conv3x3": dict(VAE_CONV_SHAPES["sdxl"])}
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
# the loop each preset's pipeline serves (its full_variant's mode)
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


# -- the cost model's counts ([obs-device]) -----------------------------------

# the prompt buckets and new tokens a round's decode runs at
COST_BUCKETS = (32, 64, 128)
# the reference's committed per-item FLOPs (data/cost_model.json) the
# [obs-device] line sets beside each pipeline's count, by preset
COMMITTED_ENTRY = {"default": "t2i", "fusedconv": "t2i",
                   "w8a8": "t2i_w8a8", "sdxl": "sdxl", "lcm": "t2i_lcm",
                   "mistral": "t2i", "weights": "t2i"}
# what the port counts that the reference's committed entry does not, or
# the reverse, by entry
COMMITTED_DIFF = {
    "t2i_w8a8": "the reference's trace does not enter kernel 4's "
                "pallas_call bodies: its count omits the int8 3x3 convs' "
                "products (32.65e12 an image); the port counts them, in "
                "the int8 class",
    "prompt": "the reference counts 2 x params a token; the port the "
              "matmuls: the linears, the fp32 tied head, attention over "
              "the static cache (within 0.1% at bucket 32)",
    "scorer": "the reference counts 2 x params a token, the embedding "
              "tables and norms included; the port the matmuls and "
              "attention",
}
# device FLOPs and mxu readings of the run, by preset or cell
OBS_DEVICE = {}


def cost_configs() -> list:
    """Every config whose dispatches the run attributes: the served
    presets, [server]'s and [weights]' (the default's models and sampler),
    [staged]'s service and [round-mistral]'s depth cut."""
    from cassmantle_tpu_torch.config import staged_serving_config

    return [cfg for _, cfg in served_presets()] + [
        staged_serving_config(), mistral_round_config()]


# child processes that make the counts, each a share of the configs
COUNT_PROCESSES = 3


def precount_costs(part: int = 0, parts: int = 1) -> dict:
    """{"kind|signature": products} of every count the run's dispatches
    read at full quality (``obs/costmodel.py``), made from the configs
    alone on meta tensors: those of every ``parts``-th config from
    ``part`` on (the scorer's in part 0). Runs in child processes beside
    the build, so the pipelines' first dispatches find their counts made;
    a brownout tier's variant is counted on its pipeline's thread as it
    engages."""
    import torch

    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
    from cassmantle_tpu_torch.serving.pipeline import (
        PromptGenerator,
        Text2ImagePipeline,
    )
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

    torch.set_num_threads(1)
    entries = []
    for cfg in cost_configs()[part::parts]:
        cls = (SDXLPipeline if cfg.models.clip_text_2 is not None
               else Text2ImagePipeline)
        twin = cls.shape_twin(cfg)
        # a staged request's count where the config serves staged
        entries += twin.cost_entries()[:2 if cfg.serving.staged_serving
                                       else 1]
        gen = PromptGenerator.shape_twin(cfg)
        for bucket in COST_BUCKETS:
            entries += gen.cost_entries(bucket, cfg.sampler.max_new_tokens)
    if part == 0:
        entries += EmbeddingScorer.shape_twin(
            FrameworkConfig().models.minilm).cost_entries()
    out = {}
    for kind, sig, counter in entries:
        key = f"{kind}|{sig}"
        if key not in out:
            out[key] = list(counter())
    return out


def seed_costs(counts: dict) -> None:
    """Load :func:`precount_costs`' counts into this process's cache."""
    from cassmantle_tpu_torch.obs import costmodel

    for key, ops in counts.items():
        kind, sig = key.split("|", 1)
        costmodel.flops_per_item(kind, sig,
                                 lambda ops=ops: costmodel.Products(*ops))


def device_flops(pipeline: str) -> float:
    """``request.device_flops{pipeline}`` so far."""
    from cassmantle_tpu_torch.utils.logging import metrics

    return metrics.snapshot()["counters"].get(
        f'request.device_flops{{pipeline="{pipeline}"}}', 0.0)


def mxu_gauge(pipeline: str):
    """``pipeline.mxu_utilization{pipeline}`` now (None: never set)."""
    from cassmantle_tpu_torch.utils.logging import metrics

    return metrics.snapshot()["gauges"].get(
        f'pipeline.mxu_utilization{{pipeline="{pipeline}"}}')


def obs_device_reading(preset: str, kind: str, per_item, flops: float,
                       items: int, gauge) -> dict:
    """One [obs-device] entry: the count an item (by class), the FLOPs the
    dispatches attributed against count x items, the gauge, and the
    reference's committed entry with the difference explained."""
    entry = COMMITTED_ENTRY.get(preset) if kind in ("t2i", "sdxl") else \
        kind if kind in ("prompt", "scorer") else None
    committed = None
    if entry is not None:
        with open(os.path.join(REPO, "data", "cost_model.json")) as f:
            committed = json.load(f)["pipelines"][entry]["flops_per_item"]
    want = per_item.total * items if per_item is not None else None
    return {"pipeline": kind, "count_per_item": (per_item.as_dict()
                                                 if per_item else None),
            "items": items, "device_flops": flops, "expected": want,
            "equal": want is not None and flops == want,
            "mxu_utilization": gauge,
            "mxu_in_range": gauge is not None and 0.0 < gauge <= 1.0,
            "committed_entry": entry, "committed_flops_per_item": committed,
            "committed_diff": (None if committed is None or per_item is None
                               else per_item.total - committed),
            "committed_note": COMMITTED_DIFF.get(entry)}


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

    from cassmantle_tpu_torch.obs import costmodel

    image_kind = svc.backend.t2i.PIPELINE
    flops0 = {k: device_flops(k) for k in (image_kind, "prompt")}
    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()
    t0 = time.perf_counter()
    rc = asyncio.run(svc.generate_content("The Night the Trains Sang"))
    round_s = time.perf_counter() - t0
    replays = {name: g.replays for name, g in
               svc.backend.t2i.full_variant.step_graphs[1].graphs.items()}
    t1 = time.perf_counter()
    scorer_flops0 = device_flops("scorer")
    sims = asyncio.run(svc.similarity(pairs))
    score_s = time.perf_counter() - t1
    scorer_flops = device_flops("scorer") - scorer_flops0
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
    # [obs-device]: the two images' attributed FLOPs against the count
    per_image = costmodel.cached(image_kind, t2i.cost_signature())[1]
    obs = obs_device_reading(preset, image_kind, per_image,
                             device_flops(image_kind) - flops0[image_kind],
                             2, mxu_gauge(image_kind))
    prompt_flops = device_flops("prompt") - flops0["prompt"]
    obs_prompt = {"device_flops": prompt_flops,
                  "mxu_utilization": mxu_gauge("prompt")}
    # the guesses that missed the table: padded encode batches, each a
    # whole number of rows
    row = costmodel.cached(*svc.scorer.cost_entries()[0][:2])[1]
    obs_scorer = {"device_flops": scorer_flops,
                  "rows": scorer_flops / row.total if row else None,
                  "mxu_utilization": mxu_gauge("scorer")}
    OBS_DEVICE[preset] = {"image": obs, "prompt": obs_prompt,
                          "scorer": obs_scorer}

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
    mode = t2i.full_variant.mode
    checks["sampler_mode"] = mode == SAMPLER_MODE.get(preset, "ddim")
    checks["graph_replays"] = replays == GRAPH_REPLAYS.get(preset,
                                                           {"step": 50})
    if preset in SAMPLER_FORWARDS:
        checks["unet_forwards"] = (unet_forwards(replays)
                                   == SAMPLER_FORWARDS[preset])
    checks["encprop_step_counts"] = t2i.full_variant.encprop_counts == (
        (20, 0, 30) if mode == "encprop" else None)
    checks["device_flops_count_x_images"] = obs["equal"]
    checks["mxu_utilization_in_range"] = obs["mxu_in_range"]
    checks["prompt_flops_attributed"] = (
        prompt_flops > 0 and 0.0 < (obs_prompt["mxu_utilization"] or 0.0)
        <= 1.0)
    checks["scorer_flops_whole_rows"] = (
        scorer_flops > 0 and obs_scorer["rows"] is not None
        and obs_scorer["rows"] == int(obs_scorer["rows"])
        and 0.0 < (obs_scorer["mxu_utilization"] or 0.0) <= 1.0)
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
        encprop_step_counts=t2i.full_variant.encprop_counts,
        obs_device={"image": {k: obs[k] for k in (
            "device_flops", "expected", "mxu_utilization")},
            "prompt": obs_prompt, "scorer": obs_scorer},
        text_fallbacks=svc.backend.text_fallbacks,
        prompt_text=rc.prompt_text, scores=[float(s) for s in sims],
        image_mean=float(img.mean()), image_std=float(img.std()),
        lm=lm, checks=checks)
    print(f"[round-{preset}] {json.dumps(report)}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    return svc, tallies, bad


def consistency_student_config():
    """``FrameworkConfig()`` with its UNet declared a consistency-distilled
    student (``consistency_available``): the ladder's few-step tier 3
    serves four consistency steps instead of degrading like tier 2."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig

    base = FrameworkConfig()
    return base.replace(sampler=dataclasses.replace(
        base.sampler, consistency_available=True))


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


@contextlib.contextmanager
def device_profile_beside_graphs():
    """:func:`device_profile` switched on and off under
    ``ops/graphs.py::no_graph_running``, for a window while another
    thread launches CUDA graphs: the profiler's switch beside a
    ``cudaGraphLaunch`` can deadlock (a stop beside a staged denoise
    replay hung a whole run)."""
    from cassmantle_tpu_torch.ops.graphs import no_graph_running

    prof = device_profile()
    with no_graph_running():
        prof.start()
    try:
        yield prof
    finally:
        with no_graph_running():
            prof.stop()


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
    ts = torch.from_numpy(
        t2i.full_variant.schedule.timesteps.astype("int32")).to(dev)
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

        graph = t2i.full_variant.step_graphs[1]       # the round's, warm
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
                 if preset == "img2img" else t2i.full_variant.step_graphs[1])
        synchronize(dev)                              # warm: the round's
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
        graphs = {f"{b}/{name}": g
                  for b, sg in t2i.full_variant.step_graphs.items()
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


# [round-mistral]'s depth cut (of 32): the round, its graphs, profile,
# [spec] and [sampled] run Mistral-7B's widths at 8 layers (all 32 ran
# before the training phases needed the time)
ROUND_MISTRAL_LAYERS = 8


def mistral_round_config():
    """:func:`mistral_config` cut to :data:`ROUND_MISTRAL_LAYERS`."""
    import dataclasses

    cfg = mistral_config()
    return cfg.replace(models=dataclasses.replace(
        cfg.models, mistral=dataclasses.replace(
            cfg.models.mistral, num_layers=ROUND_MISTRAL_LAYERS)))


def sdxl_build_config(name: str):
    """``sdxl_config()`` as each SDXL round of this slice serves it:
    ``sdxl_fused`` with the fused conv (conv_pad_to 128), ``sdxl_w8a8``
    the reference's benched W8A8 config (bench.py:775-786: fused, pad
    128, unet_w8a8), ``sdxl_int8`` the weights-only int8 UNet;
    ``sdxl_encprop`` encoder propagation with the fused VAE decoder and
    ``sdxl_turbo`` DPM++(2M)-24 with DeepCache (bench.py:247-262,
    591-604)."""
    import dataclasses

    from cassmantle_tpu_torch.config import sdxl_config

    cfg = sdxl_config()
    m, s = cfg.models, cfg.sampler
    fused = dataclasses.replace(m.unet, fused_conv=True, conv_pad_to=128)
    if name == "sdxl_fused":
        return cfg.replace(models=dataclasses.replace(m, unet=fused))
    if name == "sdxl_w8a8":
        return cfg.replace(models=dataclasses.replace(m, unet=fused,
                                                      unet_w8a8=True))
    if name == "sdxl_int8":
        return cfg.replace(models=dataclasses.replace(m, unet_int8=True))
    if name == "sdxl_encprop":
        return cfg.replace(
            sampler=dataclasses.replace(s, encprop=True),
            models=dataclasses.replace(m, vae=dataclasses.replace(
                m.vae, fused_conv=True)))
    if name == "sdxl_turbo":
        return cfg.replace(sampler=dataclasses.replace(
            s, kind="dpmpp_2m", num_steps=24, deepcache=True))
    raise ValueError(f"no SDXL round {name!r}")


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


def check_serve(card: str) -> tuple:
    """The serving seam at full width: ``InferenceService(FrameworkConfig())``
    scoring 1,024 concurrent guesses through the device rung (a) and rung
    0 (b), four concurrent rounds, one cold, while guesses are scored (c),
    the integrity drill (d), the device-loss drill (e) and the classifier
    on real CUDA errors (f); then [game] on the same service
    (:func:`check_game`). Returns (serve ok, game ok, the game's degraded
    round's tallies)."""
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
    from cassmantle_tpu_torch.server.assets import load_wordlist

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
    scorer.clear_embed_cache()
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
    scorer.clear_embed_cache()
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
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[serve] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)

    # the game on this service
    t0 = time.perf_counter()
    game_ok, game_tallies = check_game(svc, card)
    print(f"[game] phase {time.perf_counter() - t0:.1f} s", flush=True)
    asyncio.run(svc.stop())
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return ok, game_ok, game_tallies


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


# -- [calibrate] and [int8] -------------------------------------------------

INT8_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cassmantle_tpu_torch", "_build", "int8_smoke")
INT8_TOKENS = 64


def image_round(pipe, seed: int = 11) -> dict:
    """A cold round of ``pipe`` (counters set to 0 just before and read
    just after) and a warm one: seconds by stage, the image, tallies."""
    import torch

    reset_all_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = pipe.generate([SERVE_PROMPT], seed=seed)
    cold_s = time.perf_counter() - t0
    tallies = read_tallies()
    cold = dict(pipe.last_stage_seconds)
    t0 = time.perf_counter()
    again = pipe.generate([SERVE_PROMPT], seed=seed)
    return {"image": img, "tallies": tallies, "cold_s": cold_s,
            "warm_s": time.perf_counter() - t0, "cold_stages_s": cold,
            "warm_stages_s": dict(pipe.last_stage_seconds),
            "finite": pipe.last_decoded_finite,
            "warm_equal": bool((img == again).all()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def check_calibrate_and_int8(card: str, svc) -> bool:
    """[calibrate]: the calibration pass at full width on the fused-conv
    preset's seeded SD1.5 (8 prompts x 4 timesteps, eager) into a temp
    artifact, then a W8A8 round with those static scales beside a W8A8
    round with dynamic ones, from the same weights: launches equal, the
    seconds of each. [int8]: an SD1.5 ``unet_int8`` round from the same
    weights; a GPT-2 ``lm_int8`` decode, ``quantize-weights`` written,
    loaded back by an ``lm_int8`` build from that directory and decoding
    the same tokens."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from cassmantle_tpu_torch.ops.quant import (
        int8_site_count,
        w8a8_calibrated,
        w8a8_site_count,
    )
    from cassmantle_tpu_torch.parallel import calibrate
    from cassmantle_tpu_torch.serving.pipeline import (
        PromptGenerator,
        Text2ImagePipeline,
    )
    from cassmantle_tpu_torch.tools import quantize_weights

    t2i = svc.backend.t2i
    base = t2i.cfg
    sd = {"clip_text": t2i.clip.state_dict(), "unet": t2i.unet.state_dict(),
          "vae": t2i.vae.state_dict()}
    os.makedirs(INT8_DIR, exist_ok=True)
    ok = True
    try:
        artifact = os.path.join(INT8_DIR, "act_scales.json")
        t0 = time.perf_counter()
        art = calibrate.emit(artifact, cfg=base, pipe=t2i)
        calib_s = time.perf_counter() - t0
        entry = art["entries"]["unet"]
        w8cfg = base.replace(models=dataclasses.replace(base.models,
                                                        unet_w8a8=True))
        rounds, pipes = {}, {}
        for mode in ("dynamic", "static"):
            saved = calibrate.ACT_SCALES_PATH
            if mode == "static":
                calibrate.ACT_SCALES_PATH = artifact
            try:
                pipe = Text2ImagePipeline(w8cfg, state_dicts=sd)
            finally:
                calibrate.ACT_SCALES_PATH = saved
            rounds[mode] = image_round(pipe)
            pipes[mode] = (w8a8_calibrated(pipe.unet),
                           w8a8_site_count(pipe.unet))
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        dyn, sta = rounds["dynamic"], rounds["static"]
        want = {"int8_conv3x3": scaled(CONV_SHAPES, UNET_FORWARDS),
                "int8_matmul": scaled(UNET_MATMUL_SHAPES, UNET_FORWARDS)}
        checks = {
            "sites_recorded": len(entry["scales"]) == 156,
            "signature_matches": entry["signature"]
            == calibrate.calibration_signature(w8cfg.models,
                                               entry["prompts_digest"]),
            "w8a8_calibrated": pipes["static"] == (True, 156)
            and pipes["dynamic"] == (False, 156),
            "launches_equal": all(dict(sta["tallies"][k]) == dict(
                dyn["tallies"][k]) == want[k] for k in want),
            "images_finite": sta["finite"] and dyn["finite"],
        }
        res = {"card": card, "calibrate_s": calib_s,
               "prompts": entry["num_prompts"],
               "timesteps": entry["timesteps"],
               "sites": len(entry["scales"]),
               "absmax_range": [min(entry["scales"].values()),
                                max(entry["scales"].values())],
               **{f"{mode}_round": {k: r[k] for k in (
                   "cold_s", "warm_s", "warm_stages_s")}
                  for mode, r in rounds.items()},
               "static_over_dynamic_warm": sta["warm_s"] / dyn["warm_s"],
               "mean_abs_pixel_diff": float(np.abs(
                   sta["image"].astype(np.float64) - dyn["image"]).mean()),
               "checks": checks}
        good = all(checks.values())
        print(f"[calibrate] {json.dumps(res)} -> "
              f"{'pass' if good else 'FAIL'}", flush=True)
        ok = ok and good

        # [int8]: the weights-only int8 UNet from the same weights
        q8cfg = base.replace(models=dataclasses.replace(
            base.models, unet_int8=True,
            unet=dataclasses.replace(base.models.unet, fused_conv=False)))
        t0 = time.perf_counter()
        pipe = Text2ImagePipeline(q8cfg, state_dicts=sd)
        build_s = time.perf_counter() - t0
        r = image_round(pipe)
        sites = int8_site_count(pipe.unet)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        flash = sum(r["tallies"]["flash_attention"].values())
        others = sum(sum(r["tallies"][k].values()) for k in (
            "gn_silu_conv3x3", "int8_matmul", "int8_conv3x3"))
        fp = image_round(t2i)
        # GPT-2: lm_int8, quantize-weights, the file read back
        gcfg = base.replace(models=dataclasses.replace(base.models,
                                                       lm_int8=True))
        t0 = time.perf_counter()
        gen = PromptGenerator(gcfg)
        gen_build_s = time.perf_counter() - t0
        toks, lens = gen.decode_ids_batch([LM_TEXT])
        t0 = time.perf_counter()
        text = gen.generate(LM_TEXT)
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        quantize_weights.main(["--weights", INT8_DIR, "--platform", "cuda"])
        write_s = time.perf_counter() - t0
        loaded = PromptGenerator(gcfg, weights_dir=INT8_DIR)
        toks2, lens2 = loaded.decode_ids_batch([LM_TEXT])
        checks = {
            "unet_int8_sites": sites > 0,
            "unet_int8_flash_1601": flash == 1601 and others == 0,
            "unet_int8_image": r["finite"] and int(r["image"].max())
            > int(r["image"].min()) and r["warm_equal"],
            "lm_int8_sites": int8_site_count(gen.model) == 72,
            "lm_int8_text": bool(text.strip()),
            "file_tokens_equal": bool(np.array_equal(toks, toks2)
                                      and np.array_equal(lens, lens2)),
            "file_int8_equal": all(torch.equal(a, b) for a, b in zip(
                gen.model.state_dict().values(),
                loaded.model.state_dict().values())),
            "file_not_real_weights": not loaded.loaded_real_weights,
            "file_read": loaded.int8_from_file and not gen.int8_from_file,
        }
        res = {"card": card, "unet_int8": {
            "build_s": build_s, "sites": sites, "cold_s": r["cold_s"],
            "warm_s": r["warm_s"], "warm_stages_s": r["warm_stages_s"],
            "peak_gib": r["peak_gib"], "flash_launches": flash,
            "mean_abs_pixel_diff_vs_bf16": float(np.abs(
                r["image"].astype(np.float64) - fp["image"]).mean())},
            "lm_int8": {"build_s": gen_build_s, "param_bytes":
                        gen.param_bytes, "decode_s": decode_s,
                        "tokens": int(lens[0]), "write_s": write_s,
                        "file_bytes": os.path.getsize(os.path.join(
                            INT8_DIR, "gpt2.int8.safetensors"))},
            "checks": checks}
        good = all(checks.values())
        print(f"[int8] {json.dumps(res)} -> {'pass' if good else 'FAIL'}",
              flush=True)
        ok = ok and good
        del gen, loaded
    finally:
        shutil.rmtree(INT8_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return ok


# the layers of the full-width Mistral-7B the A/B builds (of its 32): a
# 32-layer int8 build quantizes 7.2 B weights on the host in 35.3 s (one
# H100 machine's host), past what the script's time allows beside the rest
AB_LAYERS = 4


def check_mistral_int8_ab(card: str) -> bool:
    """[int8] mistral: ``lm-int8-ab`` at Mistral-7B's full width, cut to
    :data:`AB_LAYERS` layers: an fp arm (bf16, seeded on the card) and a
    ``lm_int8`` arm of the same seeded weights, quantized on the host; ms
    a token for each, the weight bytes, each arm's weight-read bound at
    the card's 3.35 TB/s, peak memory and the decode graph's pool."""
    import dataclasses

    import torch

    from cassmantle_tpu_torch.ops.quant import int8_site_count
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator
    from cassmantle_tpu_torch.tools import lm_int8_ab

    base = mistral_config()
    m = base.models
    cfg = base.replace(models=dataclasses.replace(
        m, mistral=dataclasses.replace(m.mistral, num_layers=AB_LAYERS)))
    arms = {}
    for arm in ("fp", "int8"):
        acfg = cfg.replace(models=dataclasses.replace(
            cfg.models, lm_int8=arm == "int8"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = PromptGenerator(acfg)
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        arms[arm] = lm_int8_ab.measure_arm(gen, INT8_TOKENS, 1)
        arms[arm].update(build_s=build_s, build_peak_gib=build_peak,
                         int8_weights=int8_site_count(gen.model))
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    rep = lm_int8_ab.report(arms["fp"], arms["int8"], "mistral",
                            INT8_TOKENS, False)
    rep.update(card=card, layers=AB_LAYERS, of_layers=m.mistral.num_layers)
    checks = {"int8_weights": arms["int8"]["int8_weights"]
              == AB_LAYERS * 7 + 1,
              "int8_bytes_about_half": 0.45 < rep["param_shrink"] < 0.6,
              "not_real_weights": rep["real_weights"] is False,
              "graph_ms_recorded": all("graph_ms_per_token" in a
                                       for a in arms.values())}
    rep["checks"] = checks
    ok = all(checks.values())
    print(f"[int8] mistral lm-int8-ab {json.dumps(rep)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


# -- the SDXL builds of the fused conv, W8A8 and int8 ([round-sdxl_*]) --------

SDXL_PROMPT = "A watercolor style piece depicting: a lighthouse at dusk."
SDXL_SEED = 7
# a build's denoise loop and its captured bodies' replays a round
SDXL_LOOPS = {"sdxl_encprop": ("encprop", {"key": 5, "segment": 15}),
              "sdxl_turbo": ("deepcache", {"pair": 12})}
# the steps at each end of the served 50-step DDIM schedule over which a
# DDIM SDXL build's served step graph is held to eager
# the served step graph held to eager over the first and last steps (it
# was 5 each: a depth cut to make room for the training phases)
SERVED_WINDOW = 2


def w8a8_dispatches() -> float:
    from cassmantle_tpu_torch.utils.logging import metrics

    return metrics.counter_total("pipeline.w8a8_dispatches")


def served_ddim_vs_eager(pipe, x, cond, windows) -> tuple:
    """The served DDIM step graph (``full_variant``'s, the one a round
    replays) against the eager step it captured, over ``windows`` of
    (first step, steps) of the served schedule: from ``x`` at the first
    step, that many replays against as many eager steps on the same
    conditioning. Returns (values that differ over every window, 0 when
    bit-equal; every replayed latent finite)."""
    import torch

    from cassmantle_tpu_torch.ops.ddim import (
        cfg_denoiser,
        cfg_inputs,
        spec_step,
    )

    v = pipe.full_variant
    graph = v.step_graphs[x.shape[0]]
    inputs = cfg_inputs(**cond)
    for key, value in inputs.items():
        if value is not None:
            graph.inputs[key].copy_(value)
    denoise = cfg_denoiser(pipe.unet,
                           guidance_scale=v.sampler_cfg.guidance_scale,
                           **inputs)
    spec = v.schedule.spec(x)
    differ, finite = 0, True
    for start, steps in windows:
        graph.reset(x, start)
        for _ in range(steps):
            graph.graph.replay()
        step = torch.full((1,), start, dtype=torch.long, device=x.device)
        carry = spec["init"](x)
        for _ in range(steps):
            carry = spec_step(spec, denoise, carry, step)
        differ += int((carry[0] != graph.x).sum().item())
        finite = finite and bool(torch.isfinite(graph.x).all())
    return differ, finite


def run_sdxl_build(card: str, name: str, state_dicts: dict, images: dict):
    """One SDXL build of this slice (:func:`sdxl_build_config`) from the
    [round-sdxl] service's weights (``state_dicts``: one seeded set for
    every build), through ``SDXLPipeline.generate``: a cold round (the
    capture included) with every launch counter set to 0 just before and
    read just after, then a warm one; seconds by stage, launches per
    shape against :func:`expected_tallies`, the loop and its replays,
    ``pipeline.w8a8_dispatches`` (50 an image under W8A8, else 0), the
    two images' FLOPs against the count, the gauge, graph = eager on the
    served graphs (the whole loop under encprop and DeepCache; the DDIM
    step graph over the first and last :data:`SERVED_WINDOW` steps of its
    schedule), pool MB, peak GiB, a finite image that is not constant.
    Returns (tallies, failed checks)."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.obs import costmodel
    from cassmantle_tpu_torch.ops.quant import (
        int8_site_count,
        tree_nbytes,
        w8a8_calibrated,
        w8a8_site_count,
    )
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
    from cassmantle_tpu_torch.utils.device import synchronize

    cfg = sdxl_build_config(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = SDXLPipeline(cfg, state_dicts=state_dicts)
    synchronize(pipe.device)
    build_s = time.perf_counter() - t0
    flops0, w0 = device_flops("sdxl"), w8a8_dispatches()
    reset_all_counters()
    t0 = time.perf_counter()
    img = pipe.generate([SDXL_PROMPT], seed=SDXL_SEED)
    cold_s = time.perf_counter() - t0
    tallies = read_tallies()
    cold_stages = dict(pipe.last_stage_seconds)
    finite = pipe.last_decoded_finite
    replays = {n: g.replays for n, g in
               pipe.full_variant.step_graphs[1].graphs.items()}
    t0 = time.perf_counter()
    img2 = pipe.generate([SDXL_PROMPT], seed=SDXL_SEED)
    warm_s = time.perf_counter() - t0
    warm_stages = dict(pipe.last_stage_seconds)
    per_image = costmodel.cached("sdxl", pipe.cost_signature())[1]
    obs = obs_device_reading(name, "sdxl", per_image,
                             device_flops("sdxl") - flops0, 2,
                             mxu_gauge("sdxl"))
    dispatches = w8a8_dispatches() - w0
    # the served graphs against eager on the same x_T: the whole loop
    # under encprop and DeepCache; the DDIM builds' step graph over both
    # ends of its schedule (a fifth of a whole eager loop's time)
    hw = cfg.sampler.image_size // pipe.vae_scale
    loop, want_replays = SDXL_LOOPS.get(name, ("ddim", {"step": 50}))
    steps = cfg.sampler.num_steps
    windows = (((0, SERVED_WINDOW), (steps - SERVED_WINDOW, SERVED_WINDOW))
               if loop == "ddim" else None)
    with torch.inference_mode():
        cond = pipe.encode([SDXL_PROMPT])
        x = torch.randn((1, hw, hw, 4), device=pipe.device,
                        generator=torch.Generator(pipe.device).manual_seed(5))
        t0 = time.perf_counter()
        if windows:
            differ, finite_eq = served_ddim_vs_eager(pipe, x, cond, windows)
        else:
            eager = pipe.denoise(x, cond, graphed=False)
            graphed = pipe.denoise(x, cond, graphed=True)
            differ = int((eager != graphed).sum().item())
            finite_eq = bool(torch.isfinite(graphed).all())
            del eager, graphed
        synchronize(pipe.device)
        eager_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    images[name] = img
    model = PRESET_MODEL[name]
    launches = {k: sum(v.values()) for k, v in tallies.items()
                if k != "flash_paths"}
    flash_paths = flash_path_totals(tallies["flash_paths"])
    w8a8 = cfg.models.unet_w8a8
    checks = {
        "image_shape": img.shape == (1, 1024, 1024, 3),
        "image_uint8": img.dtype == np.uint8,
        "decoded_finite": bool(finite),
        "image_not_constant": int(img.max()) > int(img.min()),
        "warm_image_equal": bool(np.array_equal(img, img2)),
        "flash_paths": flash_paths == ROUND_FLASH_PATHS[model],
        "sampler_mode": pipe.full_variant.mode == loop,
        "graph_replays": replays == want_replays,
        "graph_bit_equal_eager": differ == 0 and finite_eq,
        "w8a8_dispatches": dispatches == (2 * 50 if w8a8 else 0),
        "device_flops_count_x_images": obs["equal"],
        "mxu_utilization_in_range": obs["mxu_in_range"],
        "w8a8_sites": (w8a8_site_count(pipe.unet) == 34 + 490) == w8a8,
        "w8a8_dynamic_scales": not w8a8_calibrated(pipe.unet),
        "int8_weights": (int8_site_count(pipe.unet) > 0)
        == cfg.models.unet_int8,
    }
    for kernel, want in expected_tallies(name).items():
        checks[f"{kernel}_launches_per_shape"] = dict(tallies[kernel]) == want
    checks = {k: bool(v) for k, v in checks.items()}
    report = dict(
        build=name, card=card, build_s=build_s, cold_round_s=cold_s,
        warm_round_s=warm_s, cold_stages_s=cold_stages,
        warm_stages_s=warm_stages, launches=launches,
        flash_paths=flash_paths, sampler_mode=pipe.full_variant.mode,
        graph_replays=replays, w8a8_dispatches=dispatches,
        unet_bytes=tree_nbytes(pipe.unet),
        graphs={f"{b}/{n}": g.stats()
                for b, sg in pipe.full_variant.step_graphs.items()
                for n, g in sg.graphs.items()},
        graph_vs_eager_s=eager_s, graph_vs_eager_windows=windows,
        eager_values_differing=differ,
        peak_gib=peak_gib,
        obs_device={k: obs[k] for k in ("device_flops", "expected",
                                        "mxu_utilization")},
        image_mean=float(img.mean()), image_std=float(img.std()),
        checks=checks)
    if name == "sdxl_w8a8" and "sdxl_fused" in images:
        report["mean_abs_pixel_diff_vs_fused_bf16"] = float(np.abs(
            img.astype(np.float64) - images["sdxl_fused"]).mean())
    print(f"[round-{name}] {json.dumps(report)}", flush=True)
    pipe.drop_staged()
    del pipe, cond, x
    gc.collect()
    torch.cuda.empty_cache()
    return tallies, [k for k, v in checks.items() if not v]


def check_sdxl_builds(card: str, svc) -> tuple:
    """Every SDXL round of this slice from the [round-sdxl] service's
    seeded weights; returns (ok, {build: tallies})."""
    t2i = svc.backend.t2i
    state_dicts = {"clip_text": t2i.clip.state_dict(),
                   "clip_text_2": t2i.clip2.state_dict(),
                   "unet": t2i.unet.state_dict(),
                   "vae": t2i.vae.state_dict()}
    tallies, bad, images = {}, {}, {}
    for name in SDXL_ROUNDS:
        tallies[name], failed = run_sdxl_build(card, name, state_dicts,
                                               images)
        if failed:
            bad[name] = failed
    if bad:
        print(f"[round-sdxl_*] failed checks: {bad}", flush=True)
    return not bad, tallies


# -- serving over a mesh on the one card ([mesh]) ---------------------------

MESH_SEED = "The Night the Trains Sang"   # (a)'s round
MESH_GUESSES = 100                        # (d): guesses, as the reference's
MESH_SESSIONS = 8                         # (d): from this many sessions
MESH_ROUND_S = 4.0                        # (d): time_per_prompt
# flash launches of one UNet forward at sp = 2: each site once a position
SP_FLASH = {model: {name: n // UNET_FORWARDS
                    for name, n in ROUND_FLASH[f"{model}_sp2"].items()
                    if not name.startswith("vae")}
            for model in ("sd15", "sdxl")}
# the phase's launches per part, for the kernels line
MESH_TALLIES = {}
MESH_SECONDS = {}


def one_card_mesh(dp: int, sp: int = 1):
    """A dp x sp mesh whose positions all lie on the card (the devices
    repeat, as the reference's virtual host devices share one CPU)."""
    import torch

    from cassmantle_tpu_torch.config import MeshConfig
    from cassmantle_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(dp=dp, sp=sp),
                     [torch.device("cuda", 0)] * (dp * sp))


def flash_by_name(tally: dict) -> dict:
    """Flash launches per FLASH_SHAPES name."""
    names = {v[:5]: name for name, v in FLASH_SHAPES.items()}
    return {names.get(shape, str(shape)): n
            for shape, n in tally["flash_attention"].items()}


def mesh_flash_gaps(tally: dict, rows: dict) -> list:
    """Flash launches at a shape phase 2 did not check, or on another path
    than its check took."""
    names = {v[:5]: name for name, v in FLASH_SHAPES.items()}
    gaps = [str(shape) for shape in tally["flash_attention"]
            if shape not in names]
    gaps += [f"{names[shape]} on {path}"
             for (shape, path) in tally["flash_paths"]
             if shape in names and rows[names[shape]]["path"] != path]
    return gaps


def fp32_twin(unet):
    """The UNet in fp32 (its config at dtype float32) holding the served
    bf16 weights cast up: the forward the bf16 one is held to."""
    import dataclasses

    import torch

    from cassmantle_tpu_torch.models.unet import UNet

    dev = next(unet.parameters()).device
    with torch.device("meta"):
        twin = UNet(dataclasses.replace(unet.cfg, dtype="float32"))
    twin.to_empty(device=dev)
    twin.load_state_dict({k: v.float() for k, v in unet.state_dict().items()})
    return twin.requires_grad_(False).eval()


def spatial_forward(card: str, model: str, unet, size: int,
                    rows: dict) -> bool:
    """[mesh] (b): one UNet forward at ``size`` (CFG batch 2) split over
    sp = 2 positions on the card, against the one-device bf16 forward;
    the bound is twice that forward's own max |diff| from its fp32 twin
    on the same inputs."""
    import torch

    from cassmantle_tpu_torch.parallel.spatial import SpatialUNet

    dev = next(unet.parameters()).device
    cfg = unet.cfg
    gen = torch.Generator(dev).manual_seed(31)
    hw = size // 8
    x = torch.randn((2, hw, hw, 4), generator=gen, device=dev)
    t = torch.full((2,), 500, dtype=torch.long, device=dev)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=gen, device=dev)
    extra = ([torch.randn((2, cfg.addition_embed_dim), generator=gen,
                          device=dev)] if cfg.addition_embed_dim else [])
    t0 = time.perf_counter()
    with torch.inference_mode():
        twin = fp32_twin(unet)
        ref32 = twin(x, t, ctx, *extra)
        del twin
        one = unet(x, t, ctx, *extra)
        spatial = SpatialUNet([unet, unet], [dev, dev])
        spatial(x, t, ctx, *extra)              # warm-up: plans, handles
        torch.cuda.synchronize()
        reset_all_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = spatial(x, t, ctx, *extra)
        end.record()
        torch.cuda.synchronize()
        tally = read_tallies()
        one_start = torch.cuda.Event(enable_timing=True)
        one_end = torch.cuda.Event(enable_timing=True)
        one_start.record()
        unet(x, t, ctx, *extra)
        one_end.record()
        torch.cuda.synchronize()
    own = (one - ref32).abs().max().item()
    diff = (got - one).abs().max().item()
    by_name = flash_by_name(tally)
    gaps = mesh_flash_gaps(tally, rows)
    report = {"shape": list(x.shape), "max_abs_diff_sp": diff,
              "bf16_vs_fp32_max_abs": own, "bound": 2 * own,
              "finite": bool(torch.isfinite(got).all()),
              "eager_ms_sp2": start.elapsed_time(end),
              "eager_ms_one": one_start.elapsed_time(one_end),
              "flash": by_name, "flash_paths": flash_path_totals(
                  tally["flash_paths"]),
              "s": time.perf_counter() - t0}
    ok = (report["finite"] and diff <= 2 * own and by_name == SP_FLASH[model]
          and not gaps and not any(sum(tally[k].values()) for k in (
              "gn_silu_conv3x3", "int8_matmul", "int8_conv3x3")))
    MESH_TALLIES[f"b_{model}"] = tally
    print(f"[mesh] (b) sp=2 {model} UNet forward at {size}² ({card}): "
          f"{json.dumps(report)} -> {'pass' if ok else 'FAIL'}"
          + (f" gaps {gaps}" if gaps else ""), flush=True)
    return ok


def check_mesh_sd15(card: str, svc, rows: dict) -> bool:
    """[mesh] (a), (b) at SD1.5 and (d), over the [round-default]
    service's weights (``share_params_with``): a round on dp = 2 whose
    image and dropped pad row equal meshless batch-1 dispatches of the same
    x_T rows bit for bit; the sp = 2 forward; a full game round on
    dp x sp = 2 x 2."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from PIL import Image

    from cassmantle_tpu_torch.engine.game import Game
    from cassmantle_tpu_torch.engine.store import MemoryStore
    from cassmantle_tpu_torch.ops.ddim import initial_latents
    from cassmantle_tpu_torch.serving.pipeline import (
        Text2ImagePipeline,
        TorchContentBackend,
    )
    from cassmantle_tpu_torch.serving.service import InferenceService
    from cassmantle_tpu_torch.utils.logging import metrics

    from cassmantle_tpu_torch.serving import overload

    overload.reset_brownout()
    base = svc.backend.t2i
    cfg = base.cfg
    t_phase = time.perf_counter()

    def meshed_service(mesh, cfg=cfg):
        t2i = Text2ImagePipeline(cfg, mesh=mesh, share_params_with=base)
        return InferenceService(cfg, table=None, mesh=mesh,
                                backend=TorchContentBackend(
                                    cfg, mesh=mesh, t2i=t2i))

    # (a) dp = 2: one prompt and one pad row, a position each
    t0 = time.perf_counter()
    svc2 = meshed_service(one_card_mesh(2))
    t2i = svc2.backend.t2i
    build_s = time.perf_counter() - t0
    reset_all_counters()
    t0 = time.perf_counter()
    rc = asyncio.run(svc2.generate_content(MESH_SEED))
    round_s = time.perf_counter() - t0
    tally_a = read_tallies()
    MESH_TALLIES["a"] = tally_a
    replays = {str(key): g.graphs["step"].replays
               for key, g in t2i.full_variant.step_graphs.items()}
    pad_image = t2i.last_pad_images[0]
    gen = torch.Generator(t2i.device).manual_seed(rc.image_seed)
    x_t = initial_latents(gen, 2, cfg.sampler.image_size, t2i.vae_scale,
                          device=t2i.device)
    one = base.generate([rc.image_prompt], latents=x_t[0:1])[0]
    pad_one = base.generate([""], latents=x_t[1:2])[0]
    asyncio.run(svc2.stop())
    want_a = {k: 2 * n for k, n in ROUND_FLASH["sd15"].items()}
    report_a = {
        "build_s": build_s, "round_s": round_s,
        "stages_s": dict(t2i.last_stage_seconds),
        "image_equal": bool(np.array_equal(one, rc.image)),
        "pad_row_equal": bool(np.array_equal(pad_one, pad_image)),
        "image_diff_max": int(np.abs(one.astype(int) - rc.image).max()),
        "pad_diff_max": int(np.abs(pad_one.astype(int) - pad_image).max()),
        "flash": sum(tally_a["flash_attention"].values()),
        "flash_per_row": sum(tally_a["flash_attention"].values()) / 2,
        "flash_paths": flash_path_totals(tally_a["flash_paths"]),
        "graph_replays": replays}
    gaps_a = mesh_flash_gaps(tally_a, rows)
    ok_a = (report_a["image_equal"] and report_a["pad_row_equal"]
            and flash_by_name(tally_a) == want_a and not gaps_a
            and replays == {"(0, 1)": 50, "(1, 1)": 50})
    print(f"[mesh] (a) dp=2 round through InferenceService at 512², DDIM "
          f"{cfg.sampler.num_steps} graphed ({card}): "
          f"{json.dumps(report_a)} -> {'pass' if ok_a else 'FAIL'}"
          + (f" gaps {gaps_a}" if gaps_a else ""), flush=True)
    del svc2, t2i
    gc.collect()

    # (b) the sp = 2 forward at SD1.5 512²
    ok_b = spatial_forward(card, "sd15", base.unet, cfg.sampler.image_size,
                           rows)

    # (d) a full game round on dp x sp = 2 x 2: the reference's
    # _run_full_round_on_mesh (__graft_entry__.py:67)
    cfg_d = cfg.replace(game=dataclasses.replace(
        cfg.game, time_per_prompt=MESH_ROUND_S, lock_timeout=60.0,
        acquire_timeout=1.0))
    t0 = time.perf_counter()
    svc4 = meshed_service(one_card_mesh(2, 2), cfg_d)
    game = Game(cfg_d, MemoryStore(), svc4.content_backend, svc4.embed,
                svc4.similarity)
    count = metrics.counter_total
    images0 = count("pipeline.images")
    reset_all_counters()

    async def play():
        await svc4.similarity([("qzwarmupx", "qzwarmupy")] * 8)
        await game.startup()
        episode0 = int((await game.fetch_story()).get("episode", 0))
        ver0 = await game.rounds.current_image_version()
        timer = game.start_timer(tick=0.2)

        async def one_guess(i: int) -> dict:
            masks = await game.rounds.current_masks()
            return await game.compute_client_scores(
                f"mesh-player-{i % MESH_SESSIONS}",
                {str(masks[i % len(masks)]): f"guess{i}"})

        results = await asyncio.gather(
            *(one_guess(i) for i in range(MESH_GUESSES)))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 120.0
        while int((await game.fetch_story()).get("episode", 0)) <= episode0:
            if loop.time() > deadline:
                raise RuntimeError("the round never promoted on the mesh")
            await asyncio.sleep(0.2)
        ver1 = await game.rounds.current_image_version()
        raw = {slot: await game.store.hget("image", slot)
               for slot in ("current", "next")}
        timer.cancel()
        await game.shutdown()
        await svc4.stop()
        return results, ver0, ver1, raw

    results, ver0, ver1, raw = asyncio.run(play())
    round_d_s = time.perf_counter() - t0
    tally_d = read_tallies()
    MESH_TALLIES["d"] = tally_d
    # a dp position's captured sp step against the same steps run
    # eagerly, from one x_T: the graph holds the whole partitioned step
    view = svc4.backend.t2i._mesh_positions()[0]
    x_t = initial_latents(torch.Generator(view.device).manual_seed(5), 1,
                          cfg.sampler.image_size, view.vae_scale,
                          device=view.device)
    denoise_s = {}
    with torch.inference_mode():
        cond = view.encode([MESH_SEED])
        finals = {}
        for mode, graphed in (("graph", True), ("eager", False)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            finals[mode] = view.denoise(x_t, cond, graphed=graphed)
            torch.cuda.synchronize()
            denoise_s[mode] = time.perf_counter() - t1
    images_d = count("pipeline.images") - images0
    decoded = {slot: np.asarray(Image.open(io.BytesIO(b)))
               for slot, b in raw.items() if b}
    # a dispatch: the prompt's row and the pad row, each a round at sp 2
    want_d = {k: 2 * n * images_d
              for k, n in ROUND_FLASH["sd15_sp2"].items()}
    gaps_d = mesh_flash_gaps(tally_d, rows)
    report_d = {
        "s": round_d_s, "guesses": len(results),
        "scored": sum("won" in r for r in results),
        "image_version": [ver0, ver1], "images": images_d,
        "image_std": {k: float(v.std()) for k, v in decoded.items()},
        "image_shape": {k: list(v.shape) for k, v in decoded.items()},
        "flash": sum(tally_d["flash_attention"].values()),
        "flash_paths": flash_path_totals(tally_d["flash_paths"]),
        "graph_captures": len(svc4.backend.t2i.full_variant.step_graphs),
        "last_dispatch_stages_s": dict(svc4.backend.t2i.last_stage_seconds),
        "sp_denoise_s": denoise_s,
        "sp_graph_equal_eager": bool(torch.equal(finals["graph"],
                                                 finals["eager"]))}
    ok_d = (len(results) == MESH_GUESSES
            and all("won" in r for r in results) and ver1 != ver0
            and images_d >= 2 and decoded
            and all(v.dtype == np.uint8 and v.std() > 0
                    for v in decoded.values())
            and flash_by_name(tally_d) == want_d and not gaps_d
            and report_d["sp_graph_equal_eager"])
    print(f"[mesh] (d) a full game round on dp x sp = 2 x 2 at 512² "
          f"({card}): {json.dumps(report_d)} -> "
          f"{'pass' if ok_d else 'FAIL'}"
          + (f" gaps {gaps_d}" if gaps_d else ""), flush=True)
    del svc4, game
    gc.collect()
    torch.cuda.empty_cache()
    MESH_SECONDS["sd15"] = time.perf_counter() - t_phase
    return ok_a and ok_b and ok_d


def check_mesh_sdxl(card: str, svc, rows: dict) -> bool:
    """[mesh] (b) at SDXL 1024² over the [round-sdxl] service's UNet, then
    (c): kernel 1 at every spatial shape, from phase 2's rows."""
    import torch

    t0 = time.perf_counter()
    ok_b = spatial_forward(card, "sdxl", svc.backend.t2i.unet, 1024, rows)
    torch.cuda.empty_cache()
    MESH_SECONDS["sdxl"] = time.perf_counter() - t0
    spatial = {name: {k: rows[name][k] for k in (
        "shape", "path", "max_abs_err", "ms", "bound_ms", "plain_ms",
        "library_ms", "ok")} for name in SPATIAL_FLASH}
    ok_c = all(r["ok"] and r["path"] == "wgmma" for r in spatial.values())
    print(f"[mesh] (c) flash at the spatial shapes, from phase 2 ({card}):"
          f" {json.dumps(spatial)} -> {'pass' if ok_c else 'FAIL'}",
          flush=True)
    total = sum(MESH_SECONDS.values())
    print(f"[mesh] phase {total:.1f} s (sd15 {MESH_SECONDS.get('sd15', 0):.1f}"
          f", sdxl {MESH_SECONDS['sdxl']:.1f})", flush=True)
    return ok_b and ok_c


# -- the brownout ladder and the game ([brownout], [game]) --------------------

def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def add_counts(*parts) -> dict:
    return dict(sum((collections.Counter(p) for p in parts),
                    collections.Counter()))


# Each [brownout] cell (preset@tier, its flash in ROUND_FLASH): the image
# size, the sampler loop and the replays of each captured body of the
# tier's config; the other kernels' launches per shape in TIER_KERNELS.
TIER_CELLS = {
    "default@t1": (512, "ddim", {"step": 30}),
    "default@t4": (256, "ddim", {"step": 30}),
    "consistency@t3": (512, "consistency", {"step": 4}),
    "encprop@t2": (512, "encprop", {"key": 5, "segment": 5}),
    "encprop@t4": (256, "encprop", {"key": 5, "segment": 5}),
    "sdxl@t1": (1024, "ddim", {"step": 30}),
    "sdxl@t4": (512, "ddim", {"step": 30}),
}
# cells whose tables are derived and held to the configs, but not driven
# (the sdxl_encprop build's tiers: flash at batch 8 of SDXL's up path)
DERIVED_CELLS = ("sdxl_encprop@t2", "sdxl_encprop@t4")
for _cell in ("fusedconv@t4", "w8a8@t4", "game@t5"):
    TIER_CELLS[_cell] = TIER_CELLS["default@t4"]
# 30 x 44 = 1,320 fused convs; 30 x 112 = 3,360 UNet int8 matmuls beside
# the GPT-2 decode's 6,912; 1,320 int8 convs; encprop's fused VAE decoder
TIER_KERNELS = {
    "fusedconv@t4": {"gn_silu_conv3x3": scaled(TIER_CONV_SHAPES, 30)},
    "w8a8@t4": {"int8_conv3x3": scaled(TIER_CONV_SHAPES, 30),
                "int8_matmul": add_counts(
                    scaled(TIER_UNET_MATMUL_SHAPES, 30), LM_MATMUL_SHAPES)},
    "encprop@t2": {"gn_silu_conv3x3": dict(VAE_CONV_SHAPES["sd15"])},
    "encprop@t4": {"gn_silu_conv3x3": dict(VAE_CONV_SHAPES["sd15_256"])},
    "sdxl_encprop@t2": {"gn_silu_conv3x3": dict(VAE_CONV_SHAPES["sdxl"])},
    "sdxl_encprop@t4": {"gn_silu_conv3x3": conv_shapes_at(
        VAE_CONV_SHAPES["sdxl"], 512, 1024)},
}
# the tiers each preset's service is driven through
BROWNOUT_TIERS = {"default": (1, 4), "consistency": (3,), "fusedconv": (4,),
                  "w8a8": (4,), "encprop": (2, 4), "sdxl": (1, 4)}


def tier_expected(cell: str) -> dict:
    """Launches per shape of one round of a [brownout] cell, every
    kernel."""
    out = {"gn_silu_conv3x3": {}, "int8_matmul": {}, "int8_conv3x3": {},
           "flash_attention": round_flash_shapes(cell)}
    out.update(TIER_KERNELS.get(cell, {}))
    return out


def served_presets() -> tuple:
    """(name, config) of every preset whose service serves rounds here:
    phase 4's, the few-step tier's student and Mistral's."""
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

    return (("default", FrameworkConfig()),
            ("fusedconv", fusedconv_serving_config()),
            ("w8a8", w8a8_serving_config()),
            ("sdxl", sdxl_config()),
            ("encprop", encprop_serving_config()),
            ("deepcache", deepcache_serving_config()),
            ("fast", fast_serving_config()),
            ("turbo", turbo_serving_config()),
            ("lcm", lcm_serving_config()),
            ("img2img", img2img_config()),
            ("consistency", consistency_student_config()),
            ("mistral", mistral_config()),
            *((name, sdxl_build_config(name)) for name in SDXL_ROUNDS))


def unet_flash_forward(model: str, size: int, mode: str,
                       batch: int = 2) -> dict:
    """Flash launches per (B, Sq, Sk, H, D) of one UNet forward at
    ``size`` pixels, from the architectures: SD1.5's three levels of 5
    transformer blocks (the up path's 3 a level in the decoder-only
    forward, level 0's 5 in DeepCache's shallow one) and its mid block's
    1, 8 heads of D 40, 80, 160 and 160; SDXL's full forward, 10 blocks
    at 10 heads a quarter of the latent's tokens and 60 (50 + 10 mid) at
    20 heads a sixteenth, D 64. Each block one self attention and one
    cross attention over the 77 context tokens."""
    lat = size // 8
    if model == "sdxl":
        # full: 5 transformers x depth 2 at level 1, 5 x 10 + the mid
        # block's 10 at level 2; decoder-only: the up path's 3 x 2 and
        # 3 x 10; shallow: level 0 alone, no attention
        blocks = {"full": (10, 60), "decoder_only": (6, 30),
                  "shallow": (0, 0)}[mode]
        sites = [(lat * lat // 4, 10, 64, blocks[0]),
                 (lat * lat // 16, 20, 64, blocks[1])]
        sites = [site for site in sites if site[3]]
    else:
        blocks = {"full": (5, 5, 5, 1), "decoder_only": (3, 3, 3, 0),
                  "shallow": (5, 0, 0, 0)}[mode]
        sites = [(lat * lat >> 2 * i, 8, d, n) for i, (d, n) in
                 enumerate(zip((40, 80, 160, 160), blocks)) if n]
    out = collections.Counter()
    for tokens, heads, d, n in sites:
        for keys in (tokens, 77):
            out[(batch, tokens, keys, heads, d)] += n
    return out


def round_forwards(s) -> list:
    """(forward mode, batch, count) of one round under the served sampler
    config ``s`` (CFG batch 2): encoder propagation's key forwards, its
    DeepCache shallow ones, and one decoder-only forward a segment over
    its propagated steps (the tail's apart); DeepCache's alternating
    full and shallow forwards; one full forward a step otherwise."""
    from cassmantle_tpu_torch.ops.ddim import encprop_step_counts
    from cassmantle_tpu_torch.serving.pipeline import sampler_mode

    n, mode = s.num_steps, sampler_mode(s)
    if mode == "encprop":
        keys, shallow, _ = encprop_step_counts(
            n, s.encprop_stride, s.encprop_dense_steps, s.deepcache)
        out = [("full", 2, keys), ("shallow", 2, shallow)]
        segments, tail = divmod(n - s.encprop_dense_steps, s.encprop_stride)
        for length, count in ((s.encprop_stride, segments), (tail, 1)):
            if length and count:
                propagated = length - 1 - (s.deepcache and length >= 2)
                out.append(("decoder_only", 2 * propagated, count))
        return [f for f in out if f[1] and f[2]]
    if mode == "deepcache":
        return [("full", 2, (n + 1) // 2), ("shallow", 2, n // 2)]
    return [("full", 2, n)]


def derived_round(cfg, tier) -> dict:
    """What one round of ``cfg``'s service launches at brownout ``tier``
    (None: full quality), derived from the config through the port's
    ``degraded_sampler_cfg`` and the architectures, not from the tables
    above: flash launches per shape; the shapes of the other kernels
    (the UNet's convs and W8A8 sites at the round's size where the UNet
    is fused or W8A8, the SD1.5 VAE decoder's where it is fused, and
    GPT-2's W8A8 decode; a W8A8 UNet's convs run on kernel 4, not
    kernel 2). A fused or W8A8 UNet is modelled in full
    forwards only; any other forward raises."""
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.serving.pipeline import effective_sampler_cfg

    m = cfg.models
    s = effective_sampler_cfg(cfg.sampler if tier is None else
                              overload.degraded_sampler_cfg(cfg.sampler,
                                                            tier))
    size = s.image_size
    model = "sd15" if m.clip_text_2 is None else "sdxl"
    flash = collections.Counter({(1, (size // 8) ** 2, (size // 8) ** 2,
                                  1, 512): 1})
    forwards = round_forwards(s)
    for mode, batch, count in forwards:
        for shape, n in unet_flash_forward(model, size, mode, batch).items():
            flash[shape] += n * count
    out = {"flash_attention": dict(flash), "gn_silu_conv3x3": set(),
           "int8_matmul": set(), "int8_conv3x3": set()}
    if (m.unet.fused_conv or m.unet_w8a8) and any(
            mode != "full" for mode, _, _ in forwards):
        raise ValueError("a fused or W8A8 UNet's partial forwards are not "
                         "modelled")
    if m.unet.fused_conv and not m.unet_w8a8:
        out["gn_silu_conv3x3"] |= set(arch_conv_shapes(m.unet, size))
    if m.unet_w8a8:
        out["int8_conv3x3"] |= set(arch_conv_shapes(m.unet, size))
        out["int8_matmul"] |= set(arch_matmul_shapes(m.unet, size))
    if m.lm_w8a8:
        out["int8_matmul"] |= set(LM_MATMUL_SHAPES)
    if m.vae.fused_conv:
        base = 512 if model == "sd15" else 1024
        out["gn_silu_conv3x3"] |= set(conv_shapes_at(VAE_CONV_SHAPES[model],
                                                     size, base))
    return out


def tier_shape_gaps() -> list:
    """Every served preset (:func:`served_presets`) at full quality and at
    each tier of ``DEFAULT_TIERS``, derived (:func:`derived_round`):
    (preset, tier, kernel, shapes) for each kernel whose derived shapes
    phase 2 does not check. Empty when every tier of every preset, driven
    or not, launches only checked shapes."""
    from cassmantle_tpu_torch.serving import overload

    checked = {"flash_attention": {v[:5] for v in FLASH_SHAPES.values()},
               "gn_silu_conv3x3": set(FUSED_CHECK_SHAPES),
               "int8_matmul": set(MATMUL_CHECK_SHAPES),
               "int8_conv3x3": set(INT8_CONV_CHECK_SHAPES)}
    gaps = []
    for preset, cfg in served_presets():
        for i, tier in enumerate((None, *overload.DEFAULT_TIERS[1:])):
            for kernel, shapes in derived_round(cfg, tier).items():
                missing = set(shapes) - checked[kernel]
                if missing:
                    gaps.append((preset, i, kernel, sorted(missing)))
    return gaps


def round_table_mismatches() -> list:
    """The tables above against :func:`derived_round`: each served
    preset's full-quality round (``expected_tallies``; img2img's own path
    aside) and each [brownout] cell's (ROUND_FLASH, TIER_KERNELS) at its
    preset's tier. Returns (round, kernel) where the flash launches per
    shape, or another kernel's shapes, differ."""
    from cassmantle_tpu_torch.serving import overload

    presets = dict(served_presets())
    rounds = [(name, cfg, None, expected_tallies(name))
              for name, cfg in presets.items()
              if name not in ("img2img", "consistency")]
    for cell in (*TIER_CELLS, *DERIVED_CELLS):
        preset, tier = cell.split("@t")
        rounds.append((cell, presets.get(preset, presets["default"]),
                       overload.DEFAULT_TIERS[int(tier)], tier_expected(cell)))
    out = []
    for name, cfg, tier, expected in rounds:
        derived = derived_round(cfg, tier)
        for kernel, want in expected.items():
            got = derived[kernel]
            if (got != want if kernel == "flash_attention"
                    else got != set(want)):
                out.append((name, kernel))
    return out


def brownout_ladder():
    """The process's ladder, configured as a service would be, subscribed
    to an SLO engine that evaluates on every call; step-down dwell 0, so
    each evaluation past the first steps one rung down. Returns (engine,
    ladder)."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.obs.slo import SloEngine, default_objectives
    from cassmantle_tpu_torch.serving import overload

    cfg = FrameworkConfig()
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, brownout_step_down_dwell_s=0.0))
    engine = SloEngine(default_objectives(cfg),
                       fast_window_s=cfg.obs.slo_fast_window_s,
                       slow_window_s=cfg.obs.slo_slow_window_s,
                       min_eval_gap_s=0.0)
    return engine, overload.configure_brownout(cfg, engine)


def step_ladder(engine, ladder, tier: int) -> bool:
    """Up through the drill lever (one ``overload.brownout`` injection an
    evaluation), down through the engine's ok verdicts."""
    from cassmantle_tpu_torch import chaos

    up = tier - ladder.tier()
    if up > 0:
        chaos.configure(f"overload.brownout=raise:times={up}")
        try:
            for _ in range(up):
                engine.evaluate()
        finally:
            chaos.disarm()
    for _ in range(4 * len(ladder.tiers)):
        if ladder.tier() <= tier:
            break
        engine.evaluate()
    return ladder.tier() == tier


def tier_round(svc, cell: str, seed: str, card: str) -> tuple:
    """One round at the ladder's tier through ``generate_content``, the
    counts set to 0 just before it and read just after: the image size,
    the tier variant's replays and every kernel's launches per shape
    against the cell's; the tier graph's final latents against the eager
    steps on the same x_T and conditioning (bit-equal); a second round at
    the tier on this thread under ``no_new_captures`` (the cached
    variant). Returns (tallies, checks, report, the repeat's image)."""
    import torch

    from cassmantle_tpu_torch.ops import graphs
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.serving.pipeline import tier_key

    t2i = svc.backend.t2i
    size, mode, replays_want = TIER_CELLS[cell]
    scfg = overload.degraded_sampler_cfg(t2i.cfg.sampler,
                                         overload.quality_overrides())
    variants = len(t2i.tier_variants)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counters()
    t0 = time.perf_counter()
    rc = asyncio.run(svc.generate_content(seed))
    round_s = time.perf_counter() - t0
    tallies = read_tallies()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    v = t2i.tier_variants[tier_key(scfg)]
    sg = v.step_graphs[1]
    replays = {name: g.replays for name, g in sg.graphs.items()}
    stats = {name: g.stats() for name, g in sg.graphs.items()}
    capture_s = sum(st["warmup_s"] + st["capture_s"] + st["instantiate_s"]
                    for st in stats.values())
    pool_mb = sum(st["pool_bytes"] for st in stats.values()) / 1e6
    hw = size // t2i.vae_scale
    with torch.inference_mode():
        cond = t2i.encode([SERVE_PROMPT])
        x = torch.randn((1, hw, hw, 4), device=t2i.device,
                        generator=torch.Generator(t2i.device).manual_seed(9))
        eager = t2i.denoise(x, cond, graphed=False, variant=v)
        graphed = t2i.denoise(x, cond, graphed=True, variant=v)
        bit_equal = bool(torch.equal(eager, graphed))
        max_diff = (eager - graphed).abs().max().item()
    built = len(t2i.tier_variants)
    torch.cuda.synchronize()          # time the repeat alone
    t0 = time.perf_counter()
    with graphs.no_new_captures():
        again = t2i.generate([SERVE_PROMPT], seed=13)
    warm_s = time.perf_counter() - t0
    checks = {
        "image_size": rc.image.shape == (size, size, 3),
        "image_not_constant": int(rc.image.max()) > int(rc.image.min()),
        "sampler_mode": v.mode == mode,
        "graph_replays": replays == replays_want,
        "tier_graph_bit_equal": bit_equal,
        "at_most_one_variant_built": built - variants <= 1,
        "repeat_reuses_variant": (len(t2i.tier_variants) == built
                                  and again.shape == (1, size, size, 3)),
    }
    if mode == "encprop":
        checks["encprop_step_counts"] = v.encprop_counts == (10, 0, 20)
    for kernel, want in tier_expected(cell).items():
        checks[f"{kernel}_launches_per_shape"] = dict(tallies[kernel]) == want
    launches = {k: sum(c.values()) for k, c in tallies.items()
                if k != "flash_paths"}
    report = {"cell": cell, "card": card, "tier": overload.current_tier(),
              "steps": scfg.num_steps, "image_size": scfg.image_size,
              "stride": scfg.encprop_stride, "consistency": scfg.consistency,
              "round_s": round_s, "warm_generate_s": warm_s,
              "warm_stages_s": dict(t2i.last_stage_seconds),
              "capture_s": capture_s, "pool_mb": pool_mb,
              "peak_gib": peak_gib, "graph_replays": replays,
              "launches": launches,
              "launches_per_shape": {
                  k: {"x".join(map(str, shape)): n
                      for shape, n in sorted(c.items())}
                  for k, c in tallies.items() if k != "flash_paths"},
              "graphs": stats,
              "denoise_max_abs_diff": max_diff}
    return tallies, checks, report, again


def check_brownout(svc, preset: str, card: str) -> tuple:
    """[brownout]: the ladder stepped by its drill lever through each of
    ``preset``'s tiers (BROWNOUT_TIERS), one round served at each
    (:func:`tier_round`), then back to tier 0, where the image must equal
    the one served before the ladder moved, bit for bit. On the default
    preset, a rebuild of every model (the device-loss recovery's) and its
    warm after the tier graphs exist: the tier's image after equal to the
    one before, with no new capture. Returns (ok, {cell: tallies})."""
    import numpy as np

    from cassmantle_tpu_torch.ops import graphs
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.utils.logging import metrics

    t2i = svc.backend.t2i
    engine, ladder = brownout_ladder()
    t0 = time.perf_counter()
    before = t2i.generate([SERVE_PROMPT], seed=21)
    cells, ok = {}, True
    for i, tier in enumerate(BROWNOUT_TIERS[preset]):
        cell = f"{preset}@t{tier}"
        stepped = step_ladder(engine, ladder, tier)
        tallies, checks, report, again = tier_round(
            svc, cell, SERVE_SEEDS[i % len(SERVE_SEEDS)], card)
        checks["ladder_stepped"] = stepped
        if preset == "default" and tier == max(BROWNOUT_TIERS[preset]):
            captures = graphs.capture_count()
            t1 = time.perf_counter()
            svc.rebuild_device_state()
            svc.warm_after_recovery()
            report["rebuild_and_warm_s"] = time.perf_counter() - t1
            with graphs.no_new_captures():
                after = t2i.generate([SERVE_PROMPT], seed=13)
            checks["tier_graph_valid_after_rebuild"] = (
                bool(np.array_equal(after, again))
                and graphs.capture_count() == captures)
        report["checks"] = {k: bool(v) for k, v in checks.items()}
        cell_ok = all(checks.values())
        print(f"[brownout] {json.dumps(report)} -> "
              f"{'pass' if cell_ok else 'FAIL'}", flush=True)
        cells[cell] = tallies
        ok = ok and cell_ok
    down = step_ladder(engine, ladder, 0)
    with graphs.no_new_captures():
        back = t2i.generate([SERVE_PROMPT], seed=21)
    revert = {"preset": preset, "ladder_at_0": down,
              "tier0_bit_equal_before": bool(np.array_equal(back, before)),
              "variants": len(t2i.tier_variants),
              "delta_unusable": metrics.counter_total(
                  "pipeline.brownout_delta_unusable"),
              "phase_s": time.perf_counter() - t0}
    revert_ok = (down and revert["tier0_bit_equal_before"]
                 and revert["delta_unusable"] == 0)
    print(f"[brownout] {json.dumps(revert)} -> "
          f"{'pass' if revert_ok else 'FAIL'}", flush=True)
    overload.reset_brownout()
    return ok and revert_ok, cells


GAME_SESSIONS = 1024
GAME_ROUND_S = 8.0            # time_per_prompt of the [game] rounds


def check_game(svc, card: str) -> tuple:
    """[game]: a ``Game`` on the [serve] service (``svc.content_backend``,
    ``embed``, ``similarity``, ``blur``, ``supervisor``, ``pin_answers``;
    a ``MemoryStore``; 8 s rounds): ``startup`` and a buffered next round,
    1,024 sessions (``init_client``, ``fetch_prompt_json``, a guess at
    both masks, half from the wordlist on rung 0 and half out of
    vocabulary on the device rung, ``fetch_masked_image_b64``), one
    promotion through the round timer, and, with the ladder at tier 5,
    coarser blur buckets (rounding up) and the next buffered round at
    256x256 while guesses are scored. Scores against direct similarity:
    within 1e-5 on the device rung, 1e-2 of fp32 on rung 0. Returns (ok,
    the degraded round's tallies)."""
    import base64
    import dataclasses
    import io
    import math

    import numpy as np
    from PIL import Image

    from cassmantle_tpu_torch.engine.game import Game
    from cassmantle_tpu_torch.engine.masking import select_masks
    from cassmantle_tpu_torch.engine.store import MemoryStore
    from cassmantle_tpu_torch.server.assets import load_wordlist
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.utils.logging import metrics

    count = metrics.counter_total
    cfg = svc.cfg.replace(game=dataclasses.replace(
        svc.cfg.game, time_per_prompt=GAME_ROUND_S))
    game = Game(cfg, MemoryStore(), svc.content_backend, svc.embed,
                svc.similarity, blur_fn=svc.blur,
                supervisor=svc.supervisor, pin_answers=svc.pin_answers)
    scorer = svc.scorer
    words = [w for w in load_wordlist() if w.isalpha()]
    sessions = [f"player-{i}" for i in range(GAME_SESSIONS)]
    min_score = cfg.game.min_score

    def decode(b64):
        return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))

    def guesses_for(i, masks):
        if i % 2 == 0:            # rung 0: wordlist words
            return {str(m): words[(7 * i + j) % len(words)]
                    for j, m in enumerate(masks)}
        return {str(m): f"gm{i}q{j}z{i * 7919 % 104729}x"
                for j, m in enumerate(masks)}

    sheds = [0]

    async def timed(call):
        """``await call()`` and its seconds; a guess the adaptive
        admission sheds (a 503 with Retry-After over HTTP) is retried
        after its Retry-After, as a player's client does, and counted.
        The shed raises before the session is touched."""
        from cassmantle_tpu_torch.serving.queue import OverloadShed

        t = time.perf_counter()
        for _ in range(20):
            try:
                return await call(), time.perf_counter() - t
            except OverloadShed as exc:
                sheds[0] += 1
                await asyncio.sleep(exc.retry_after_s)
        return await call(), time.perf_counter() - t

    promote_s = []
    real_promote = game.rounds.promote_buffer

    async def timed_promote():
        t = time.perf_counter()
        await real_promote()
        promote_s.append(time.perf_counter() - t)

    game.rounds.promote_buffer = timed_promote
    report, checks = {"card": card, "sessions": GAME_SESSIONS}, {}

    async def play():
        t = time.perf_counter()
        await game.startup()
        report["startup_s"] = time.perf_counter() - t
        t = time.perf_counter()
        await game.rounds.buffer_contents()
        report["buffer_s"] = time.perf_counter() - t
        prompt = await game.rounds.fetch_current_prompt()
        tokens, masks = prompt["tokens"], prompt["masks"]
        answers = [tokens[m] for m in masks]
        await asyncio.gather(*(game.init_client(s) for s in sessions))
        views = await asyncio.gather(*(game.fetch_prompt_json(s)
                                       for s in sessions))
        checks["prompt_json_masked"] = all(
            all(v["tokens"][m] == "*" for m in masks) for v in views)
        inputs = [guesses_for(i, masks) for i in range(GAME_SESSIONS)]
        hits, batches = count("scorer.table_hits"), count("score.batches")
        scored = await asyncio.gather(*(
            timed(lambda s=s, i=i: game.compute_client_scores(s, inputs[i]))
            for i, s in enumerate(sessions)))
        report["guess_sheds_retried"] = sheds[0]
        report["score_batches"] = count("score.batches") - batches
        report["table_hits"] = count("scorer.table_hits") - hits
        misses = count("game.image_cache_misses")
        rendered = await asyncio.gather(*(
            timed(lambda s=s: game.fetch_masked_image_b64(s))
            for s in sessions))
        image_size = (await game.rounds.fetch_current_image()).shape
        checks["masked_images_size"] = all(
            decode(b64).shape == image_size for b64, _ in rendered[::64])
        # each score against a direct similarity of its pair
        dev_pairs, dev_got, t0_pairs, t0_got = [], [], [], []
        for i, ((res, _), given) in enumerate(zip(scored, inputs)):
            for j, m in enumerate(masks):
                pair = (given[str(m)].lower(), answers[j].lower())
                got = float(res[str(m)])
                if pair[0] == pair[1]:
                    checks.setdefault("exact_is_one", True)
                    checks["exact_is_one"] &= got == 1.0
                    continue
                (t0_pairs if i % 2 == 0 else dev_pairs).append(pair)
                (t0_got if i % 2 == 0 else dev_got).append(got)
        scorer.clear_embed_cache()
        direct = scorer.similarity(dev_pairs)
        clamp = np.clip(direct, min_score, 0.999)
        report["device_rung_max_abs_err"] = float(
            np.abs(np.asarray(dev_got) - clamp).max())
        texts = list(dict.fromkeys([w for p in t0_pairs for w in p]))
        emb = dict(zip(texts, scorer._embed_device(texts)[0]))
        fp32 = np.clip([emb[g] @ emb[a] for g, a in t0_pairs], min_score,
                       0.999)
        report["rung0_max_abs_err_vs_fp32"] = float(
            np.abs(np.asarray(t0_got) - fp32).max())
        checks["device_rung_scores"] = \
            report["device_rung_max_abs_err"] <= 1e-5
        checks["rung0_scores"] = report["rung0_max_abs_err_vs_fp32"] <= 1e-2
        guess_lat = [dt for _, dt in scored]
        render_lat = [dt for _, dt in rendered]
        report["guess_ms"] = latency_ms(guess_lat)
        report["render_ms"] = latency_ms(render_lat)
        report["renders"] = count("game.image_cache_misses") - misses

        # one promotion through the round timer
        nxt = json.loads((await game.store.hget("prompt", "next")).decode())
        promoted = count("rounds.promoted")
        t = time.perf_counter()
        game.start_timer(tick=0.1)
        # the rollover ends by restarting the clock and raising the 1 s
        # reset flag: stop the timer only then
        while not (count("rounds.promoted") > promoted
                   and await game.rounds.reset_flag()) and \
                time.perf_counter() - t < 3 * GAME_ROUND_S:
            await asyncio.sleep(0.1)
        await game.rounds.stop()
        report["promotion_s"] = promote_s[-1] if promote_s else None
        report["round_wait_s"] = time.perf_counter() - t
        after = await game.rounds.fetch_current_prompt()
        checks["promoted"] = count("rounds.promoted") == promoted + 1
        checks["promoted_buffered_text"] = after == nxt
        # the masks are the new text's own selection (random weights may
        # decode the same text from another seed)
        report["promoted_text_differs"] = after["tokens"] != tokens
        checks["new_masks_from_new_text"] = after["masks"] == select_masks(
            after["tokens"], svc.embed, cfg.game.num_masked)
        reset = [await game.sessions.fetch_scores(s) for s in sessions[::97]]
        checks["sessions_reset"] = all(
            r["attempts"] == "0" and float(r["max"]) == min_score
            for r in reset)

        # varied scores again, then the coarse-blur tier
        few = sessions[:64]
        await asyncio.gather(*(timed(
            lambda s=s, i=i: game.compute_client_scores(
                s, guesses_for(i, after["masks"])))
            for i, s in enumerate(few)))
        radii = [await game._reveal_radius(s) for s in few]
        fine = sorted({overload.quantize_blur_radius(r) for r in radii})
        engine, ladder = brownout_ladder()
        checks["ladder_at_5"] = step_ladder(engine, ladder, 5)
        coarse = [overload.quantize_blur_radius(r) for r in radii]
        await asyncio.gather(*(game.fetch_masked_image_b64(s) for s in few))
        checks["coarse_buckets_round_up"] = all(
            c >= r and c == math.ceil(r / 2.0) * 2.0
            for c, r in zip(coarse, radii))
        checks["coarse_buckets_rendered"] = set(game._image_cache) == set(
            coarse)
        report["buckets"] = {"fine": fine, "coarse": sorted(set(coarse))}
        tier_size = overload.degraded_sampler_cfg(
            svc.cfg.sampler, overload.quality_overrides()).image_size
        degraded = count("pipeline.brownout_images")
        reset_all_counters()
        t = time.perf_counter()
        _, lat, waves = await guesses_during(
            svc, [game.rounds.buffer_contents()], "game")
        report["degraded_buffer_s"] = time.perf_counter() - t
        report["degraded_guess_waves"] = waves
        report["degraded_guess_ms"] = latency_ms(lat)
        tallies = read_tallies()
        raw = await game.store.hget("image", "next")
        checks["degraded_round_256"] = (
            raw is not None
            and decode(base64.b64encode(raw)).shape == (tier_size,) * 2 + (3,))
        checks["brownout_images"] = (
            count("pipeline.brownout_images") - degraded == 1)
        for kernel, want in tier_expected("game@t5").items():
            checks[f"{kernel}_launches_per_shape"] = \
                dict(tallies[kernel]) == want
        checks["ladder_back_to_0"] = step_ladder(engine, ladder, 0)
        overload.reset_brownout()
        return tallies

    tallies = asyncio.run(play())
    del game.rounds.promote_buffer
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[game] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    return ok, tallies


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


# -- the game server ----------------------------------------------------------

SERVER_SESSIONS = 64          # [server]'s players, in parallel
SERVER_ROUND_S = 12.0         # time_per_prompt of the [server] rounds
SERVER_BURN_S = 60.0          # deadline for the ladder to leave tier 0
SERVER_TIER_ROUND_S = 45.0    # deadline for the round at the tier
SERVER_READY_S = 240.0        # deadline for [serve-cli]'s /readyz
SERVE_CLI_ROUND_S = 60.0      # --round-seconds of [serve-cli]
SERVE_CLI_LOG = os.path.join(REPO, "cassmantle_tpu_torch", "_build",
                             "serve_cli.log")


def server_config():
    """``FrameworkConfig()`` as [server] serves it: 12 s rounds; rate
    limits one loopback client can play 1,024 sessions under; and the SLO
    loop at 0.5 s over a 10 s fast and 60 s slow window with a 1 ms p99
    threshold on ``http.compute_score_s``, the ladder stepping up after 1
    s of burn: what lets real burn trip the ladder within the phase."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig, ObsConfig

    cfg = FrameworkConfig()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=SERVER_ROUND_S,
                                 rate_limit_default=1e9,
                                 rate_limit_api=1e9),
        obs=ObsConfig(slo_eval_interval_s=0.5, slo_fast_window_s=10.0,
                      slo_slow_window_s=60.0, slo_score_p99_s=0.001),
        serving=dataclasses.replace(cfg.serving,
                                    brownout_step_up_dwell_s=1.0))


def decode_b64_jpeg(b64: str):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def round_checks(cfg, record: dict, by_shape: dict, rows: dict) -> dict:
    """One server round's tallies against its derivation: the round at
    full quality against ``expected_tallies("default")``, at a tier
    against ``derived_round(cfg, tier)`` (either tier when the ladder
    moved while it ran); its image size; each flash shape a checked one,
    on the path its [kernel] check took."""
    from cassmantle_tpu_torch.serving import overload

    tallies = record["tallies"]
    out = {}
    matches = []
    for tier in sorted({record["tier"], record["tier_after"]}):
        if tier == 0:
            want = expected_tallies("default")
            size = cfg.sampler.image_size
        else:
            derived = derived_round(cfg, overload.DEFAULT_TIERS[tier])
            want = {k: (v if k == "flash_attention" else {})
                    for k, v in derived.items()}
            size = overload.degraded_sampler_cfg(
                cfg.sampler, overload.DEFAULT_TIERS[tier]).image_size
        matches.append(all(dict(tallies[k]) == dict(want[k])
                           for k in ("flash_attention", "gn_silu_conv3x3",
                                     "int8_matmul", "int8_conv3x3"))
                       and record["shape"] == (1, size, size, 3))
    out["launches_as_derived"] = any(matches)
    paths = [(shape in by_shape and path == rows[by_shape[shape]]["path"])
             for (shape, path) in tallies["flash_paths"]]
    out["flash_checked_shapes"] = bool(paths) and all(paths)
    return out


def check_server(card: str, rows: dict) -> bool:
    """[server]: the port's game server in this process at full width on
    the card: ``build_fabric(server_config())`` and ``create_app(fabric,
    cfg, device_health=True, self_addr=...)`` behind ``web.AppRunner`` and
    ``TCPSite`` on 127.0.0.1 at a picked port, the canary prober on at
    ``CASSMANTLE_PROBE_INTERVAL_S=0.5`` throughout, played over HTTP by
    an aiohttp client: /healthz (the CUDA probe ran and passed), /readyz,
    64 sessions in parallel through /init, /fetch/contents (a JPEG at the
    configured size), /compute_score (scores for the masked indices) and
    /client/status, a malformed body's 400, /clock (ticks, then the reset
    of a rotation), the new round served after it, /metrics in JSON and
    Prometheus text (``http.compute_score_s``, ``pipeline.images``, the
    device gauges from ``torch.cuda.memory_stats``), a ``traceparent``
    continued and its spans at /debugz, /sloz; then real burn: waves of
    1,024 out-of-vocabulary guesses until the ladder, read in process,
    is at tier >= 1, every rung stepped in an evaluation by the app's own
    SLO loop (a listener on the app's SLO engine names the evaluating
    task), and the next round the server generates at that tier. Every round the server generates is
    tallied as run_round tallies one (counts set to 0 just before,
    read just after, around ``t2i.generate``). Beside it:

    - [debug-trace], after the round at the tier: ``POST
      /debug/trace?seconds=4`` while rounds run answers 200 and writes a
      trace whose device events name the flash kernel (inside the
      rounds' graph replays); a second POST meanwhile answers 409;
    - [canary]: at least 10 probes over the phase, all passing, their
      ``probe.e2e_s`` p50 / p99 and the rung the near guess rode; the
      probes that overlapped the capture are reported apart (kineto
      writing a trace of a busy card holds the interpreter for seconds);
      ``/readyz``'s canary block ok with this worker as its target;
      ``/sloz``'s probe objectives with their traffic; then, with every
      score dispatch failing (``queue.dispatch`` raising on the score
      queue), a probe failing at leg ``score``, counted, recorded as
      ``probe.fail`` and its trace at ``/debugz``; and a second app under
      ``CASSMANTLE_NO_PROBER=1`` (the fake backend) leaving no probe
      artifact: no probe metric moves, no ``probe:`` store key, no probe
      objective, the canary block ``{"enabled": false}``."""
    import threading

    import aiohttp
    import torch
    from aiohttp import web

    from cassmantle_tpu_torch.obs import flight_recorder
    from cassmantle_tpu_torch.obs.slo import SloEngine
    from cassmantle_tpu_torch.server import app as server_app
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.utils.logging import metrics

    overload.reset_brownout()
    by_shape = {(b, sq, sk, h, d): name
                for name, (b, sq, sk, h, d, _) in FLASH_SHAPES.items()}
    t_phase = time.perf_counter()
    cfg = server_config()
    env_before = {k: os.environ.get(k) for k in (
        "CASSMANTLE_PROBE_INTERVAL_S", "CASSMANTLE_NO_PROBER",
        "CASSMANTLE_TRACE_ROOT")}
    os.environ["CASSMANTLE_PROBE_INTERVAL_S"] = str(CANARY_INTERVAL_S)
    os.environ.pop("CASSMANTLE_NO_PROBER", None)
    os.environ["CASSMANTLE_TRACE_ROOT"] = TRACE_ROOT
    probe_counts0 = probe_counts()
    size = cfg.sampler.image_size
    report, checks = {"card": card}, {}
    print("[server] build_fabric", flush=True)
    t0 = time.perf_counter()
    fabric = server_app.build_fabric(cfg, worker_id="smoke")
    report["build_s"] = time.perf_counter() - t0
    (svc,) = fabric.services
    t2i = svc.backend.t2i
    real_generate = t2i.generate
    rounds = []
    round_lock = threading.Lock()

    def tallied(prompts, seed=0, latents=None):
        with round_lock:
            reset_all_counters()
            tier = overload.current_tier()
            t = time.perf_counter()
            out = real_generate(prompts, seed, latents)
            rounds.append({"tier": tier, "tier_after": overload.current_tier(),
                           "tallies": read_tallies(), "shape": out.shape,
                           "s": time.perf_counter() - t})
        return out

    t2i.generate = tallied
    oov = 0
    boot_wall = time.time()
    # the registry is the process's: earlier phases generated images too
    images_before = metrics.counter_total("pipeline.images")

    def oov_guess() -> str:
        nonlocal oov
        oov += 1
        return f"srv{oov}q{oov * 7919 % 104729}x"

    # which evaluation stepped each rung: a listener added after the
    # ladder's runs in the same evaluate() pass and sees the tier the
    # ladder left, with the task that evaluated (the app's _slo_loop, or a
    # handler serving /readyz or /sloz)
    rungs = []
    seen_tier = [0]

    def witness(_verdicts):
        try:
            task = asyncio.current_task()
        except RuntimeError:
            task = None
        source = getattr(task.get_coro() if task is not None else None,
                         "__qualname__", "?")
        tier_now = overload.current_tier()
        if tier_now > seen_tier[0]:
            rungs.append({"to": tier_now, "by": source})
        seen_tier[0] = tier_now

    verdicts = []

    async def phase():
        print("[server] create_app and startup", flush=True)
        port = free_port()
        app = server_app.create_app(
            fabric, cfg, device_health=True,
            self_addr=f"http://127.0.0.1:{port}")
        next(v for v in app.values()
             if isinstance(v, SloEngine)).add_listener(witness)
        runner = web.AppRunner(app)
        nonlocal boot_wall
        boot_wall = time.time()
        t = time.perf_counter()
        await runner.setup()          # on_startup: the first round
        # every verdict the app's prober reaches, in order
        prober = server_app.prober_of(app)
        played = prober.probe_once

        async def recorded(*args, **kw):
            verdict = await played(*args, **kw)
            verdicts.append(verdict)
            return verdict

        prober.probe_once = recorded
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        report["boot_s"] = time.perf_counter() - t
        host, port = runner.addresses[0][:2]
        base = f"http://{host}:{port}"
        report["port"] = port
        http = aiohttp.ClientSession(
            base, connector=aiohttp.TCPConnector(limit=256))
        try:
            await play(http, base)
            await debug_trace(http, base)
            await canary(http, prober)
        finally:
            await http.close()
            print("[server] cleanup (handoff, rooms drained, queues "
                  "stopped)", flush=True)
            await runner.cleanup()

    async def play(http, base):
        print("[server] /healthz, /readyz", flush=True)
        async with http.get("/healthz") as res:
            health = await res.json()
            checks["healthz_200"] = res.status == 200
        probe = health.get("probe", {})
        report["healthz_probe"] = probe
        checks["healthz_cuda_probe"] = (
            health["device"] is True and probe.get("ok") is True
            and str(probe.get("device", "")).startswith("cuda"))
        async with http.get("/readyz") as res:
            checks["readyz_200"] = res.status == 200

        print(f"[server] {SERVER_SESSIONS} sessions: /init, "
              f"/fetch/contents, /compute_score, /client/status", flush=True)

        async def player(i):
            jar = aiohttp.CookieJar(unsafe=True)
            async with aiohttp.ClientSession(base, cookie_jar=jar) as s:
                async with s.get("/init") as res:
                    init = await res.json()
                t = time.perf_counter()
                async with s.get("/fetch/contents") as res:
                    data = await res.json()
                fetch_s = time.perf_counter() - t
                masks = data["prompt"]["masks"]
                guesses = {str(m): oov_guess() if j % 2 else "harbor"
                           for j, m in enumerate(masks)}
                t = time.perf_counter()
                async with s.post("/compute_score",
                                  json={"inputs": guesses}) as res:
                    scores = await res.json()
                    score_status = res.status
                guess_s = time.perf_counter() - t
                async with s.get("/client/status") as res:
                    status = await res.json()
                return {"init": init, "data": data, "fetch_s": fetch_s,
                        "scores": scores, "score_status": score_status,
                        "guess_s": guess_s, "status": status,
                        "masks": masks}

        played = await asyncio.gather(*(player(i)
                                        for i in range(SERVER_SESSIONS)))
        first = played[0]
        report["guess_ms"] = latency_ms([p["guess_s"] for p in played])
        report["fetch_ms"] = latency_ms([p["fetch_s"] for p in played])
        checks["sessions_initialized"] = all(
            p["init"]["message"] == "Session initialized"
            and p["status"] == {"won": 0, "needInitialization": False}
            for p in played)
        checks["fetch_jpeg_size"] = all(
            decode_b64_jpeg(p["data"]["image"]).shape == (size, size, 3)
            for p in played[::8])
        checks["scores_for_masks"] = all(
            p["score_status"] == 200
            and all(str(m) in p["scores"] for m in p["masks"])
            for p in played)
        async with http.post("/compute_score", data=b"not json") as res:
            checks["malformed_400"] = res.status == 400

        print("[server] /clock until a rotation", flush=True)
        ticks, t = 0, time.perf_counter()
        async with http.ws_connect("/clock") as ws:
            while time.perf_counter() - t < 3 * SERVER_ROUND_S:
                msg = await asyncio.wait_for(ws.receive_json(),
                                             timeout=SERVER_ROUND_S)
                checks.setdefault("clock_keys", True)
                checks["clock_keys"] &= set(msg) == {"time", "reset",
                                                     "conns"}
                if msg["reset"]:
                    break
                ticks += 1
        report["clock_ticks_before_reset"] = ticks
        report["rotation_wait_s"] = time.perf_counter() - t
        checks["clock_ticks"] = ticks >= 3
        checks["clock_reset"] = report["rotation_wait_s"] < \
            3 * SERVER_ROUND_S
        game = await fabric.game_for(fabric.default_room)
        current = await game.rounds.fetch_current_prompt()
        async with http.get("/fetch/contents") as res:
            after = await res.json()
        checks["new_round_served"] = (
            after["image"] != first["data"]["image"]
            and after["prompt"]["masks"] == current["masks"])

        print("[server] /metrics, traceparent, /debugz, /sloz", flush=True)
        async with http.get("/metrics") as res:
            snap = await res.json()
        async with http.get("/metrics",
                            headers={"Accept": "text/plain"}) as res:
            text = await res.text()
        hbm = {k: v for k, v in snap["gauges"].items()
               if k.startswith("device.hbm_bytes_in_use")}
        report["hbm_gauges"] = hbm
        report["pipeline_images"] = snap["counters"].get(
            "pipeline.images", 0) - images_before
        checks["metrics_json"] = (
            "http.compute_score_s" in snap["timings"]
            and report["pipeline_images"] >= 2
            and any(v > 0 for v in hbm.values()))
        checks["metrics_prometheus"] = all(
            s in text for s in ("cassmantle_http_compute_score_seconds_bucket",
                                "cassmantle_pipeline_images_total",
                                'cassmantle_device_hbm_bytes_in_use{device='))
        trace = os.urandom(16).hex()
        async with http.get("/client/status", headers={
                "traceparent": f"00-{trace}-{os.urandom(8).hex()}-01"}) as res:
            checks["traceparent_joined"] = res.headers.get(
                "X-Trace-Id") == trace
        async with http.get("/debugz", params={"trace": trace}) as res:
            spans = (await res.json()).get("spans", []) \
                if res.status == 200 else []
        checks["debugz_spans"] = any(s["name"] == "http.get /client/status"
                                     for s in spans)
        async with http.get("/sloz") as res:
            report["sloz_before"] = {n: o["state"] for n, o in
                                     (await res.json())["objectives"].items()}

        print("[server] real burn: waves of 1,024 out-of-vocabulary "
              "guesses until the SLO loop steps the ladder", flush=True)
        masks = current["masks"]
        t = time.perf_counter()
        waves, lat, shed, tier = 0, [], 0, 0

        async def burn_guess(w, i):
            t1 = time.perf_counter()
            async with http.post(
                    "/compute_score", params={"session": f"b{w}-{i}"},
                    json={"inputs": {str(masks[0]): oov_guess()}}) as res:
                await res.read()
                return res.status, time.perf_counter() - t1

        while time.perf_counter() - t < SERVER_BURN_S:
            res = await asyncio.gather(*(burn_guess(waves, i)
                                         for i in range(SERVE_GUESSES)))
            waves += 1
            lat += [dt for status, dt in res if status == 200]
            shed += sum(status == 503 for status, _ in res)
            # read in process: a /readyz or /sloz here would evaluate the
            # SLOs itself and could step the ladder in the loop's place
            tier = overload.current_tier()
            if tier >= 1:
                break
        report["tier_reached_s"] = time.perf_counter() - t
        report["burn"] = {"waves": waves, "shed": shed,
                          "guess_ms": latency_ms(lat), "tier": tier}
        async with http.get("/sloz") as res:
            slo = await res.json()
        report["burn"]["sloz"] = {
            n: {k: o[k] for k in ("state", "fast_burn", "slow_burn")}
            for n, o in slo["objectives"].items()}
        # this server's rungs (the recorder is the process's: earlier
        # phases stepped other ladders by the drill lever)
        steps = [e for e in flight_recorder.tail(
            200, kind="overload.brownout") if e["ts"] >= boot_wall]
        # each rung with its reason and seconds since the server booted
        report["ladder"] = [{"to": e["to_tier"], "reason": e["reason"],
                             "t_s": e["ts"] - boot_wall} for e in steps]
        report["rungs_by"] = rungs
        checks["ladder_stepped_by_slo_loop"] = (
            tier >= 1 and bool(steps) and bool(rungs)
            and all(e["reason"] == "slo_burn" for e in steps)
            and all(r["by"] == "_slo_loop" for r in rungs))

        print("[server] the next round at the tier", flush=True)
        t = time.perf_counter()
        while time.perf_counter() - t < SERVER_TIER_ROUND_S and not any(
                r["tier"] >= 1 for r in rounds):
            await asyncio.sleep(0.2)
        report["tier_round_wait_s"] = time.perf_counter() - t

    # the wall-clock window of the [debug-trace] capture
    window = [math.inf, math.inf]

    async def debug_trace(http, base):
        """[debug-trace]: a 4 s capture (consecutive windows bounded in
        seconds and graph launches) while a round runs and guesses are in
        flight throughout, a second capture refused meanwhile; the
        windows' hold-offs (the switches of the tracing, and launches
        waiting past a window's limit), the event loop's longest stall,
        the trace's events by kind and thread."""
        from cassmantle_tpu_torch.utils import profiling

        print("[server] [debug-trace] POST /debug/trace?seconds=4 while a "
              "round runs and guesses are scored", flush=True)
        seen = {"card": card}
        # the capture's windows, as utils/profiling.py::capture returns
        # them (the route answers trace_dir and seconds only)
        windows = []
        real_capture = profiling.capture

        def recorded_capture(*args, **kw):
            out = real_capture(*args, **kw)
            windows.append(out)
            return out

        profiling.capture = recorded_capture
        # a player whose guesses stay in flight across every window's
        # stop and write: 4 in a row at a time until the capture answers
        jar = aiohttp.CookieJar(unsafe=True)
        guesser = aiohttp.ClientSession(base, cookie_jar=jar)
        async with guesser.get("/init"):
            pass
        async with guesser.get("/fetch/contents") as res:
            masks = (await res.json())["prompt"]["masks"]
        guessed = []

        async def capture(seconds):
            async with http.post("/debug/trace", params={
                    "seconds": str(seconds), "name": "smoke"}) as res:
                return res.status, (await res.json() if res.status == 200
                                    else await res.text())

        # a hang shows where: every thread's stack each 120 s until done
        faulthandler.dump_traceback_later(120, repeat=True)
        held0 = held_off()
        window[0] = time.time()
        # 4 s of wall time: the round below, the tier's first (its graph
        # captured cold), takes up to ~3.3 s after its 0.3 s wait
        first = asyncio.ensure_future(capture(4))
        # the event loop's longest stall while the capture runs (the
        # profiler's stop and its writing hold the interpreter)
        stalls = [0.0]

        async def ticker():
            last = time.perf_counter()
            while not first.done():
                await asyncio.sleep(0.01)
                now = time.perf_counter()
                stalls.append(now - last - 0.01)
                last = now

        async def guess_loop():
            nonlocal masks
            while not first.done():
                t = time.perf_counter()
                async with guesser.post("/compute_score", json={
                        "inputs": {str(m): oov_guess()
                                   for m in masks}}) as res:
                    await res.read()
                    guessed.append((res.status, time.perf_counter() - t))
                if res.status != 200:       # a new round: its masks
                    async with guesser.get("/fetch/contents") as again:
                        masks = (await again.json())["prompt"]["masks"]
                await asyncio.sleep(0.05)

        ticking = asyncio.ensure_future(ticker())
        guessing = [asyncio.ensure_future(guess_loop()) for _ in range(4)]
        await asyncio.sleep(0.3)
        seen["second_status"], _ = await capture(0)
        # one round inside the window (the profiler starts at once: its
        # CUPTI set-up was paid by [profile]); every kernel of the window
        # lands in the trace, so one round keeps its writing short
        t = time.perf_counter()
        await asyncio.to_thread(t2i.generate, [SERVE_PROMPT], 4242)
        seen["round_s"] = time.perf_counter() - t
        seen["status"], body = await first
        faulthandler.cancel_dump_traceback_later()
        window[1] = time.time()
        await ticking
        await asyncio.gather(*guessing)
        await guesser.close()
        profiling.capture = real_capture
        seen["capture_s"] = window[1] - window[0]
        seen["loop_max_stall_s"] = max(stalls)
        seen["guesses"] = {"n": len(guessed),
                           "ok": sum(st == 200 for st, _ in guessed),
                           "statuses": dict(collections.Counter(
                               st for st, _ in guessed)),
                           **latency_ms([d for _, d in guessed])}
        win = windows[0] if windows else {}
        # graph launches held: by each switch of the tracing, and past a
        # window's launch limit until its stop (a switch's wait for the
        # graph lock, behind another thread's graph capture, is read
        # apart: the trace holds nothing then, the interpreter is free)
        holds = (win.get("start_s", []) + win.get("stop_s", [])
                 + win.get("launch_wait_s", []))
        seen["windows"] = {
            "n": len(win.get("paths", [])),
            "window_s": win.get("window_s"),
            "start_s": win.get("start_s"), "stop_s": win.get("stop_s"),
            "write_s": win.get("write_s"),
            "launches": win.get("launches"),
            "launched": win.get("launched"),
            "launch_wait_s": win.get("launch_wait_s"),
            "lock_wait_s": win.get("lock_wait_s"),
            "longest_lock_wait_s": max(win.get("lock_wait_s", []),
                                       default=None),
            "longest_hold_off_s": max(holds, default=None),
            "longest_stop_and_write_s": max(
                (a + b for a, b in zip(win.get("stop_s", []),
                                       win.get("write_s", []))),
                default=None)}
        # how long graph launches (every image dispatch's steps) were held
        # off by the capture's switches of the tracing
        held = held_off()
        seen["graphs_held_off"] = {"times": held[0] - held0[0],
                                   "s": held[1] - held0[1]}
        seen.update(trace_kernels(body))
        seen["reply"] = body
        report["debug_trace"] = seen
        checks["debug_trace_200"] = seen["status"] == 200
        checks["debug_trace_409"] = seen["second_status"] == 409
        checks["debug_trace_names_flash"] = seen.get("flash_events", 0) > 0
        checks["debug_trace_host_ranges"] = seen.get("host_ranges", 0) > 0
        # F2: no stop holds graph launches, nor the interpreter, past
        # half the probe's 5 s timeout
        checks["debug_trace_hold_off_le_2_5_s"] = (
            seen["windows"]["longest_hold_off_s"] is not None
            and seen["windows"]["longest_hold_off_s"] <= 2.5)
        checks["debug_trace_loop_stall_le_2_5_s"] = \
            seen["loop_max_stall_s"] <= 2.5
        # every guess answered (a 4xx for a round's stale masks is an
        # answer; a 5xx is not) within the canary probe's 5 s limit
        checks["debug_trace_guesses_ok"] = (
            seen["guesses"]["ok"] > 0
            and all(st < 500 for st, _ in guessed)
            and seen["guesses"]["max_ms"] <= 5000.0)

    async def canary(http, prober):
        """[canary]: the probes of the phase, the /readyz and /sloz
        blocks, then a probe failing at leg score under chaos."""
        from cassmantle_tpu_torch import chaos
        from cassmantle_tpu_torch.obs.trace import tracer

        print("[server] [canary] probes, /readyz, /sloz, a failing probe",
              flush=True)
        seen = {"card": card}
        # one more now: the burn's 1,024 traces may have pushed the loop's
        # last probe out of the trace ring
        fresh = await prober.probe_once()
        # every probe counts, those across [debug-trace]'s capture too;
        # these are also read apart
        during = [v for v in verdicts
                  if v["t"] + v["e2e_s"] >= window[0] and v["t"] <= window[1]]
        seen["probes"] = len(verdicts)
        seen["failed"] = [(v["leg"], v["error"]) for v in verdicts
                          if not v["ok"]][:4]
        seen["e2e_ms"] = latency_ms([v["e2e_s"] for v in verdicts])
        seen["during_capture"] = {
            "probes": len(during), "ok": sum(v["ok"] for v in during),
            "e2e_ms": latency_ms([v["e2e_s"] for v in during]),
            "failed": [(v["leg"], v["error"]) for v in during
                       if not v["ok"]][:4]}
        spans = tracer.get_trace(fresh["trace"])
        names = sorted({sp["name"] for sp in spans or []})
        seen["probe_spans"] = names
        seen["near_guess_rung"] = ("score-queue dispatch"
                                   if "score.batch_service" in names
                                   else "embed table")
        checks["canary_probes_all_ok"] = len(verdicts) >= CANARY_PROBES and \
            all(v["ok"] for v in verdicts)
        async with http.get("/readyz") as res:
            block = (await res.json())["canary"]
        seen["readyz"] = {k: block[k] for k in (
            "enabled", "ok", "consecutive_failures", "interval_s")}
        seen["targets"] = list(block["targets"])
        checks["canary_readyz"] = (block["enabled"] is True
                                   and block["ok"] is True
                                   and seen["targets"] == [fabric.worker_id])
        async with http.get("/sloz") as res:
            objectives = (await res.json())["objectives"]
        counts = probe_counts()
        seen["counts"] = {k: counts[k] - probe_counts0[k] for k in counts}
        seen["sloz"] = {n: {k: o[k] for k in ("state", "fast_burn",
                                               "slow_burn")}
                        for n, o in objectives.items()
                        if n.startswith("probe_")}
        checks["canary_slo_objectives"] = (
            set(seen["sloz"]) == {"probe_success", "probe_latency"}
            and seen["counts"]["ok"] >= CANARY_PROBES
            and seen["counts"]["e2e"] >= CANARY_PROBES)
        # every score dispatch fails: the near guess cannot be scored
        seq0 = flight_recorder.tail(1)[-1]["seq"]
        chaos.configure("seed=16;queue.dispatch=raise:peer=score")
        try:
            fault = await prober.probe_once()
        finally:
            chaos.disarm()
        events = [e for e in flight_recorder.tail(200, kind="probe.fail")
                  if e["seq"] > seq0]
        async with http.get("/debugz",
                            params={"trace": fault["trace"]}) as res:
            fault_spans = ((await res.json())["spans"]
                           if res.status == 200 else [])
        seen["fault"] = {"ok": fault["ok"], "leg": fault["leg"],
                         "error": fault["error"],
                         "failures": probe_counts()["failures"]
                         - counts["failures"],
                         "event": any(e.get("trace") == fault["trace"]
                                      for e in events),
                         "debugz_root": [sp["name"] for sp in fault_spans
                                         if sp["parent_id"] is None]}
        checks["canary_fault_at_score"] = (
            fault["ok"] is False and fault["leg"] == "score"
            and seen["fault"]["failures"] >= 1 and seen["fault"]["event"]
            and seen["fault"]["debugz_root"] == ["probe.run"])
        report["canary"] = seen

    async def no_prober():
        """A second app under CASSMANTLE_NO_PROBER=1 (the fake backend):
        no probe artifact over three of the prober's intervals."""
        os.environ["CASSMANTLE_NO_PROBER"] = "1"
        off = server_app.build_fabric(cfg, fake=True,
                                      worker_id="smoke-noprober")
        app = server_app.create_app(off, cfg, start_timer=False)
        runner = web.AppRunner(app)
        await runner.setup()
        port = free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        before = probe_counts()
        try:
            await asyncio.sleep(3 * CANARY_INTERVAL_S)
            async with aiohttp.ClientSession(
                    f"http://127.0.0.1:{port}") as s:
                async with s.get("/readyz") as res:
                    block = (await res.json())["canary"]
                async with s.get("/sloz") as res:
                    objectives = (await res.json())["objectives"]
        finally:
            await runner.cleanup()
        moved = {k: v - before[k] for k, v in probe_counts().items()}
        seen = {"prober": server_app.prober_of(app) is None,
                "canary": block, "probe_metrics_moved": moved,
                "probe_objectives": sorted(n for n in objectives
                                           if n.startswith("probe_")),
                "probe_store_keys": sorted(
                    k for k in off.store._data if k.startswith("probe:"))}
        report["canary_off"] = seen
        checks["no_prober_no_artifacts"] = (
            seen["prober"] and block == {"enabled": False}
            and not any(moved.values()) and not seen["probe_objectives"]
            and not seen["probe_store_keys"])

    try:
        asyncio.run(phase())
        asyncio.run(no_prober())
    finally:
        for key, value in env_before.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        del t2i.generate
        overload.reset_brownout()
    full = [r for r in rounds if r["tier"] == 0 and r["tier_after"] == 0]
    tiered = [r for r in rounds if r["tier"] >= 1]
    report["rounds"] = [{"tier": r["tier"], "tier_after": r["tier_after"],
                         "size": r["shape"][1], "s": r["s"],
                         "flash": sum(r["tallies"]["flash_attention"]
                                      .values())} for r in rounds]
    checks["full_round_tallied"] = bool(full) and all(
        all(round_checks(cfg, r, by_shape, rows).values()) for r in full)
    checks["tier_round_tallied"] = bool(tiered) and all(
        all(round_checks(cfg, r, by_shape, rows).values()) for r in tiered)
    if tiered:
        report["tier_round"] = {"tier": tiered[0]["tier"],
                                "size": tiered[0]["shape"][1],
                                "s": tiered[0]["s"]}
    report["step_down"] = ("not driven on the card (slow window 60 s and "
                           "step-down dwell 30 s); held on the CPU")
    report["phase_s"] = time.perf_counter() - t_phase
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[server] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    del fabric, svc, t2i, real_generate
    gc.collect()
    torch.cuda.empty_cache()
    return ok


CANARY_INTERVAL_S = 0.5       # the prober's cadence in [server], [serve-cli]
SERVE_CLI_CANARY_S = 20.0     # [serve-cli]'s wait for its first verdict
CANARY_PROBES = 10            # probes [server] must see pass
# where /debug/trace writes in [server] (git-ignored; removed after)
TRACE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "cassmantle_tpu_torch", "_build", "traces")


def probe_counts() -> dict:
    """The process's probe.ok and probe.failures counters and probe.e2e_s
    observations so far."""
    from cassmantle_tpu_torch.utils.logging import metrics

    hist = metrics.hist_totals("probe.e2e_s")
    return {"ok": metrics.counter_total("probe.ok"),
            "failures": metrics.counter_total("probe.failures"),
            "e2e": hist[2] if hist else 0}


def held_off() -> tuple:
    """(times, seconds) graph launches were held off so far
    (``graphs.held_off_s``)."""
    from cassmantle_tpu_torch.utils.logging import metrics

    hist = metrics.snapshot()["timings"].get("graphs.held_off_s")
    if not hist:
        return 0, 0.0
    return hist["count"], hist["count"] * hist["mean_s"]


def trace_kernels(reply) -> dict:
    """The events of a /debug/trace capture's Chrome traces (one file a
    window): by category ("kernel", "cuda_runtime", "cpu_op",
    "user_annotation", ...), the threads they came from, the kernel
    events naming flash, the host ranges of the pipelines
    (``utils/profiling.py::annotate``) and the traces' bytes; the traces
    are removed after."""
    import glob
    import shutil

    if not isinstance(reply, dict) or "trace_dir" not in reply:
        return {}
    files = sorted(glob.glob(os.path.join(reply["trace_dir"], "*.json")))
    if not files:
        return {"trace_files": 0}
    by_cat, threads, kernels, ranges, size = (collections.Counter(), set(),
                                              [], set(), 0)
    for path in files:
        size += os.path.getsize(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            cat = e.get("cat")
            if cat is None:
                continue
            by_cat[cat] += 1
            threads.add((cat if cat == "kernel" else "host", e.get("tid")))
            if cat == "kernel":
                kernels.append(e.get("name", ""))
            elif cat == "user_annotation":
                ranges.add(e.get("name", ""))
    out = {"trace_files": len(files), "trace_bytes": size,
           "events_by_category": dict(by_cat.most_common()),
           "host_threads": sum(1 for k, _ in threads if k == "host"),
           "kernel_events": len(kernels),
           "flash_events": sum("flash" in k for k in kernels),
           "flash_names": sorted({k for k in kernels if "flash" in k})[:4],
           "host_ranges": len(ranges),
           "range_names": sorted(ranges)[:12]}
    shutil.rmtree(reply["trace_dir"], ignore_errors=True)
    return out


def free_port() -> int:
    """A port the kernel has just handed out on 127.0.0.1."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def log_tail(path: str, n: int = 60) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError as exc:
        return f"(no log: {exc})"


def stop_child(proc, grace_s: float = 30.0):
    """SIGINT, at most ``grace_s`` to exit, then SIGKILL; reaped either
    way. Returns (exit code, seconds to exit after SIGINT)."""
    import signal

    if proc.poll() is not None:
        return proc.returncode, 0.0
    t = time.perf_counter()
    proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout=grace_s), time.perf_counter() - t
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return None, time.perf_counter() - t


def check_serve_cli(card: str) -> tuple:
    """[serve-cli]: ``python -m cassmantle_tpu_torch serve --host
    127.0.0.1 --port <picked> --round-seconds 60`` as a child process on
    the card (started after [build], so it loads the libraries the parent
    built), its output in the git-ignored ``_build/serve_cli.log``: /readyz
    200 within 240 s, one session through /init, /fetch/contents,
    /compute_score and /client/status, /healthz's CUDA probe, then SIGINT:
    exit 0 (or -SIGINT) within 30 s with the graceful handoff in its log.
    The child runs its canary prober (at ``CASSMANTLE_PROBE_INTERVAL_S``
    0.5) and the leak census (``CASSMANTLE_LEAK_SENTINEL=1``): its
    /readyz canary block must read ok, and its ``leaks.*`` counters are
    reported just before the SIGINT. The port is picked by binding
    127.0.0.1:0; a child that could not bind it gets one more pick.
    Returns (ok, the log's tail)."""
    import signal
    import urllib.error
    import urllib.request

    import aiohttp

    report, checks = {"card": card}, {}
    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(SERVE_CLI_LOG), exist_ok=True)

    def ready(port: int) -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as res:
                return res.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def readyz(port: int) -> dict:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as res:
                return json.load(res)
        except urllib.error.HTTPError as exc:     # 503: the body still says
            return json.load(exc)
        except (urllib.error.URLError, OSError):
            return {}

    async def play(port: int):
        jar = aiohttp.CookieJar(unsafe=True)
        async with aiohttp.ClientSession(f"http://127.0.0.1:{port}",
                                         cookie_jar=jar) as s:
            async with s.get("/init") as res:
                init = await res.json()
            async with s.get("/fetch/contents") as res:
                data = await res.json()
            masks = data["prompt"]["masks"]
            async with s.post("/compute_score", json={"inputs": {
                    str(m): f"cli{i}q7919x" for i, m in enumerate(masks)}}
                    ) as res:
                scores = await res.json()
            async with s.get("/client/status") as res:
                status = await res.json()
            async with s.get("/healthz") as res:
                health = await res.json()
        return init, data, masks, scores, status, health

    proc = None
    try:
        for attempt in range(2):
            port = free_port()
            cmd = [sys.executable, "-m", "cassmantle_tpu_torch", "serve",
                   "--host", "127.0.0.1", "--port", str(port),
                   "--round-seconds", str(SERVE_CLI_ROUND_S)]
            print(f"[serve-cli] starting: {' '.join(cmd[1:])}", flush=True)
            t0 = time.perf_counter()
            env = {**os.environ, "CASSMANTLE_LEAK_SENTINEL": "1",
                   "CASSMANTLE_PROBE_INTERVAL_S": str(CANARY_INTERVAL_S)}
            env.pop("CASSMANTLE_NO_PROBER", None)
            with open(SERVE_CLI_LOG, "w") as log:
                proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                        stderr=subprocess.STDOUT,
                                        stdin=subprocess.DEVNULL, env=env)
            while time.perf_counter() - t0 < SERVER_READY_S:
                if proc.poll() is not None or ready(port):
                    break
                time.sleep(0.5)
            if proc.poll() is not None and attempt == 0 and \
                    "address already in use" in log_tail(SERVE_CLI_LOG
                                                         ).lower():
                print(f"[serve-cli] port {port} taken; picking again",
                      flush=True)
                continue
            break
        report["boot_to_ready_s"] = time.perf_counter() - t0
        checks["ready"] = proc.poll() is None and ready(port)
        if not checks["ready"]:
            raise RuntimeError(f"no /readyz 200 within {SERVER_READY_S} s")
        print("[serve-cli] one session: /init, /fetch/contents, "
              "/compute_score, /client/status, /healthz", flush=True)
        init, data, masks, scores, status, health = asyncio.run(play(port))
        checks["session"] = (
            init["message"] == "Session initialized"
            and decode_b64_jpeg(data["image"]).shape == (512, 512, 3)
            and all(str(m) in scores for m in masks)
            and status == {"won": 0, "needInitialization": False})
        report["healthz_probe"] = health.get("probe")
        checks["healthz_cuda_probe"] = (
            health.get("device") is True
            and (health.get("probe") or {}).get("ok") is True
            and str(health["probe"].get("device", "")).startswith("cuda"))
        # the child's canary through its own listener, then its leak
        # census at exit
        t0 = time.perf_counter()
        canary = {}
        while time.perf_counter() - t0 < SERVE_CLI_CANARY_S:
            canary = readyz(port).get("canary", {})
            if canary.get("ok") is not None:
                break
            time.sleep(0.25)
        report["canary"] = {"wait_s": time.perf_counter() - t0,
                            **{k: canary.get(k) for k in (
                                "enabled", "ok", "consecutive_failures")},
                            "targets": list(canary.get("targets", {}))}
        checks["canary_ok"] = canary.get("enabled") is True and \
            canary.get("ok") is True
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as res:
            counters = json.load(res)["counters"]
        report["leaks_at_exit"] = {k: counters.get(f"leaks.{k}", 0.0)
                                   for k in ("threads", "tasks", "fds")}
        report["probes"] = {k: v for k, v in counters.items()
                            if k.startswith("probe.")}
        print("[serve-cli] SIGINT", flush=True)
        rc, exit_s = stop_child(proc)
        report.update(exit_code=rc, exit_s=exit_s)
        checks["exit_clean"] = rc in (0, -signal.SIGINT)
        checks["graceful_handoff"] = "graceful handoff complete" in \
            log_tail(SERVE_CLI_LOG, 400)
    except Exception as exc:
        report["error"] = f"{type(exc).__name__}: {exc}"
        checks["no_error"] = False
    finally:
        if proc is not None:
            stop_child(proc)
    report["phase_s"] = time.perf_counter() - t_phase
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[serve-cli] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    return ok, log_tail(SERVE_CLI_LOG)


# -- [cluster]: a card worker in a two-worker fleet ---------------------------

CLUSTER_ROUND_S = 60.0        # --round-seconds of both workers in [cluster]
CLUSTER_ROOMS = 4             # --rooms of the fleet
CLUSTER_LEASE_MS = 1500       # the store leader's lease
CLUSTER_POLL_MS = 20          # the replication pump's poll
CLUSTER_PROBE_S = 2.0         # the canary's cadence in [cluster]
CLUSTER_READY_S = 60.0        # deadline for the fleet to converge
CLUSTER_PLAYERS = 16          # guess loops across the leader kill
CLUSTER_PEER_LOG = os.path.join(REPO, "cassmantle_tpu_torch", "_build",
                                "cluster_peer.log")


def cluster_config():
    """``FrameworkConfig()`` as the [cluster] card worker serves it: 60 s
    rounds over 4 rooms, rate limits one loopback client can drive, the
    store's 1.5 s lease (failover grace 2 x 1.5 + 3 = 6 s) and its pump's
    20 ms poll."""
    import dataclasses

    from cassmantle_tpu_torch.config import FrameworkConfig

    cfg = FrameworkConfig()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=CLUSTER_ROUND_S,
                                 rate_limit_default=1e9,
                                 rate_limit_api=1e9),
        fabric=dataclasses.replace(
            cfg.fabric, num_rooms=CLUSTER_ROOMS,
            repl_lease_s=CLUSTER_LEASE_MS / 1000.0,
            repl_poll_s=CLUSTER_POLL_MS / 1000.0))


def cluster_worker_ids(cfg) -> tuple:
    """(card worker id, peer worker id) whose ring leaves the default
    room and at least one other room on the card and at least one room on
    the peer."""
    from cassmantle_tpu_torch.fabric.directory import RoomDirectory
    from cassmantle_tpu_torch.fabric.rooms import room_ids

    for i in range(400):
        card, peer = f"card-{i % 20}", f"peer-{i // 20}"
        owners = RoomDirectory(room_ids(cfg), workers=[card, peer],
                               vnodes=cfg.fabric.vnodes).placement()
        card_rooms = [r for r, w in owners.items() if w == card]
        if owners[cfg.fabric.default_room] == card and \
                2 <= len(card_rooms) < len(owners):
            return card, peer
    raise RuntimeError("no pair of worker ids splits the rooms")


def exact_metric_lines(text: str) -> list:
    """The exposition's counter, histogram-bucket, _count and _sum lines,
    sorted: what a merge must reproduce exactly (gauges are per worker
    and sampled at each scrape)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name = re.split(r"[{ ]", line, maxsplit=1)[0]
        if name.endswith(("_total", "_count", "_sum")) or "_bucket{" in line:
            out.append(line)
    return sorted(out)


def check_cluster(card: str, rows: dict, cfg=None, device="cuda") -> bool:
    """[cluster]: a card worker in a two-worker fleet over a replicated
    store. The card worker is the port's server in this process
    (``build_fabric(cluster_config(), store_addr="repl:...",
    worker_id=..., advertise_addr=...)`` and ``create_app(...,
    device_health=True)`` on 127.0.0.1): ``FrameworkConfig()`` at full
    width, every round it generates tallied around ``t2i.generate`` as
    [server] tallies them. Beside it, started while it boots: two
    mantlestore nodes of the port's build (``native/client.py``: a
    ``--repl`` leader and a ``--follower``, 1.5 s lease) and a ``--fake``
    peer (``python -m cassmantle_tpu_torch serve --fake --store repl:...
    --rooms 4 --advertise ...`` as a child, its log in
    ``_build/cluster_peer.log``), both workers' canary at 2 s. Checks,
    with the seconds of each step:

    - spread: both workers' rings agree and each owns rooms;
    - redirect: the peer answers a card room 307 to the card worker's
      address (room, session, a signed traceparent), the followed fetch
      is the card's 512x512 JPEG in the same trace; the redirect's added
      latency (median of three fetches through the peer less three
      direct ones);
    - federation: ``/metrics?scope=cluster`` of each worker (Prometheus
      text) equals ``merge_states`` of both workers' ``?format=state``
      read around it (counters, buckets, counts and sums; retried until
      the states read before and after agree), peer_up 1 for both;
    - canary: each worker's prober has probed both workers through
      their listeners: its own probe ok, the other worker's past init and
      clock, at fetch ok or refused on the masks alone (a probe's answers
      come from its own worker's embedding; the fake peer's hash
      embedding masks other words than the card's MiniLM);
    - failover: SIGKILL of the store leader while 16 players guess in the
      card's rooms: every guess answered 200 with its scores, the card's
      store on the follower within ``failover_grace_s``, the peer's too,
      every room's round (prompt, image, episode) and a won score as
      before;
    - adoption: SIGINT of the peer: it exits 0 after its graceful
      handoff (its adoption wait met, not timed out), and the card
      worker owns every room within ``handoff_grace_s``; the card then
      generates the next round of an adopted room (``rotate_room``, the
      buffer step, ``rotate_room``), whose tally is a full round's
      (flash 1,601 at tier 0), served as a 512x512 JPEG."""
    import signal
    import threading

    import aiohttp
    import torch
    from aiohttp import web

    from cassmantle_tpu_torch.fabric.rooms import room_prefix
    from cassmantle_tpu_torch.native.client import spawn_server
    from cassmantle_tpu_torch.server import app as server_app
    from cassmantle_tpu_torch.serving import overload
    from cassmantle_tpu_torch.utils.logging import merge_states

    overload.reset_brownout()
    cfg = cfg or cluster_config()
    by_shape = {(b, sq, sk, h, d): name
                for name, (b, sq, sk, h, d, _) in FLASH_SHAPES.items()}
    t_phase = time.perf_counter()
    steps, report, checks = {}, {"card": card}, {}
    card_id, peer_id = cluster_worker_ids(cfg)
    env_before = {k: os.environ.get(k) for k in (
        "CASSMANTLE_PROBE_INTERVAL_S", "CASSMANTLE_NO_PROBER",
        "CASSMANTLE_NO_BROWNOUT")}
    os.environ["CASSMANTLE_PROBE_INTERVAL_S"] = str(CLUSTER_PROBE_S)
    os.environ.pop("CASSMANTLE_NO_PROBER", None)
    # the failover's seconds-long guesses must not brown the rounds out
    os.environ["CASSMANTLE_NO_BROWNOUT"] = "1"
    os.makedirs(os.path.dirname(CLUSTER_PEER_LOG), exist_ok=True)
    nodes, peer = {}, None

    def start_nodes():
        # the build (g++, a few seconds) and both nodes
        nodes["leader"] = spawn_server(0, repl=True, repl_id="L",
                                       lease_ms=CLUSTER_LEASE_MS)
        nodes["follower"] = spawn_server(0, follower=True, repl_id="F",
                                         lease_ms=CLUSTER_LEASE_MS)

    rounds, round_lock = [], threading.Lock()
    fabric = svc = t2i = None

    def tallied(prompts, seed=0, latents=None):
        with round_lock:
            reset_all_counters()
            tier = overload.current_tier()
            t = time.perf_counter()
            out = real_generate(prompts, seed, latents)
            rounds.append({"tier": tier,
                           "tier_after": overload.current_tier(),
                           "tallies": read_tallies(), "shape": out.shape,
                           "t0": t, "t1": time.perf_counter()})
        return out

    async def get_json(http, url, **kw):
        async with http.get(url, **kw) as res:
            return res.status, await res.json()

    async def store_round(room):
        """(prompt JSON, image bytes, episode) of a room, as stored."""
        prefix = room_prefix(room, cfg.fabric.default_room)
        return (await fabric.store.hget(prefix + "prompt", "current"),
                await fabric.store.hget(prefix + "image", "current"),
                await fabric.store.hget(prefix + "story", "episode"))

    async def phase():
        nonlocal peer
        app = server_app.create_app(fabric, cfg, device_health=True,
                                    self_addr=base)
        runner = web.AppRunner(app)
        with open(CLUSTER_PEER_LOG, "w") as log:
            peer = subprocess.Popen(peer_cmd, cwd=REPO, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL, env=peer_env)
        await runner.setup()     # elects the leader, the first round
        await web.TCPSite(runner, "127.0.0.1", port).start()
        steps["boot"] = time.perf_counter() - t0
        http = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=64))
        try:
            await converge(http)
            await redirect(http)
            await federation(http)
            await canary(http, server_app.prober_of(app))
            await failover(http)
            await adoption(http)
        finally:
            await http.close()
            print("[cluster] cleanup", flush=True)
            await runner.cleanup()

    async def converge(http):
        print("[cluster] both workers in one ring", flush=True)
        t = time.perf_counter()
        placement, peer_view = {}, {}
        while time.perf_counter() - t < CLUSTER_READY_S:
            if peer.poll() is not None:
                raise RuntimeError(f"the peer exited: {peer.returncode}")
            placement = fabric.directory.placement()
            try:
                _, ready = await get_json(http, peer_base + "/readyz")
                peer_view = ready.get("fabric", {}).get("rooms", {})
            except (aiohttp.ClientError, ValueError):
                peer_view = {}
            if placement == peer_view and \
                    set(placement.values()) == {card_id, peer_id}:
                break
            # the peer's rate limit: three /readyz a second
            await asyncio.sleep(0.4)
        steps["converge"] = time.perf_counter() - t
        report["placement"] = placement
        checks["rooms_spread"] = placement == peer_view and \
            set(placement.values()) == {card_id, peer_id}

    async def redirect(http):
        print("[cluster] a card room asked of the peer: 307", flush=True)
        t = time.perf_counter()
        placement = report["placement"]
        room = next(r for r, w in sorted(placement.items())
                    if w == card_id and r != cfg.fabric.default_room)
        report["redirect_room"] = room
        q = {"room": room, "session": "cl-hop"}
        async with http.get(peer_base + "/fetch/contents", params=q,
                            allow_redirects=False) as res:
            loc = res.headers.get("Location", "")
            checks["redirect_307"] = res.status == 307 and \
                loc.startswith(base + "/fetch/contents?") and \
                f"room={room}" in loc and "session=cl-hop" in loc and \
                "traceparent=00-" in loc and "tracesig=" in loc
        via, direct = [], []
        for i in range(3):
            if i:
                # the peer's own rate limit: 2 a second a route and room
                await asyncio.sleep(0.6)
            t1 = time.perf_counter()
            async with http.get(peer_base + "/fetch/contents",
                                params=q) as res:
                data = await res.json()
                # the peer's 307 and the card's answer: one trace
                hops = [h.headers.get("X-Trace-Id") for h in res.history]
                followed = (res.status, str(res.url), hops,
                            res.headers.get("X-Trace-Id"))
            via.append(time.perf_counter() - t1)
            if i == 0:
                first = (data, followed)
            t1 = time.perf_counter()
            async with http.get(base + "/fetch/contents", params=q) as res:
                await res.read()
            direct.append(time.perf_counter() - t1)
        data, (status, url, hops, trace) = first
        report["redirect_trace"] = {"hops": hops, "followed": trace}
        checks["redirect_followed"] = (
            status == 200 and url.startswith(base)
            and decode_b64_jpeg(data["image"]).shape == (512, 512, 3)
            and len(hops) == 1 and hops[0] == trace)
        report["redirect_ms"] = {
            "via_peer_p50": 1e3 * sorted(via)[1],
            "direct_p50": 1e3 * sorted(direct)[1],
            "added_p50": 1e3 * (sorted(via)[1] - sorted(direct)[1])}
        steps["redirect"] = time.perf_counter() - t

    def merged_lines(states):
        return exact_metric_lines(merge_states(states).prometheus())

    async def federation(http):
        print("[cluster] /metrics?scope=cluster on both workers", flush=True)
        t = time.perf_counter()
        views = {}
        for name, (self_base, other_base) in (
                ("card", (base, peer_base)), ("peer", (peer_base, base))):
            for attempt in range(20):
                # the peer's rate limit: three /metrics a second, and an
                # attempt asks three of it
                await asyncio.sleep(1.1)
                before = [await get_json(http, b + "/metrics",
                                         params={"format": "state"})
                          for b in (self_base, other_base)]
                async with http.get(self_base + "/metrics",
                                    params={"scope": "cluster"},
                                    headers={"Accept": "text/plain"}) as res:
                    text = await res.text()
                after = [await get_json(http, b + "/metrics",
                                        params={"format": "state"})
                         for b in (self_base, other_base)]
                states = [(body["worker"], body["state"])
                          for _, body in before]
                quiet = all(merged_lines([pair]) == merged_lines(
                    [(body["worker"], body["state"])])
                    for pair, (_, body) in zip(states, after))
                if quiet:
                    break
            want = merged_lines(states)
            views[name] = {
                "attempts": attempt + 1, "quiet": quiet,
                "lines": len(want),
                "equal": exact_metric_lines(text) == want,
                "peer_up": all(
                    f'cassmantle_federation_peer_up{{worker="{w}"}} 1' in text
                    for w in (card_id, peer_id))}
        report["federation"] = views
        checks["federation_exact"] = all(
            v["quiet"] and v["equal"] and v["peer_up"]
            for v in views.values())
        steps["federation"] = time.perf_counter() - t

    async def canary(http, prober):
        """Each worker's canary probes itself and its peer through the
        listeners. Its own probe passes. A probe of the other worker
        passes the init and clock legs and fails at fetch, on the masks:
        a probe derives its answers from its own worker's embedding
        (``obs/prober.py::probe_state``, as the reference does: one model
        config a fleet), and the fake peer's hash embedding masks other
        words of the probe sentence than the card's MiniLM."""
        print("[cluster] the canary of both workers", flush=True)
        t = time.perf_counter()
        want = {card_id, peer_id}
        blocks = {}

        def settled(block, own):
            targets = block.get("targets", {})
            return set(targets) == want and targets[own]["ok"] is True

        while time.perf_counter() - t < 6 * CLUSTER_PROBE_S:
            _, ready = await get_json(http, peer_base + "/readyz")
            blocks = {"card": prober.status_block(),
                      "peer": ready.get("canary", {})}
            if settled(blocks["card"], card_id) and \
                    settled(blocks["peer"], peer_id):
                break
            await asyncio.sleep(0.4)
        report["canary"] = {
            name: {w: {k: v.get(k) for k in ("ok", "leg", "error", "e2e_s")}
                   for w, v in b.get("targets", {}).items()}
            for name, b in blocks.items()}
        checks["canary_self_ok"] = settled(blocks["card"], card_id) and \
            settled(blocks["peer"], peer_id)
        checks["canary_walks_the_peer"] = all(
            v["ok"] is True
            or (v["leg"] == "fetch" and "masks" in (v["error"] or ""))
            for b in report["canary"].values() for v in b.values())
        steps["canary"] = time.perf_counter() - t

    async def failover(http):
        print("[cluster] SIGKILL of the store leader under guesses",
              flush=True)
        t = time.perf_counter()
        card_rooms = sorted(r for r, w in report["placement"].items()
                            if w == card_id)
        # every card room live (its first round made), and a won score
        for room in card_rooms:
            async with http.get(base + "/fetch/contents", params={
                    "room": room, "session": "cl-warm"}) as res:
                await res.read()
        lobby = cfg.fabric.default_room
        prompt = json.loads((await store_round(lobby))[0])
        mask = prompt["masks"][0]
        q = {"room": lobby, "session": "cl-win"}
        async with http.get(base + "/fetch/contents", params=q) as res:
            await res.read()
        async with http.post(base + "/compute_score", params=q, json={
                "inputs": {str(mask): prompt["tokens"][mask]}}) as res:
            won_before = (await res.json()).get(str(mask))
        before = {r: await store_round(r) for r in card_rooms}
        answered, failed = [], []
        stop = asyncio.Event()

        async def player(i):
            room = card_rooms[i % len(card_rooms)]
            pq = {"room": room, "session": f"cl-p{i}"}
            async with http.get(base + "/fetch/contents", params=pq) as res:
                masks = (await res.json())["prompt"]["masks"]
            n = 0
            while not stop.is_set():
                n += 1
                t1 = time.perf_counter()
                try:
                    async with http.post(base + "/compute_score", params=pq,
                                         json={"inputs": {
                                             str(m): f"cl{i}q{n}x"
                                             for m in masks}}) as res:
                        body = await res.json()
                        ok = res.status == 200 and all(
                            str(m) in body for m in masks)
                except (aiohttp.ClientError, ValueError) as exc:
                    ok, body = False, repr(exc)
                if ok:
                    answered.append(time.perf_counter() - t1)
                else:
                    failed.append(str(body)[:200])
                await asyncio.sleep(0.02)

        players = [asyncio.ensure_future(player(i))
                   for i in range(CLUSTER_PLAYERS)]
        await asyncio.sleep(0.5)
        store = fabric.store
        follower_ep = f"127.0.0.1:{fport}"
        nodes["leader"].kill()
        nodes["leader"].wait()
        t_kill = time.perf_counter()
        while store.status()["leader"] != follower_ep and \
                time.perf_counter() - t_kill < 2 * store.failover_grace_s:
            await asyncio.sleep(0.01)
        failover_s = time.perf_counter() - t_kill
        await asyncio.sleep(1.0)     # guesses go on against the follower
        stop.set()
        await asyncio.gather(*players)
        after = {r: await store_round(r) for r in card_rooms}
        game = await fabric.game_for(lobby)
        won_after = (await game.sessions.fetch_scores("cl-win")).get(
            str(mask))
        _, peer_ready = await get_json(http, peer_base + "/readyz")
        peer_repl = peer_ready.get("fabric", {}).get("replication", {})
        status = store.status()
        report["failover"] = {
            "failover_s": failover_s,
            "failover_grace_s": store.failover_grace_s,
            "card_store": status, "peer_store": peer_repl,
            "guesses": len(answered), "unanswered": len(failed),
            "unanswered_first": failed[:3],
            "guess_max_ms": 1e3 * max(answered, default=0.0)}
        # the worker whose election came first promotes; the other finds
        # the follower already leading
        checks["failover_within_grace"] = (
            status["leader"] == follower_ep
            and peer_repl.get("leader") == follower_ep
            and status["failovers"] + peer_repl.get("failovers", 0) >= 1
            and failover_s < store.failover_grace_s)
        checks["guesses_answered"] = bool(answered) and not failed
        report["failover"].update(
            rounds_changed={r: [k for k, x, y in zip(
                ("prompt", "image", "episode"), before[r], after[r])
                if x != y] for r in card_rooms if before[r] != after[r]},
            won_score={"before": won_before, "after": won_after})
        checks["round_state_survives"] = before == after and \
            float(won_before) == 1.0 and float(won_after) == 1.0
        steps["failover"] = time.perf_counter() - t

    async def adoption(http):
        print("[cluster] SIGINT of the peer: adoption, then the next round "
              "of an adopted room on the card", flush=True)
        t = time.perf_counter()
        room = next(r for r, w in sorted(report["placement"].items())
                    if w == peer_id)
        report["adopted_room"] = room
        # the room runs on the peer first: its round is the fake backend's
        q = {"room": room, "session": "cl-adopt"}
        async with http.get(peer_base + "/fetch/contents", params=q) as res:
            data = await res.json()
            checks["peer_room_served"] = res.status == 200 and \
                str(res.url).startswith(peer_base)
        peer.send_signal(signal.SIGINT)
        t_int = time.perf_counter()
        while set(fabric.directory.placement().values()) != {card_id} \
                and time.perf_counter() - t_int < 4 * \
                cfg.fabric.handoff_grace_s:
            await asyncio.sleep(0.02)
        adopt_s = time.perf_counter() - t_int
        loop = asyncio.get_running_loop()
        rc = await loop.run_in_executor(None, peer.wait, 30)
        tail = log_tail(CLUSTER_PEER_LOG, 400)
        report["adoption"] = {"adopt_s": adopt_s,
                              "handoff_grace_s": cfg.fabric.handoff_grace_s,
                              "peer_exit": rc,
                              "peer_exit_s": time.perf_counter() - t_int}
        checks["adopted_within_grace"] = (
            set(fabric.directory.placement().values()) == {card_id}
            and adopt_s < cfg.fabric.handoff_grace_s)
        checks["peer_handoff_clean"] = (
            rc in (0, -signal.SIGINT)
            and "graceful handoff complete" in tail
            and "handoff grace" not in tail)
        # the adopted room's next round, generated on the card
        game = await fabric.game_for(room)
        backend = game.rounds.backend
        spans = []

        class RoomBackend:
            """The shared backend, the adopted room's calls timed."""

            def __getattr__(self, name):
                return getattr(backend, name)

            async def generate(self, seed, is_seed):
                t1 = time.perf_counter()
                try:
                    return await backend.generate(seed, is_seed)
                finally:
                    spans.append((t1, time.perf_counter()))

        game.rounds.backend = RoomBackend()
        t1 = time.perf_counter()
        prefix = room_prefix(room, cfg.fabric.default_room)
        if await fabric.store.hget(prefix + "prompt", "next") is not None:
            await fabric.rotate_room(room)   # the peer's buffered round
        await game.rounds.buffer_contents()  # the next round, on the card
        await fabric.rotate_room(room)       # ... served
        report["adopted_round_s"] = time.perf_counter() - t1
        mine = [r for r in rounds for s0, s1 in spans
                if s0 <= r["t0"] and r["t1"] <= s1]
        async with http.get(base + "/fetch/contents", params=q) as res:
            data = await res.json()
        report["adopted_round"] = {
            "rounds": len(mine),
            "flash": [sum(r["tallies"]["flash_attention"].values())
                      for r in mine],
            "size": decode_b64_jpeg(data["image"]).shape[0]}
        checks["adopted_round_on_card"] = (
            len(mine) == 1
            and all(round_checks(cfg, mine[0], by_shape, rows).values())
            and report["adopted_round"]["size"] == 512)
        steps["adoption"] = time.perf_counter() - t

    try:
        print("[cluster] store nodes, card worker, peer", flush=True)
        t0 = time.perf_counter()
        start_nodes()
        port, peer_port = free_port(), free_port()
        base, peer_base = f"http://127.0.0.1:{port}", \
            f"http://127.0.0.1:{peer_port}"
        t_build = time.perf_counter()
        lport, fport = nodes["leader"].port, nodes["follower"].port
        store_addr = f"repl:127.0.0.1:{lport},127.0.0.1:{fport}"
        fabric = server_app.build_fabric(cfg, store_addr=store_addr,
                                         worker_id=card_id,
                                         advertise_addr=base, device=device)
        report["build_s"] = time.perf_counter() - t_build
        (svc,) = fabric.services
        t2i = svc.backend.t2i
        real_generate = t2i.generate
        t2i.generate = tallied
        peer_cmd = [sys.executable, "-m", "cassmantle_tpu_torch", "serve",
                    "--fake", "--host", "127.0.0.1", "--port", str(peer_port),
                    "--store", store_addr, "--rooms", str(CLUSTER_ROOMS),
                    "--worker-id", peer_id, "--advertise", peer_base,
                    "--round-seconds", str(CLUSTER_ROUND_S)]
        peer_env = {**os.environ,
                    "CASSMANTLE_REPL_LEASE_MS": str(CLUSTER_LEASE_MS),
                    "CASSMANTLE_REPL_POLL_MS": str(CLUSTER_POLL_MS),
                    "CASSMANTLE_PROBE_INTERVAL_S": str(CLUSTER_PROBE_S)}
        asyncio.run(phase())
    except Exception as exc:
        report["error"] = f"{type(exc).__name__}: {exc}"
        checks["no_error"] = False
    finally:
        for key, value in env_before.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        if t2i is not None:
            t2i.__dict__.pop("generate", None)
        overload.reset_brownout()
        if peer is not None:
            stop_child(peer)
        for proc in nodes.values():
            proc.kill()
            proc.wait()
    report["rounds"] = [{"tier": r["tier"], "size": r["shape"][1],
                         "s": r["t1"] - r["t0"],
                         "flash": sum(r["tallies"]["flash_attention"]
                                      .values())} for r in rounds]
    checks["rounds_tallied"] = bool(rounds) and all(
        all(round_checks(cfg, r, by_shape, rows).values()) for r in rounds)
    report["steps_s"] = steps
    report["phase_s"] = time.perf_counter() - t_phase
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    print(f"[cluster] {json.dumps(report, default=str)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    del fabric, svc, t2i
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return ok


# -- [staged]: the staged image server (serving/stages.py) ---------------------

STAGED_PROMPTS = (
    "A watercolor style piece depicting: a lighthouse at dusk.",
    "A vaporwave style piece depicting: the comet market.",
    "An art deco style piece depicting: a night train between cities.",
    "A woodcut style piece depicting: an orchard in the snow.")
# the reference's load A/B (bench.py bench_sd15_staged: 12 Poisson
# arrivals at 0.6 a second, sizes 1, 1, 2 drawn from seed 0, open loop),
# cut to 6 requests of the same generator and seed, to pay for the
# quantized and SDXL builds' card work (about 20 s of the script's time)
AB_REQUESTS, AB_RATE = 6, 0.6
# a mixed run's hold: the next request is admitted this many steps after
# the boundary it waits for
STAGED_GAP_STEPS = 5
STAGED_STEP_REPS = 10          # replays a width's step time averages
STAGED_IDLE_MAX = 0.10         # device idle share at occupancy 4
STAGED_MEAN_SLACK, STAGED_MAX_SLACK = 0.5, 2   # levels over the yardstick
# {kernel: Counter of launches per shape} of the staged runs, by run
STAGED_TALLIES = {}
# the served presets' [profile] readings, by preset
PROFILES = {}


def poisson_mixed_schedule(n: int, rate_rps: float, seed: int = 0):
    """The reference's ``bench.py::_poisson_mixed_schedule``: Poisson
    arrival offsets and request sizes (2:1 one image and two), from a
    seed, so both arms replay one schedule."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = rng.choice([1, 1, 2], size=n)
    return arrivals, sizes


def with_staging(cfg):
    import dataclasses

    return cfg.replace(serving=dataclasses.replace(cfg.serving,
                                                   staged_serving=True))


def monolithic(pipe, prompts, seed=0, latents=None):
    """``pipe.generate`` under CASSMANTLE_NO_STAGED_SERVING=1."""
    key = "CASSMANTLE_NO_STAGED_SERVING"
    os.environ[key] = "1"
    try:
        return pipe.generate(list(prompts), seed=seed, latents=latents)
    finally:
        os.environ.pop(key, None)


def image_diff(a, b) -> dict:
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean": float(d.mean()), "max": int(d.max())}


def within_yardstick(diff: dict, yard: dict) -> bool:
    return (diff["mean"] <= yard["mean"] + STAGED_MEAN_SLACK
            and diff["max"] <= yard["max"] + STAGED_MAX_SLACK)


def batch_yardstick(pipe, prompt: str, other: str, seed: int) -> dict:
    """The monolithic path's own batch variance: ``prompt``'s x_T row
    (its seed's one-row draw) as row 0 of a two-prompt batch beside
    ``other``, against its solo image."""
    import torch

    from cassmantle_tpu_torch.ops.ddim import initial_latents

    s = pipe.cfg.sampler
    rows = [initial_latents(torch.Generator(pipe.device).manual_seed(k), 1,
                            s.image_size, pipe.vae_scale, device=pipe.device)
            for k in (seed, seed + 1000)]
    pair = monolithic(pipe, [prompt, other], latents=torch.cat(rows))
    return image_diff(pair[:1], monolithic(pipe, [prompt], seed))


def solo_parity(pipe, prompts, seed) -> dict:
    """The staged image against the monolithic one, same seed."""
    import numpy as np

    want = monolithic(pipe, prompts, seed)
    got = pipe.generate(list(prompts), seed=seed)
    return {"prompts": len(prompts), "bit_equal": bool(np.array_equal(
        got, want)), **image_diff(got, want)}


def hold_until_queued(srv, ready):
    """A denoise-thread hook: at the first boundary where ``ready(srv)``,
    hold until the next request has reached the admission queue (it is
    then admitted at this boundary)."""
    state = {"held": 0}

    def hook(s):
        if state["held"] < len(ready) and ready[state["held"]](s):
            deadline = time.monotonic() + 60.0
            while (s._admit_q.empty() and not s._pend
                   and time.monotonic() < deadline
                   and not s._stop_evt.is_set()):
                time.sleep(0.001)
            state["held"] += 1

    return hook


def mixed_run(pipe, requests, gap=STAGED_GAP_STEPS):
    """Requests ``[(prompts, seed), ...]`` through the staged server, each
    after the first admitted ``gap`` steps into a boundary: the second
    while the first is in flight, each later one ``gap`` steps after the
    previous request's first retirement. Returns the images in order."""
    from concurrent.futures import ThreadPoolExecutor

    srv = pipe._staged_server()
    base = dict(srv.stats)

    def after_admission(s):
        return (s.stats["admissions"] > base["admissions"]
                and s.stats["steps"] - base["steps"] >= gap)

    marks = {}

    def after_retirement(k):
        def ready(s):
            done = s.stats["retirements"] - base["retirements"]
            if done < k:
                return False
            marks.setdefault(k, s.stats["steps"])
            return s.stats["steps"] - marks[k] >= gap
        return ready

    conds = [after_admission] + [after_retirement(sum(
        len(p) for p, _ in requests[:i])) for i in range(1, len(requests))]
    srv._on_step = hold_until_queued(srv, conds[:len(requests) - 1])
    try:
        with ThreadPoolExecutor(max_workers=len(requests)) as ex:
            futs = []
            for i, (prompts, seed) in enumerate(requests):
                if i:
                    deadline = time.monotonic() + 120.0
                    while (not conds[i - 1](srv)
                           and time.monotonic() < deadline):
                        time.sleep(0.001)
                futs.append(ex.submit(pipe.generate, list(prompts), seed))
            return [f.result(timeout=300) for f in futs]
    finally:
        srv._on_step = None


def staged_tally(name: str, fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after; the tallies kept under ``name``."""
    reset_all_counters()
    out = fn()
    STAGED_TALLIES[name] = read_tallies()
    return out


def staged_profile(pipe) -> dict:
    """A window of the staged loop at occupancy 4 (one four-prompt
    request, admitted at one boundary) under ``torch.profiler``, from
    its 5th step for 15: the device's busy ms (its kernels and copies;
    one stream runs) over the window's host wall, the kernels per step,
    and the host's launch, copy and synchronize calls, by name, that
    start inside a ``record_function`` range marking the window on this
    thread (the profiler's own closing synchronize falls outside; the
    copies are the verdicts' async copies to pinned memory). The
    profiler's device timestamps are not clipped to the range: they sit
    on another clock."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.autograd import DeviceType

    srv = pipe._staged_server()
    base = dict(srv.stats)
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(pipe.generate, list(STAGED_PROMPTS), 500)
        deadline = time.monotonic() + 120.0
        while (srv.stats["steps"] - base["steps"] < 5
               and time.monotonic() < deadline):
            time.sleep(0.001)
        occupancy = srv._active_n
        with device_profile_beside_graphs() as prof:
            with torch.profiler.record_function("staged.window"):
                s0 = srv.stats["steps"]
                t0 = time.perf_counter()
                while (srv.stats["steps"] - s0 < 15
                       and time.monotonic() < deadline):
                    time.sleep(0.001)
                wall_ms = (time.perf_counter() - t0) * 1e3
                steps = srv.stats["steps"] - s0
        images = fut.result(timeout=300)
    counts = trace_counts(prof, max(steps, 1))
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    window = next(e for e in cpu if e.name == "staged.window")
    lo, hi = window.time_range.start, window.time_range.end
    inside = [e.name for e in cpu if lo <= e.time_range.start <= hi]
    syncs = collections.Counter(n for n in inside if HOST_SYNC.search(n))
    copies = collections.Counter(n for n in inside if HOST_COPY.search(n))
    busy = counts["device_busy_ms"] * max(steps, 1)
    return {"occupancy": occupancy, "steps_in_window": steps,
            "window_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "kernels_per_step": counts["kernels_per_step"],
            "host_launches_per_step": counts["host_launches_per_step"],
            "host_launch_calls": counts["host_launch_calls"],
            "host_copy_calls": dict(copies),
            "host_sync_calls": dict(syncs),
            "flash_launches_per_step": counts.get(
                "flash_attention_launches_per_step"),
            "images_valid": int(images.max()) > int(images.min())}


def load_ab(pipe) -> dict:
    """The reference's staged-vs-monolithic A/B on one pipeline: the same
    Poisson schedule through each arm, open loop (a late completion
    delays no arrival), the monolithic arm under the kill switch, every
    graph both arms replay already captured by the phase. Images/s,
    request p50/p99; for the staged arm the mean slot occupancy. Every
    request must return valid images."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    arrivals, sizes = poisson_mixed_schedule(AB_REQUESTS, AB_RATE, seed=0)
    srv = pipe._staged_server()

    def arm(staged_arm: bool) -> dict:
        key = "CASSMANTLE_NO_STAGED_SERVING"
        if not staged_arm:
            os.environ[key] = "1"
        try:
            base = dict(srv.stats)
            lats = [0.0] * AB_REQUESTS
            outs = [None] * AB_REQUESTS
            start = time.perf_counter()

            def one(i):
                delay = start + float(arrivals[i]) - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                prompts = list((STAGED_PROMPTS * 2)[i % 4:][: int(sizes[i])])
                t0 = time.perf_counter()
                outs[i] = pipe.generate(prompts, seed=100 + i)
                lats[i] = time.perf_counter() - t0

            def run():
                with ThreadPoolExecutor(max_workers=AB_REQUESTS) as ex:
                    for f in [ex.submit(one, i)
                              for i in range(AB_REQUESTS)]:
                        f.result(timeout=600)

            if staged_arm:
                staged_tally("staged", run)
            else:
                run()
            elapsed = time.perf_counter() - start
        finally:
            os.environ.pop(key, None)
        images = sum(o.shape[0] for o in outs)
        lat = np.sort(np.asarray(lats))
        res = {"images": images, "elapsed_s": elapsed,
               "images_per_s": images / elapsed,
               "p50_s": float(np.percentile(lat, 50)),
               "p99_s": float(np.percentile(lat, 99)),
               "valid": all(o.dtype == np.uint8 and int(o.max())
                            > int(o.min()) for o in outs)}
        if staged_arm:
            steps = srv.stats["steps"] - base["steps"]
            res["mean_slot_occupancy"] = (
                (srv.stats["slot_steps"] - base["slot_steps"])
                / max(1, steps * srv.capacity))
            res["steps"] = steps
        return res

    return {"schedule": {"requests": AB_REQUESTS, "rate_rps": AB_RATE,
                         "images": int(sizes.sum())},
            "monolithic": arm(False), "staged": arm(True)}


def sampler_parity(name: str, cfg) -> dict:
    """One more sampler's staged solo image against its monolithic one,
    on a pipeline of its own (dropped after)."""
    import torch

    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

    pipe = Text2ImagePipeline(cfg)
    try:
        res = solo_parity(pipe, STAGED_PROMPTS[:1], 7)
        res["kind"] = pipe._staged.slot_kind
        res["slot_steps"] = pipe._staged.num_steps
    finally:
        pipe.drop_staged()
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return res


def check_staged(card: str) -> tuple:
    """The [staged] phase: returns (ok, report)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import (
        FrameworkConfig,
        fast_serving_config,
        fusedconv_serving_config,
        lcm_serving_config,
        sdxl_config,
        staged_serving_config,
        w8a8_serving_config,
    )

    from cassmantle_tpu_torch import chaos
    from cassmantle_tpu_torch.obs.recorder import flight_recorder
    from cassmantle_tpu_torch.serving.integrity import OutputInvalid
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.serving.queue import DeadlineExceeded
    from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
    from cassmantle_tpu_torch.serving.service import InferenceService

    t_phase = time.perf_counter()
    # a hang shows where: every thread's stack each 240 s until the
    # phase ends
    faulthandler.dump_traceback_later(240, repeat=True)
    checks, report = {}, {"card": card}
    torch.cuda.reset_peak_memory_stats()
    # the service path: a round through InferenceService on the staged
    # config routes its image through the staged server
    svc = InferenceService(staged_serving_config(), table=None)
    pipe = svc.backend.t2i
    rc = asyncio.run(svc.generate_content("The Night the Trains Sang"))
    srv = pipe._staged
    size = pipe.cfg.sampler.image_size
    checks["service_round_staged"] = (
        srv is not None and srv.stats["retirements"] == 1
        and rc.image.shape == (size, size, 3))
    checks["stage_health"] = {"encode", "denoise", "decode"} <= set(
        svc.supervisor.status().get("stages", {}))

    # 1. solo parity: one prompt and two
    solo = [solo_parity(pipe, STAGED_PROMPTS[:1], 7),
            solo_parity(pipe, STAGED_PROMPTS[:2], 8)]
    report["solo_ddim"] = solo
    checks["solo_ddim_bit_equal"] = all(r["bit_equal"] for r in solo)

    # 2. mid-flight admission: A; B (two prompts) 5 steps in; C 5 steps
    # after A retires: widths 4 (A + B), 2 (B), 4 (B + C), 1 (C)
    requests = [(STAGED_PROMPTS[:1], 21), (STAGED_PROMPTS[1:3], 22),
                (STAGED_PROMPTS[3:4], 23)]
    widths0 = dict(srv.width_steps)
    t0 = time.perf_counter()
    outs = staged_tally("staged-mixed", lambda: mixed_run(pipe, requests))
    mixed_s = time.perf_counter() - t0
    widths = {w: srv.width_steps[w] - widths0.get(w, 0)
              for w in srv.width_steps}
    solos = [monolithic(pipe, p, seed) for p, seed in requests]
    yardstick = batch_yardstick(pipe, STAGED_PROMPTS[0], STAGED_PROMPTS[1],
                                21)
    diffs = [image_diff(o, s) for o, s in zip(outs, solos)]
    report["mixed"] = {"s": mixed_s, "widths_run": widths,
                       "diffs": diffs, "bit_equal": [
                           bool(np.array_equal(o, s))
                           for o, s in zip(outs, solos)],
                       "yardstick": yardstick}
    checks["mixed_widths_1_2_4"] = all(widths.get(w, 0) > 0
                                       for w in (1, 2, 4))
    checks["mixed_within_yardstick"] = all(within_yardstick(d, yardstick)
                                           for d in diffs)
    builds = dict(srv.builds)
    checks["one_graph_per_width"] = (set(builds) == {1, 2, 4}
                                     and set(builds.values()) == {1})

    # graph against eager, and widths 1 and 2 on identical rows
    g_vs_e = {}
    mid = srv.num_steps // 5
    for w in (1, 2, 4):
        slots = list(range(w))
        graph_out, _ = srv.probe_step(slots, step=mid, graphed=True)
        eager_out, _ = srv.probe_step(slots, step=mid, graphed=False)
        g_vs_e[w] = {"bit_equal": bool(torch.equal(graph_out, eager_out)),
                     "values_differing": int((graph_out != eager_out)
                                             .sum().item())}
    one, _ = srv.probe_step([0], step=mid)
    two, _ = srv.probe_step([0, 1], step=mid, same_rows=True)
    report["graph_vs_eager"] = g_vs_e
    report["width1_vs_width2_identical_rows"] = {
        "bit_equal": bool(torch.equal(one, two[:1])),
        "max_abs": float((one - two[:1]).abs().max().item()),
        "rows_of_width2_equal": bool(torch.equal(two[:1], two[1:]))}
    checks["graph_equals_eager"] = all(v["bit_equal"]
                                       for v in g_vs_e.values())

    # 3. deadline: D (deadline 0.4 s) beside E; D raises at a boundary
    pre = srv.stats["preemptions"]
    t_d = time.monotonic()
    with ThreadPoolExecutor(max_workers=2) as ex:
        fe = ex.submit(pipe.generate, list(STAGED_PROMPTS[:1]), 31)
        fd = ex.submit(lambda: pipe.generate(list(STAGED_PROMPTS[1:2]), 32,
                                             deadline_s=0.4))
        out_e = fe.result(timeout=300)
        try:
            fd.result(timeout=300)
            deadline_raised = False
        except DeadlineExceeded:
            deadline_raised = True
        d_s = time.monotonic() - t_d
    preempt = [e for e in flight_recorder.tail(50)
               if e["kind"] == "stage.preempt"]
    e_diff = image_diff(out_e, monolithic(pipe, STAGED_PROMPTS[:1], 31))
    report["deadline"] = {"raised": deadline_raised, "s": d_s,
                          "preempt_event": preempt[-1] if preempt else None,
                          "neighbour_diff": e_diff}
    checks["deadline_preempts"] = (deadline_raised
                                   and srv.stats["preemptions"] == pre + 1
                                   and bool(preempt)
                                   and 0 < preempt[-1]["steps_done"]
                                   < srv.num_steps)
    checks["deadline_neighbour_within_yardstick"] = within_yardstick(
        e_diff, yardstick)
    checks["slots_free_after"] = int(srv._alive.sum()) == 0

    # 4. poisoned slot: device.poison at the admission seam
    q0 = srv.stats["quarantines"]
    chaos.configure("device.poison=raise:peer=stage,times=1")
    try:
        pipe.generate(list(STAGED_PROMPTS[:1]), seed=41)
        poisoned_failed = False
    except OutputInvalid:
        poisoned_failed = True
    finally:
        chaos.disarm()
    quar = [e for e in flight_recorder.tail(50)
            if e["kind"] == "stage.quarantine"]
    slot = quar[-1]["slot"] if quar else 0
    scrubbed = srv.run_on_denoise_thread(
        lambda: float(srv._lat[slot].abs().max().item()))
    clean = solo_parity(pipe, STAGED_PROMPTS[:1], 41)
    report["poison"] = {"failed_output_invalid": poisoned_failed,
                        "quarantine_event": quar[-1] if quar else None,
                        "slot_abs_max_after": scrubbed, "next": clean}
    checks["poisoned_slot_quarantined"] = (
        poisoned_failed and srv.stats["quarantines"] == q0 + 1
        and scrubbed == 0.0 and clean["bit_equal"])

    # 5. no host sync in the loop: a window at occupancy 4
    prof = staged_tally("staged-profile", lambda: staged_profile(pipe))
    prof["monolithic_graphed_idle_share"] = PROFILES.get(
        "default", {}).get("idle_share")
    report["profile"] = prof
    checks["occupancy_4"] = prof["occupancy"] == 4 and prof["images_valid"]
    checks["idle_share_at_most_0.10"] = prof["idle_share"] <= STAGED_IDLE_MAX
    checks["no_sync_in_loop"] = not prof["host_sync_calls"]

    # each width's step time, capture seconds and pool
    report["widths"] = {}
    for w in (1, 2, 4):
        _, ms = srv.probe_step(list(range(w)), step=0,
                               reps=min(STAGED_STEP_REPS, srv.num_steps))
        st = srv.graphs[w].stats()
        report["widths"][w] = {"step_ms": ms, "capture_s": st["capture_s"],
                               "warmup_s": st["warmup_s"],
                               "instantiate_s": st["instantiate_s"],
                               "pool_mb": st["pool_bytes"] / 2 ** 20}

    # 6. the load A/B; the staged arm is a second mixed run: no capture.
    # [obs-device]: each retirement attributes one request's count (made
    # on its daemon thread long before), the monolithic arm its images'
    from cassmantle_tpu_torch.obs import costmodel

    per_request = costmodel.cached("staged_denoise",
                                   pipe.cost_signature())[1]
    flops0 = {k: device_flops(k) for k in ("staged_denoise", "t2i")}
    retired0 = srv.stats["retirements"]
    report["load_ab"] = load_ab(pipe)
    checks["ab_all_valid"] = (report["load_ab"]["staged"]["valid"]
                              and report["load_ab"]["monolithic"]["valid"])
    staged_obs = obs_device_reading(
        "staged", "staged_denoise", per_request,
        device_flops("staged_denoise") - flops0["staged_denoise"],
        srv.stats["retirements"] - retired0, mxu_gauge("staged_denoise"))
    mono_obs = obs_device_reading(
        "default", "t2i", costmodel.cached("t2i", pipe.cost_signature())[1],
        device_flops("t2i") - flops0["t2i"],
        report["load_ab"]["monolithic"]["images"], mxu_gauge("t2i"))
    OBS_DEVICE["staged"] = {"staged_denoise": staged_obs,
                            "monolithic_arm": mono_obs}
    report["obs_device"] = {k: {f: v[f] for f in (
        "items", "device_flops", "expected", "mxu_utilization")}
        for k, v in OBS_DEVICE["staged"].items()}
    checks["staged_flops_retirements_x_count"] = (
        staged_obs["equal"] and staged_obs["items"] > 0
        and staged_obs["mxu_in_range"])
    checks["monolithic_arm_flops_count_x_images"] = (
        mono_obs["equal"] and mono_obs["mxu_in_range"])
    checks["no_new_capture_second_run"] = dict(srv.builds) == builds
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report["stats"] = dict(srv.stats)
    asyncio.run(svc.stop())
    del svc, pipe, srv
    gc.collect()
    torch.cuda.empty_cache()

    # the other samplers' solo parity
    others = {
        "dpmpp_2m": with_staging(fast_serving_config()),
        "euler": with_staging(FrameworkConfig().replace(
            sampler=dataclasses.replace(FrameworkConfig().sampler,
                                        kind="euler"))),
        "consistency": with_staging(lcm_serving_config())}
    report["samplers"] = {name: sampler_parity(name, cfg)
                          for name, cfg in others.items()}
    checks["solo_samplers_bit_equal"] = all(
        r["bit_equal"] for r in report["samplers"].values())

    # SDXL-base at 1024x1024
    t0 = time.perf_counter()
    xl = SDXLPipeline(with_staging(sdxl_config()))
    report["sdxl"] = staged_tally("staged-sdxl", lambda: solo_parity(
        xl, STAGED_PROMPTS[:1], 7))
    report["sdxl"]["s"] = time.perf_counter() - t0
    checks["solo_sdxl_bit_equal"] = report["sdxl"]["bit_equal"]
    xl.drop_staged()
    del xl
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the composed presets at 512x512: solo parity and one two-request
    # mixed run (W8A8: the neighbour coupling reported, not held)
    for name, cfg in (("fusedconv", fusedconv_serving_config()),
                      ("w8a8", w8a8_serving_config())):
        cp = Text2ImagePipeline(with_staging(cfg))
        try:
            res = {"solo": solo_parity(cp, STAGED_PROMPTS[:1], 7)}
            reqs = [(STAGED_PROMPTS[:1], 51), (STAGED_PROMPTS[1:2], 52)]
            outs = staged_tally(f"staged-{name}",
                                lambda: mixed_run(cp, reqs))
            solos = [monolithic(cp, p, seed) for p, seed in reqs]
            res["mixed_diffs"] = [image_diff(o, s)
                                  for o, s in zip(outs, solos)]
            res["mixed_valid"] = all(int(o.max()) > int(o.min())
                                     for o in outs)
            res["widths_run"] = dict(cp._staged.width_steps)
            if name == "fusedconv":
                y = batch_yardstick(cp, STAGED_PROMPTS[0],
                                    STAGED_PROMPTS[1], 51)
                res["yardstick"] = y
                checks["fusedconv_mixed_within_yardstick"] = all(
                    within_yardstick(d, y) for d in res["mixed_diffs"])
            checks[f"{name}_solo_bit_equal"] = res["solo"]["bit_equal"]
            checks[f"{name}_mixed_valid"] = (
                res["mixed_valid"] and res["widths_run"].get(2, 0) > 0)
            report[name] = res
        finally:
            cp.drop_staged()
            del cp
            gc.collect()
            torch.cuda.empty_cache()

    faulthandler.cancel_dump_traceback_later()
    report["phase_s"] = time.perf_counter() - t_phase
    report["checks"] = {k: bool(v) for k, v in checks.items()}
    ok = all(report["checks"].values())
    print(f"[staged] {json.dumps(report)} -> {'pass' if ok else 'FAIL'}",
          flush=True)
    return ok, report


def staged_shape_gaps(rows: dict, checked: dict) -> list:
    """Every staged run's launches at a shape phase 2 does not check, flash
    on another path than its check took, or flash outside its model's
    staged shapes (``ROUND_FLASH["staged"]``; SDXL's solo run, its
    round's): (run, kernel, shapes)."""
    by_shape = {(b, sq, sk, h, d): name
                for name, (b, sq, sk, h, d, _) in FLASH_SHAPES.items()}
    gaps = []
    for run, tally in STAGED_TALLIES.items():
        model = "sdxl" if run == "staged-sdxl" else "staged"
        for (shape, path), _ in tally["flash_paths"].items():
            name = by_shape.get(shape)
            if (name is None or rows[name]["path"] != path
                    or name not in ROUND_FLASH[model]):
                gaps.append((run, "flash_attention", shape, path))
        for kernel, kernel_rows in checked.items():
            missing = set(tally[kernel]) - set(kernel_rows)
            if missing:
                gaps.append((run, kernel, sorted(missing)))
    return gaps


def kernel_entries(kernel, rows, tally, source, replaces, staged):
    """The kernels-line entries of one kernel: every checked shape, with
    its launches in its path's rounds and the staged runs, and the
    staged runs' apart."""
    return [{"name": f"{kernel}[{'x'.join(map(str, shape))}]",
             "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": tally.get(shape, 0),
             "staged_launches": staged.get(shape, 0),
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "ok": r["ok"]} for shape, r in rows.items()]


def report_obs_device(card: str) -> None:
    """The [obs-device] line: each served preset's FLOPs an image by class
    beside the reference's committed entry, the attributed FLOPs against
    count x images, each pipeline's mxu gauge; the staged figure; the
    prompt and scorer attribution."""
    from cassmantle_tpu_torch.obs import costmodel

    print(f"[obs-device] ({card}; peaks bf16 "
          f"{costmodel.chip_peak_flops('bf16') / 1e12:.0f} / int8 "
          f"{costmodel.chip_peak_flops('int8') / 1e12:.0f} / fp32 "
          f"{costmodel.chip_peak_flops('fp32') / 1e12:.0f} T/s) "
          f"{json.dumps(OBS_DEVICE)}", flush=True)


# -- this slice: training on one card and the CLIP quality gate -------------

# [train-diffusion] and [distill]: SD1.5 at 512x512, batch 2 (the CLI's
# default batch 8 takes about 50 GB); the distillation's steps
TRAIN_BATCH = 2
TRAIN_STEPS = 10
DISTILL_STEPS = 3
# [train-lm]: GPT-2 small through the CLI, and Mistral-7B at its
# published widths cut to 2 of its 32 layers
LM_STEPS, LM_BATCH, LM_SEQ = 4, 8, 256
MISTRAL_LAYERS, MISTRAL_BATCH, MISTRAL_SEQ = 2, 4, 256
TRAIN_SMOKE_DIR = os.path.join(REPO, "cassmantle_tpu_torch", "_build",
                               "train_smoke")
# two harnesses with equal fp32 weights: embeddings and similarities
CLIP_SAME_WEIGHTS_TOL = 1e-5
# the fp32-compute gradient against the served bf16 one
TRAIN_GRAD_MIN_COSINE = 0.99
# the fixed-batch and distillation steps' learning rate: at 1e-4 (the
# CLI's default) Adam's first step from the seeded init overshoots, and
# the loss of a fixed batch rises before it falls
TRAIN_LR = 1e-5


def train_batch(cfg, gen):
    """Seeded clean latents and text states on the card, at the config's
    image size."""
    import torch

    hw = cfg.sampler.image_size // 8
    return {"latents": torch.randn((TRAIN_BATCH, hw, hw, 4), generator=gen,
                                   device="cuda"),
            "context": torch.randn((TRAIN_BATCH, 77,
                                    cfg.models.unet.context_dim),
                                   generator=gen, device="cuda")}


def attention_projection(name: str) -> bool:
    return ".self_attn." in name or ".cross_attn." in name


def grad_agreement(a, b) -> dict:
    """Cosine of two UNets' gradients over every parameter (fp64 sums),
    the least cosine of one attention projection, and the attention
    projections whose gradient is zero in either."""
    import torch

    dot = na = nb = 0.0
    min_attn, zero = 1.0, []
    grads_b = dict(b.named_parameters())
    for name, p in a.named_parameters():
        ga, gb = p.grad.double(), grads_b[name].grad.double()
        d, x, y = (ga * gb).sum().item(), ga.square().sum().item(), \
            gb.square().sum().item()
        dot, na, nb = dot + d, na + x, nb + y
        if attention_projection(name):
            if x == 0.0 or y == 0.0:
                zero.append(name)
            else:
                min_attn = min(min_attn, d / math.sqrt(x * y))
        del ga, gb
    torch.cuda.empty_cache()
    return {"cosine": dot / math.sqrt(na * nb),
            "min_attention_cosine": min_attn, "zero_attention": zero}


def check_train_diffusion(card: str) -> bool:
    """[train-diffusion]: ``DiffusionTrainer`` on SD1.5 at 512x512, batch
    2, bf16 compute over fp32 parameters. Outside ``plain_only`` a
    differentiated forward reaches the flash kernel, which refuses; the
    trainer's forward launches no flash kernel; its gradient at one fixed
    draw against the fp32-compute gradient of the same parameters and
    draw (cosine >= 0.99, every attention projection's gradient nonzero);
    ten steps at a fixed batch and draw lower the loss; step ms (and its
    forward-backward and optimizer halves), one profiled step's device
    busy ms, kernels and host launches, peak GiB."""
    import dataclasses

    import torch

    from cassmantle_tpu_torch.config import FrameworkConfig
    from cassmantle_tpu_torch.ops.flash_attention import flash_attention
    from cassmantle_tpu_torch.parallel.train import DiffusionTrainer

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    tr = DiffusionTrainer(cfg, lr=TRAIN_LR, device="cuda")
    tr.init_state(seed=0)
    gen = torch.Generator("cuda").manual_seed(17)
    batch = train_batch(cfg, gen)
    t, noise = tr.draws(batch, gen)
    reset_all_counters()
    try:
        tr.unet(batch["latents"], t, batch["context"])
        refused = False
    except RuntimeError as exc:
        refused = "no backward" in str(exc)
    refused_launches = flash_attention.launches
    reset_all_counters()
    tr.loss_and_grads(batch, t, noise)
    cfg32 = cfg.replace(models=dataclasses.replace(
        cfg.models, unet=dataclasses.replace(cfg.models.unet,
                                             dtype="float32")))
    tr32 = DiffusionTrainer(cfg32, device="cuda")
    tr32.init_state(state_dict=tr.unet.state_dict())
    tr32.loss_and_grads(batch, t, noise)
    agree = grad_agreement(tr.unet, tr32.unet)
    del tr32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [tr.step_at(batch, t, noise) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / TRAIN_STEPS * 1e3
    losses = [float(x) for x in losses]
    # one more step in its two halves: forward and backward, optimizer
    t2 = time.perf_counter()
    tr.loss_and_grads(batch, t, noise)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    tr.optimizer.step()
    torch.cuda.synchronize()
    halves_ms = [(t3 - t2) * 1e3, (time.perf_counter() - t3) * 1e3]
    # one step under the profiler: the device's busy share of the wall
    # (the profiler's own cost is in the wall: the unprofiled step_ms is
    # the one to hold the busy ms against)
    with device_profile_beside_graphs() as prof:
        t4 = time.perf_counter()
        tr.step_at(batch, t, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t4) * 1e3
    counts = trace_counts(prof, 1)
    profile = {"wall_ms": wall_ms, "device_busy_ms": counts["device_busy_ms"],
               "idle_share": 1.0 - counts["device_busy_ms"] / wall_ms,
               "kernels_per_step": counts["kernels_per_step"],
               "host_launches_per_step": counts["host_launches_per_step"]}
    del prof
    res = dict(
        batch=TRAIN_BATCH, image_size=cfg.sampler.image_size, lr=TRAIN_LR,
        flash_refused_in_differentiated_forward=refused,
        flash_launches_before_refusal=refused_launches,
        trainer_flash_launches=flash_attention.launches,
        grad_cosine_vs_fp32=agree["cosine"],
        min_attention_projection_cosine=agree["min_attention_cosine"],
        zero_attention_grads=agree["zero_attention"],
        losses=losses, step_ms=step_ms,
        forward_backward_ms=halves_ms[0], optimizer_ms=halves_ms[1],
        profile=profile,
        images_per_s=TRAIN_BATCH / step_ms * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        phase_s=time.perf_counter() - t0)
    ok = (refused and refused_launches == 0
          and flash_attention.launches == 0
          and agree["cosine"] >= TRAIN_GRAD_MIN_COSINE
          and not agree["zero_attention"]
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0])
    print(f"[train-diffusion] SD1.5 UNet, bf16 compute over fp32 "
          f"parameters ({card}): {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def check_distill(card: str) -> bool:
    """[distill]: ``ConsistencyDistillTrainer`` on SD1.5 (the 50-step
    teacher grid, skip 1), a few steps: the teacher's and the EMA target's
    forwards launch flash (each step two full forwards at batch 2, shape
    for shape), the student's none. The student's ``state_dict`` then
    serves a 4-step lcm round through ``Text2ImagePipeline``: its UNet
    holds the student's weights in bf16, 4 consistency forwards, flash
    129, a uint8 image."""
    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import FrameworkConfig, \
        lcm_serving_config
    from cassmantle_tpu_torch.ops.flash_attention import flash_attention
    from cassmantle_tpu_torch.parallel.train import (
        ConsistencyDistillTrainer,
        step_generator,
    )
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.utils.logging import metrics

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr = ConsistencyDistillTrainer(cfg, lr=TRAIN_LR, device="cuda")
    tr.init_state(seed=0)
    batch = train_batch(cfg, torch.Generator("cuda").manual_seed(18))
    per_forward = unet_flash_forward("sd15", cfg.sampler.image_size, "full",
                                     TRAIN_BATCH)
    reset_all_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [tr.step(batch, step_generator(0, i, "cuda"))
              for i in range(DISTILL_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / DISTILL_STEPS * 1e3
    losses = [float(x) for x in losses]
    train_flash = dict(flash_attention.shapes)
    want = scaled(per_forward, 2 * DISTILL_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = any(not torch.equal(e, s) for e, s in zip(
        tr.ema.parameters(), tr.teacher.parameters()))
    student = tr.student.state_dict()
    pipe = Text2ImagePipeline(lcm_serving_config(),
                              state_dicts={"unet": student})
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # the served UNet holds the student's weights in its storage dtype
    served = all(torch.equal(v, student[k].to(v.dtype))
                 for k, v in pipe.unet.state_dict().items())
    del student
    reset_all_counters()
    before = metrics.counter_total("pipeline.consistency_steps")
    image = pipe.generate(["A linocut style piece depicting: a fox asleep "
                           "in a bell tower"], seed=0)
    forwards = metrics.counter_total("pipeline.consistency_steps") - before
    tally = read_tallies()
    lcm_flash = flash_attention.launches
    res = dict(steps=DISTILL_STEPS, lr=TRAIN_LR, losses=losses,
               step_ms=step_ms,
               peak_gib=peak, train_flash_launches=sum(train_flash.values()),
               train_flash_as_two_forwards_a_step=train_flash == want,
               ema_moved=moved, student_served=served,
               lcm_forwards=forwards, lcm_flash_launches=lcm_flash,
               image_shape=list(image.shape), image_dtype=str(image.dtype),
               phase_s=time.perf_counter() - t0)
    ok = (all(math.isfinite(x) for x in losses) and train_flash == want
          and moved and served and forwards == 4 and lcm_flash == 129
          and image.dtype == np.uint8 and image.shape == (1, 512, 512, 3)
          and int(image.max()) > int(image.min()))
    print(f"[distill] SD1.5 consistency distillation and its student's lcm "
          f"round ({card}): {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    SLICE_TALLIES["distill"] = tally
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def cli_losses(out: str, name: str) -> dict:
    """{step: loss} from the training CLI's ``[name] step N loss x``."""
    return {int(line.split()[2]): float(line.split()[4])
            for line in out.splitlines()
            if line.startswith(f"[{name}] step ")}


def check_train_lm(card: str) -> bool:
    """[train-lm]: the ``train-lm`` command (GPT-2 small, seq 256, batch 8)
    with a checkpoint directory: four steps saving at 2 and 4, run through
    the CLI's ``main`` in this process; the step-4 save removed, ``python
    -m cassmantle_tpu_torch train-lm`` with the same flags resumes at step
    2, and its steps 2 and 3 give the uninterrupted run's losses. Then
    Mistral-7B at its published widths, 2 of 32 layers, through
    ``LMTrainer``: a warm step and a timed one. Tokens/s of each."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import torch

    from cassmantle_tpu_torch import __main__ as cli
    from cassmantle_tpu_torch.config import MistralConfig
    from cassmantle_tpu_torch.models.mistral import MistralLM
    from cassmantle_tpu_torch.parallel.lm_train import LMTrainer

    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_SMOKE_DIR, ignore_errors=True)
    args = ["train-lm", "--steps", str(LM_STEPS), "--batch", str(LM_BATCH),
            "--seq-len", str(LM_SEQ), "--log-every", "1",
            "--checkpoint-every", "2", "--checkpoint-dir", TRAIN_SMOKE_DIR]
    first = io.StringIO()
    with contextlib.redirect_stdout(first):
        rc = cli.main(list(args))
    first = first.getvalue()
    shutil.rmtree(os.path.join(TRAIN_SMOKE_DIR, f"step_{LM_STEPS}"))
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "cassmantle_tpu_torch",
                           *args], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    if rc != 0 or proc.returncode != 0:
        print(f"[train-lm] the command exited {rc} / {proc.returncode}:\n"
              f"{first[-2000:]}\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-4000:]}", flush=True)
        return False
    whole, resumed = cli_losses(first, "lm"), cli_losses(proc.stdout, "lm")
    rate = re.search(r"([0-9.]+) tokens/s", first)
    cli_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_SMOKE_DIR, ignore_errors=True)

    mcfg = dataclasses.replace(MistralConfig(), num_layers=MISTRAL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    with torch.device("cuda"):
        model = MistralLM(mcfg)
    tr = LMTrainer(model, device="cuda")
    tr.init_state(seed=0)
    gen = torch.Generator("cuda").manual_seed(19)
    ids = torch.randint(0, mcfg.vocab_size, (MISTRAL_BATCH, MISTRAL_SEQ),
                        generator=gen, device="cuda")
    batch = {"input_ids": ids, "loss_mask": torch.ones_like(ids)}
    warm = float(tr.step(batch))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timed = float(tr.step(batch))
    torch.cuda.synchronize()
    mistral_ms = (time.perf_counter() - t1) * 1e3
    params = sum(p.numel() for p in model.parameters())
    res = dict(
        gpt2_losses=whole, gpt2_resumed_losses=resumed,
        gpt2_resume_bit_equal=all(resumed.get(s) == whole.get(s)
                                  for s in (2, 3)),
        gpt2_tokens_per_s=float(rate.group(1)) if rate else None,
        gpt2_cli_s=cli_s, mistral_layers=f"{MISTRAL_LAYERS} of 32",
        mistral_params=params, mistral_losses=[warm, timed],
        mistral_step_ms=mistral_ms,
        mistral_tokens_per_s=MISTRAL_BATCH * MISTRAL_SEQ / mistral_ms * 1e3,
        mistral_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        phase_s=time.perf_counter() - t0)
    resumed_ok = (sorted(whole) == list(range(LM_STEPS))
                  and sorted(resumed) == [2, 3]
                  and "resumed from step 2" in proc.stdout
                  and all(abs(resumed[s] - whole[s]) <= 1e-6 * abs(whole[s])
                          for s in (2, 3)))
    ok = (resumed_ok and rate is not None
          and all(math.isfinite(x) for x in whole.values())
          and math.isfinite(warm) and math.isfinite(timed))
    print(f"[train-lm] GPT-2 small through the CLI, resumed; Mistral-7B "
          f"widths ({card}): {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    del tr, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def hf_clip_file(harness) -> dict:
    """The harness's three stages under transformers' CLIPModel names
    (the inverse of ``convert_clip_text`` / ``convert_clip_vision`` /
    ``convert_clip_text_projection``), fp16, on the host."""
    import torch

    out = {}

    def put(name, t):
        out[name] = t.detach().to("cpu", torch.float16)

    def tower(sd, prefix, layers, d):
        for i in range(layers):
            src, dst = f"{prefix}encoder.layers.{i}", f"block_{i}"
            for a, b in (("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
                         ("self_attn.out_proj", "attn.out"),
                         ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                put(f"{src}.{a}.weight", sd[f"{dst}.{b}.weight"])
                put(f"{src}.{a}.bias", sd[f"{dst}.{b}.bias"])
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                put(f"{src}.self_attn.{proj}.weight",
                    sd[f"{dst}.attn.qkv.weight"][j * d:(j + 1) * d])
                put(f"{src}.self_attn.{proj}.bias",
                    sd[f"{dst}.attn.qkv.bias"][j * d:(j + 1) * d])

    text = harness.text.state_dict()
    tcfg = harness.text_cfg
    put("text_model.embeddings.token_embedding.weight",
        text["token_embedding.weight"])
    put("text_model.embeddings.position_embedding.weight",
        text["position_embedding"])
    put("text_model.final_layer_norm.weight", text["ln_final.weight"])
    put("text_model.final_layer_norm.bias", text["ln_final.bias"])
    tower(text, "text_model.", tcfg.num_layers, tcfg.hidden_size)
    vis = harness.vision.state_dict()
    vcfg = harness.vision_cfg
    put("vision_model.embeddings.class_embedding", vis["class_embedding"])
    put("vision_model.embeddings.position_embedding.weight",
        vis["position_embedding"])
    put("vision_model.embeddings.patch_embedding.weight",
        vis["patch_embed.weight"])
    for a, b in (("pre_layrnorm", "pre_ln"), ("post_layernorm", "post_ln")):
        put(f"vision_model.{a}.weight", vis[f"{b}.weight"])
        put(f"vision_model.{a}.bias", vis[f"{b}.bias"])
    tower(vis, "vision_model.", vcfg.num_layers, vcfg.hidden_size)
    put("visual_projection.weight", vis["projection"].t())
    put("text_projection.weight", harness.text_projection.t())
    return out


def spot_check(tally: dict, checked: dict, timed: dict) -> list:
    """Each kernel against its plain version, once, at every shape of
    ``tally`` that phase 2 does not check ([kernel-spot] lines, with the
    same inputs and limits), and its device ms (``time_ms``, 2 replays),
    bound and library yardstick as phase 2 takes them, kept in
    ``timed[(kernel, shape)]`` (a shape already there is not run again);
    returns the shapes that disagree."""
    from functools import partial

    import torch
    import torch.nn.functional as F

    from cassmantle_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from cassmantle_tpu_torch.ops.fused_conv import (
        gn_silu_conv3x3,
        gn_silu_conv3x3_plain,
    )
    from cassmantle_tpu_torch.ops.quant_matmul import (
        int8_conv3x3,
        int8_conv3x3_plain,
        int8_matmul,
        int8_matmul_plain,
    )

    gen = torch.Generator("cuda").manual_seed(6)
    kw = dict(generator=gen, device="cuda")
    layouts = {(sq, sk, h, d): layout
               for b, sq, sk, h, d, layout in FLASH_SHAPES.values()}
    bad = []
    for kernel in ("flash_attention", "gn_silu_conv3x3", "int8_matmul",
                   "int8_conv3x3"):
        for shape in sorted(set(tally[kernel]) - set(checked[kernel])):
            if (kernel, shape) in timed:
                continue
            library = None
            if kernel == "flash_attention":
                b, sq, sk, h, d = shape
                args = flash_inputs(b, sq, sk, h, d, layouts.get(
                    (sq, sk, h, d), "self" if sq == sk else "cross"), gen)
                agree = scaled_agreement(flash_attention(*args),
                                         flash_attention_plain(*args))
                fn = partial(flash_attention, *args)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in args)
                library = partial(F.scaled_dot_product_attention, qt, kt, vt)
                bound_ms, bound_by = flash_bound(b, sq, sk, h, d)[:2]
            elif kernel == "gn_silu_conv3x3":
                b, h, w, c, f = shape
                x = torch.randn((b, h, w, c), dtype=torch.bfloat16, **kw)
                ohwi = (torch.randn((f, 3, 3, c), **kw)
                        / (9 * c) ** 0.5).bfloat16()
                args = (x, torch.rand((b, c), **kw) + 0.5,
                        torch.randn((b, c), **kw) * 0.5,
                        ohwi.permute(1, 2, 3, 0),
                        torch.randn((f,), **kw) * 0.1)
                agree = scaled_agreement(gn_silu_conv3x3(*args),
                                         gn_silu_conv3x3_plain(*args))
                fn = partial(gn_silu_conv3x3, *args)
                act = F.silu(x.float() * args[1][:, None, None]
                             + args[2][:, None, None]).bfloat16()
                library = partial(F.conv2d, act.permute(0, 3, 1, 2),
                                  ohwi.permute(0, 3, 1, 2),
                                  args[4].bfloat16(), padding=1)
                m = b * h * w
                bound_ms, bound_by = bound(
                    18 * m * c * f, 2 * (m * c + 9 * c * f + m * f)
                    + 4 * (2 * b * c + f), PEAK_BF16_FLOPS)
            elif kernel == "int8_matmul":
                m, k, n = shape
                per_token = shape in LM_MATMUL_SHAPES
                args = (torch.randint(-127, 128, (m, k), dtype=torch.int8,
                                      **kw),
                        torch.randint(-127, 128, (n, k), dtype=torch.int8,
                                      **kw).t(),
                        torch.rand((m if per_token else 1,), **kw) * 0.01
                        + 1e-3,
                        torch.rand((n,), **kw) * 1e-3 + 1e-4,
                        torch.randn((n,), **kw), torch.bfloat16)
                agree = exact_agreement(int8_matmul(*args),
                                        int8_matmul_plain(*args))
                fn = partial(int8_matmul, *args)
                if m > 16:
                    library = partial(torch._int_mm, args[0], args[1])
                bound_ms, bound_by = bound(
                    2 * m * k * n, m * k + k * n + 2 * m * n
                    + 4 * (args[2].numel() + 2 * n), PEAK_INT8_OPS)
            else:
                b, h, w, c, f = shape
                args = (torch.randint(-127, 128, (b, h, w, c),
                                      dtype=torch.int8, **kw),
                        torch.randint(-127, 128, (f, 3, 3, c),
                                      dtype=torch.int8, **kw)
                        .permute(1, 2, 3, 0),
                        torch.rand((f,), **kw) * 1e-5 + 1e-6,
                        torch.randn((f,), **kw), torch.bfloat16)
                agree = exact_agreement(int8_conv3x3(*args),
                                        int8_conv3x3_plain(*args))
                fn = partial(int8_conv3x3, *args)
                library = partial(torch._int_mm, int8_im2col(args[0]),
                                  args[1].permute(3, 0, 1, 2)
                                  .reshape(f, 9 * c).t())
                m = b * h * w
                bound_ms, bound_by = bound(
                    18 * m * c * f, m * c + 9 * c * f + 2 * m * f + 8 * f,
                    PEAK_INT8_OPS)
            ms = time_ms(fn, KERNEL_ITERS)
            library_ms = (None if library is None
                          else time_ms(library, KERNEL_ITERS))
            timed[(kernel, shape)] = dict(
                ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, ok=agree["ok"])
            lib = ("none" if library_ms is None
                   else f"library {library_ms:.4f} ms")
            print(f"[kernel-spot] {kernel} {shape}: {agree['text']}, kernel "
                  f"{ms:.4f} ms, {lib}, bound {bound_ms * 1e3:.2f} us "
                  f"({bound_by}) -> {'pass' if agree['ok'] else 'FAIL'}",
                  flush=True)
            if not agree["ok"]:
                bad.append((kernel, shape))
            del args, fn, library
            torch.cuda.empty_cache()
    return bad


def phase_kernel_ms(tally: dict, rows_by_shape: dict, timed: dict) -> dict:
    """Per kernel of a phase's tally: launches, and launches x device ms,
    bound ms and library ms (over the launches that have a library call),
    each shape's from phase 2's row or its [kernel-spot] timing."""
    out = {}
    for kernel, shape_rows in rows_by_shape.items():
        counts = tally[kernel]
        if not counts:
            continue
        per = {shape: shape_rows.get(shape) or timed[(kernel, shape)]
               for shape in counts}
        lib = [(n, per[shape]["library_ms"]) for shape, n in counts.items()
               if per[shape]["library_ms"] is not None]
        out[kernel] = dict(
            launches=sum(counts.values()),
            ms=sum(n * per[shape]["ms"] for shape, n in counts.items()),
            bound_ms=sum(n * per[shape]["bound_ms"]
                         for shape, n in counts.items()),
            library_ms=sum(n * t for n, t in lib),
            library_launches=sum(n for n, _ in lib))
    return out


def check_clip(card: str) -> bool:
    """[clip]: the ViT-L/14 quality gate at full size. A seeded harness
    (fp32 towers: on the card their attention takes the plain path) is
    written under the CLIPModel names as one fp16 ``clip_text.safetensors``
    (its weights rounded to fp16 first) and read back through the
    converters: every stage loaded, each tensor equal to the seeded one,
    the embeddings equal. ``clip-report`` over the six presets, one batch
    of eight prompts each, without a weights directory (real_weights
    false, gate advisory); ``w8a8_quality_report`` on eight prompts (W8A8
    against the fused-conv bf16 arm, same seeds). Images/s of the
    scoring; the launches of kernels 1-4 in the phase."""
    import shutil

    import numpy as np
    import torch

    from cassmantle_tpu_torch.config import (
        fusedconv_serving_config,
        w8a8_serving_config,
    )
    from cassmantle_tpu_torch.eval.clip_parity import (
        ClipSimilarityHarness,
        w8a8_quality_report,
    )
    from cassmantle_tpu_torch.models.weights import save_safetensors
    from cassmantle_tpu_torch.ops.flash_attention import flash_attention
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.tools import clip_report

    t0 = time.perf_counter()
    clip_dir = os.path.join(TRAIN_SMOKE_DIR, "clip")
    shutil.rmtree(clip_dir, ignore_errors=True)
    os.makedirs(clip_dir)
    seeded = ClipSimilarityHarness(device="cuda")
    with torch.no_grad():
        for module in (seeded.text, seeded.vision):
            for p in module.parameters():
                p.copy_(p.half().float())
        seeded.text_projection.copy_(seeded.text_projection.half().float())
    path = os.path.join(clip_dir, "clip_text.safetensors")
    save_safetensors(hf_clip_file(seeded), path)
    file_gb = os.path.getsize(path) / 1e9
    loaded = ClipSimilarityHarness(weights_dir=clip_dir, device="cuda")
    equal = all(
        all(torch.equal(v, b.state_dict()[k])
            for k, v in a.state_dict().items())
        for a, b in ((loaded.text, seeded.text),
                     (loaded.vision, seeded.vision))) and torch.equal(
        loaded.text_projection, seeded.text_projection)
    rng = np.random.default_rng(20)
    images = rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    prompts = clip_report.PROMPTS
    reset_all_counters()
    sims = seeded.similarity(images, prompts)
    with torch.inference_mode():
        emb_diff = float((seeded.embed_images(images)
                          - loaded.embed_images(images)).abs().max())
    # equal weights; the card's library products may pick another
    # algorithm from one call to the next (fp32, unit embeddings)
    sim_diff = float(np.abs(sims - loaded.similarity(images, prompts)).max())
    same = emb_diff <= CLIP_SAME_WEIGHTS_TOL and \
        sim_diff <= CLIP_SAME_WEIGHTS_TOL
    scoring_flash = flash_attention.launches
    del loaded
    shutil.rmtree(clip_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        seeded.similarity(images, prompts)
    images_per_s = 3 * len(images) / (time.perf_counter() - t1)
    converters_s = time.perf_counter() - t0

    reset_all_counters()
    out = os.path.join(TRAIN_SMOKE_DIR, "CLIP_REPORT.json")
    t2 = time.perf_counter()
    rc = clip_report.main(["--platform", "cuda", "--seeds", "1", "--weights",
                           os.path.join(clip_dir, "absent"), "--out", out])
    report_s = time.perf_counter() - t2
    with open(out, encoding="utf-8") as f:
        report = json.load(f)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    arms = {}
    for arm, cfg in (("w8a8", w8a8_serving_config()),
                     ("fp", fusedconv_serving_config())):
        pipe = Text2ImagePipeline(cfg)
        arms[arm] = pipe.generate(prompts, seed=0)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    w8 = w8a8_quality_report(seeded, arms["w8a8"], arms["fp"], prompts)
    w8a8_s = time.perf_counter() - t3
    tally = read_tallies()
    launches = {k: sum(v.values()) for k, v in tally.items()
                if k != "flash_paths"}
    SLICE_TALLIES["clip"] = tally
    presets = report["presets"]
    res = dict(
        file_gb=file_gb, converters_equal=equal,
        embedding_max_diff=emb_diff, similarity_max_diff=sim_diff,
        loaded_real_weights=True, scoring_flash_launches=scoring_flash,
        scoring_images_per_s=images_per_s,
        report={name: {k: e[k] for k in ("clip_sim_mean", "n",
                                          "parity_vs_ddim50") if k in e}
                for name, e in presets.items()},
        real_weights=report["real_weights"],
        gate_enforced=report["gate_enforced"],
        gate_failures=len(report["gate_failures"]),
        w8a8_report=w8, launches=launches, converters_s=converters_s,
        report_s=report_s, w8a8_s=w8a8_s,
        phase_s=time.perf_counter() - t0)
    ok = (equal and same and scoring_flash == 0 and rc == 0
          and list(presets) == clip_report.DEFAULT_PRESETS.split(",")
          and all(e["n"] == len(prompts)
                  and math.isfinite(e["clip_sim_mean"])
                  for e in presets.values())
          and report["real_weights"] is False
          and report["gate_enforced"] is False
          and w8["n"] == len(prompts) and math.isfinite(w8["image_sim_mean"])
          and w8["real_weights"] is False
          and all(launches[k] > 0 for k in launches))
    print(f"[clip] ViT-L/14 quality gate ({card}): {json.dumps(res)} -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    del seeded
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# this slice's tallies, by phase, for the spot checks and the kernels line
SLICE_TALLIES = {}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    # a fatal signal (a crash in native code) prints every thread's stack
    faulthandler.enable()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run "
             "needs an NVIDIA card")
    for switch in ("CASSMANTLE_NO_FUSED_CONV", "CASSMANTLE_NO_W8A8"):
        if os.environ.get(switch, "").lower() not in ("", "0", "false",
                                                      "no", "off"):
            fail(f"{switch} is set: the smoke run drives the kernels")
    card = card_line()
    print(f"[card] {card}", flush=True)

    def stamp(label: str) -> None:
        """Seconds since the start, after each phase (where time goes)."""
        print(f"[time] {label} {time.perf_counter() - t_start:.1f} s",
              flush=True)
    # every preset at every brownout tier, derived from its config, runs
    # only shapes phase 2 checks, and the rounds' tables agree with it
    gaps, mismatches = tier_shape_gaps(), round_table_mismatches()
    if gaps or mismatches:
        fail(f"tier shapes phase 2 does not check: {gaps}; round tables "
             f"that differ from the configs: {mismatches}")
    print(f"[tiers] {len(served_presets())} presets at full quality and "
          f"every brownout tier: every derived shape checked, every round "
          f"table matches", flush=True)

    from cassmantle_tpu_torch.ops import _build
    from cassmantle_tpu_torch.serving.service import InferenceService
    from cassmantle_tpu_torch.utils.device import resolve_device

    # the cost model's counts of every served config, on meta tensors in
    # child processes while the kernels build and are checked
    import concurrent.futures
    import multiprocessing

    counting = concurrent.futures.ProcessPoolExecutor(
        COUNT_PROCESSES, mp_context=multiprocessing.get_context("spawn"))
    shares = [counting.submit(precount_costs, part, COUNT_PROCESSES)
              for part in range(COUNT_PROCESSES)]
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
    entry_rows = check_w8a8_entry_points()
    bad = [label for label, r in entry_rows.items() if not r["ok"]]
    if bad:
        fail(f"the W8A8 entry points or the fp8 product disagree with "
             f"their plain versions: {bad}")
    stamp("kernels")
    # the counts, before phase 3's CPU work (the children would slow it)
    t0 = time.perf_counter()
    counts = {}
    try:
        for share in shares:
            counts.update(share.result(timeout=600))
    finally:
        counting.shutdown()
    seed_costs(counts)
    print(f"[obs-device] {len(counts)} counts made beside the build and "
          f"phase 2 in {COUNT_PROCESSES} processes, waited for "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if not check_small_agreement():
        fail("tiny geometry: card and CPU disagree")
    if not check_small_fused_and_w8a8():
        fail("tiny geometry, fused conv or W8A8: card and CPU disagree")
    if not check_small_sdxl():
        fail("tiny geometry, SDXL: card and CPU disagree")
    stamp("small: default, fused, w8a8, sdxl")
    if not check_jax_random():
        fail("jax_random: the card's keys, bits or uniforms differ from "
             "the CPU's")
    if not check_small_samplers():
        fail("tiny geometry, a sampler loop: card and CPU disagree")
    stamp("small: jax_random, samplers")
    if not check_small_mistral():
        fail("tiny geometry, Mistral: card and CPU disagree")
    stamp("small")

    # phase 4's presets; the student and Mistral serve further down
    presets = served_presets()[:10]
    tallies = {}
    brownout_s = 0.0
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
        PROFILES[preset] = prof
        if not prof["graph_witness"]["ok"]:
            fail(f"{preset}: the profiled graph replays did not launch the "
                 f"step's kernels: {prof['graph_witness']}")
        # serving over a mesh on the card, from this service's weights
        if preset == "default" and not check_mesh_sd15(card, svc, rows):
            fail("mesh: dp = 2, the sp = 2 forward or the 2 x 2 game round "
                 "failed a check")
        if preset == "sdxl" and not check_mesh_sdxl(card, svc, rows):
            fail("mesh: the sp = 2 SDXL forward or a spatial flash shape "
                 "failed a check")
        if preset in BROWNOUT_TIERS:
            t0 = time.perf_counter()
            ok, cells = check_brownout(svc, preset, card)
            brownout_s += time.perf_counter() - t0
            if not ok:
                fail(f"brownout: a {preset} tier failed its checks")
            tallies.update(cells)
        if preset == "sdxl" and not check_serve_sdxl(svc, card):
            fail("serve-sdxl: the SDXL round under 1,024 concurrent "
                 "guesses failed its checks")
        if preset == "sdxl":
            # the fused-conv, W8A8 and int8 SDXL UNets and the benched
            # encprop and turbo rounds, from this service's weights
            ok, sdxl_tallies = check_sdxl_builds(card, svc)
            if not ok:
                fail("round-sdxl_*: an SDXL build failed its checks")
            tallies.update(sdxl_tallies)
            stamp("sdxl builds")
        if preset == "fusedconv" and not check_calibrate_and_int8(card,
                                                                  svc):
            fail("calibrate / int8: a check failed")
        # the graphs' closures hold the service in reference cycles:
        # collect them, so the next round's peak memory is its own
        del svc, prof
        gc.collect()
        torch.cuda.empty_cache()
        stamp(preset)

    # the few-step tier: FrameworkConfig() with its UNet declared a
    # distilled student (consistency_available)
    t0 = time.perf_counter()
    svc = InferenceService(consistency_student_config(), table=None)
    ok, cells = check_brownout(svc, "consistency", card)
    if not ok:
        fail("brownout: the few-step tier failed its checks")
    tallies.update(cells)
    asyncio.run(svc.stop())
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    brownout_s += time.perf_counter() - t0
    print(f"[brownout] phase {brownout_s:.1f} s", flush=True)
    stamp("consistency")

    # the serving seam: queues, supervisor, integrity, device-loss recovery
    # and the int8 table at FrameworkConfig(); then the game on it
    serve_ok, game_ok, tallies["game@t5"] = check_serve(card)
    if not serve_ok:
        fail("serve: the serving seam failed a check")
    if not game_ok:
        fail("game: the game on the service failed a check")
    gc.collect()
    torch.cuda.empty_cache()
    stamp("serve, game")

    # the game server: in this process over HTTP, then `python -m
    # cassmantle_tpu_torch serve` as a child process
    t0 = time.perf_counter()
    if not check_server(card, rows):
        fail("server: the game server failed a check")
    ok, tail = check_serve_cli(card)
    print(f"[server] phases {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        print(f"[serve-cli] the child's log, last 60 lines:\n{tail}",
              flush=True)
        fail("serve-cli: `python -m cassmantle_tpu_torch serve` failed a "
             "check")
    stamp("server")

    # a card worker in a two-worker fleet: a fake peer as a child, over a
    # replicated store of two mantlestore nodes
    if not check_cluster(card, rows):
        print(f"[cluster] the peer's log, last 60 lines:\n"
              f"{log_tail(CLUSTER_PEER_LOG)}", flush=True)
        fail("cluster: the two-worker fleet failed a check")
    stamp("cluster")

    # the same service from a weights directory, its rebuild from the
    # files, and Mistral from two shards
    ok, tallies["weights"] = check_weights(card)
    if not ok:
        fail("weights: the service from a weights directory failed a check")
    if not check_weights_mistral(card):
        fail("weights-mistral: Mistral from its shards failed a check")
    stamp("weights")

    # Mistral-7B as the round's prompt LM, at full width in bf16 (8 of
    # its 32 layers); its decode-step profile, then speculative and
    # sampled decodes over it
    svc, tallies["mistral"], bad = run_round(card, "mistral",
                                             mistral_round_config())
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
    if not check_mistral_int8_ab(card):
        fail("int8 mistral: the lm-int8-ab failed a check")
    del svc, prof
    gc.collect()
    torch.cuda.empty_cache()
    stamp("mistral")

    # the staged image server at full width: parity, mid-flight
    # admission, deadline, quarantine, the loop's idle share, the load A/B
    ok, _ = check_staged(card)
    if not ok:
        fail("staged: the staged image server failed a check")
    gaps = staged_shape_gaps(rows, checked)
    if gaps:
        fail(f"staged: launches at shapes phase 2 does not check, or "
             f"flash on another path: {gaps}")
    stamp("staged")

    # training on the card and the CLIP quality gate
    if not check_train_diffusion(card):
        fail("train-diffusion: the diffusion trainer failed a check")
    stamp("train-diffusion")
    if not check_distill(card):
        fail("distill: the consistency distillation or its student's round "
             "failed a check")
    stamp("distill")
    if not check_train_lm(card):
        fail("train-lm: the LM trainer, its CLI or its resume failed a check")
    stamp("train-lm")
    if not check_clip(card):
        fail("clip: the CLIP quality gate failed a check")
    checked_keys = {"flash_attention": {(b, sq, sk, h, d) for b, sq, sk, h,
                                        d, _ in FLASH_SHAPES.values()},
                    **{k: set(v) for k, v in checked.items()}}
    timed = {}
    bad = [b for tally in SLICE_TALLIES.values()
           for b in spot_check(tally, checked_keys, timed)]
    if bad:
        fail(f"a kernel disagrees with its plain version at a shape the "
             f"training and gate phases launched: {bad}")
    print(f"[slice] launches by phase: " + json.dumps(
        {phase: {k: sum(v.values()) for k, v in tally.items()
                 if k != "flash_paths"}
         for phase, tally in SLICE_TALLIES.items()}), flush=True)
    slice_rows = {"flash_attention": {FLASH_SHAPES[name][:5]: r
                                      for name, r in rows.items()},
                  **checked}
    print(f"[slice] kernel ms a phase ({card}): " + json.dumps(
        {phase: phase_kernel_ms(tally, slice_rows, timed)
         for phase, tally in SLICE_TALLIES.items()}), flush=True)
    stamp("clip")

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

    # per [brownout] cell: each kernel's launches x its [kernel] times
    rows_by_shape = {"flash_attention": {key: rows[name]
                                         for key, name in by_shape.items()},
                     **checked}
    per_cell = {}
    for cell in (*TIER_CELLS, *SDXL_ROUNDS):
        if cell not in tallies:
            continue
        per_cell[cell] = {}
        for kernel, shape_rows in rows_by_shape.items():
            tally = tallies[cell][kernel]
            if not tally:
                continue
            sums = {field: sum(n * shape_rows[shape][field]
                               for shape, n in tally.items())
                    for field in ("ms", "bound_ms", "plain_ms")}
            # the library yardstick where a call exists (kernel 3: M > 16)
            lib = [(n, shape_rows[shape]["library_ms"])
                   for shape, n in tally.items()
                   if shape_rows[shape]["library_ms"] is not None]
            sums.update(launches=sum(tally.values()),
                        library_ms=sum(n * t for n, t in lib),
                        library_launches=sum(n for n, _ in lib))
            per_cell[cell][kernel] = sums
    print(f"[tiers] kernel ms a round ({card}): {json.dumps(per_cell)}",
          flush=True)

    # every staged run's launches, summed: a kernels-line entry's
    # staged_launches
    staged = {k: sum((t[k] for t in STAGED_TALLIES.values()),
                     collections.Counter())
              for k in ("flash_paths", *checked)}
    kernels = []
    for key, name in by_shape.items():
        r = rows[name]
        # launches and path from the first round whose model runs the
        # shape: default for SD1.5's, sdxl, encprop for the batch-4 ones,
        # a [brownout] cell for a tier's; the staged runs for the shapes
        # only they launch
        preset = next((p for p in ("default", "sdxl", "encprop",
                                   "sdxl_encprop", *TIER_CELLS)
                       if p in tallies
                       and name in ROUND_FLASH[PRESET_MODEL[p]]), None)
        mesh_paths = sum((t["flash_paths"] for t in MESH_TALLIES.values()),
                         collections.Counter())
        # the spatial shapes' main path is the [mesh] phase
        round_paths = (tallies[preset]["flash_paths"] if preset
                       else mesh_paths if name in SPATIAL_FLASH
                       else staged["flash_paths"])
        path = next((p for (shape, p) in round_paths if shape == key),
                    r["path"])
        kernels.append({
            "name": f"flash_attention[{name}]", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": sum(n for (shape, _), n in round_paths.items()
                            if shape == key),
            "staged_launches": sum(
                n for (shape, _), n in staged["flash_paths"].items()
                if shape == key),
            "mesh_launches": sum(n for (shape, _), n in mesh_paths.items()
                                 if shape == key),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "path": path, "ok": r["ok"]})
    for kernel, presets, source, replaces in (
            ("gn_silu_conv3x3", ("fusedconv", "encprop", "img2img",
                                 "fusedconv@t4", "encprop@t2", "encprop@t4",
                                 "sdxl_fused", "sdxl_encprop"),
             FUSED_SOURCE, FUSED_REPLACES),
            ("int8_matmul", ("w8a8", "w8a8@t4", "sdxl_w8a8"), INT8_SOURCE,
             MATMUL_REPLACES),
            ("int8_conv3x3", ("w8a8", "w8a8@t4", "sdxl_w8a8"), INT8_SOURCE,
             CONV_REPLACES)):
        # launches in the rounds of the presets that serve the kernel
        # (the UNet's shapes at fusedconv, the VAE decoder's at encprop,
        # at img2img the encoder's and the decoder's again, and the
        # tiers' at 256x256)
        tally = sum((tallies[p][kernel] for p in presets),
                    collections.Counter())
        kernels += kernel_entries(kernel, checked[kernel],
                                  tally + staged[kernel], source, replaces,
                                  staged[kernel])
    report_obs_device(card)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
