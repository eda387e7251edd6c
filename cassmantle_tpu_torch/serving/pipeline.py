"""Inference pipelines of the port: text -> image, prompt generation, and
the content backend that makes one round.

Port of the monolithic path of ``cassmantle_tpu/serving/pipeline.py``:
``Text2ImagePipeline.generate`` (CLIP encode -> CFG DDIM -> VAE decode ->
uint8), ``PromptGenerator`` (bucketed GPT-2 or Mistral-7B decode: greedy,
top-k sampled, or speculative under ``spec_decode``; trimmed to two
sentences) and ``TPUContentBackend.generate_sync`` as
:class:`TorchContentBackend`, and ``Text2ImagePipeline.generate_img2img``
(the VAE encoder, then a schedule tail from the noised encoding). Models
are built at the configured width
with seeded random weights, or from given state dicts (the parity tests
carry the reference's parameters over with ``models.weights.from_jax``).
The fused-conv and W8A8 presets build the same models: the UNet with
``fused_conv`` runs its ResBlock convs as one fused kernel, and under
``unet_w8a8``/``lm_w8a8`` the UNet's and GPT-2's sites quantize once, at
build, from their bf16 weights (``w8a8_unet_tools``, ``lm_w8a8_armed``),
with the calibrated static activation scales of ``data/act_scales.json``
where its entry matches the config (``parallel/calibrate.py``). Under
``unet_int8``/``lm_int8`` (weights-only int8, ``int8_unet_tools``) the
UNet or the prompt LM is built submodule by submodule and each large
weight quantized on the host before it is placed: the card never holds
the fp model beside the int8 one, and each layer dequantizes its own
weight in its forward. An ``lm_int8`` generator loads
``<family>.int8.safetensors`` from its weights directory when that file is
there and newer than the fp checkpoint, and writes it
(:meth:`PromptGenerator.save_quantized`).
A config with a second text tower (``sdxl_config()``) makes the backend
serve its image with ``serving/sdxl.py::SDXLPipeline``, as the reference's
``TPUContentBackend`` does.

Staged serving (``ServingConfig.staged_serving``, ``serving/stages.py``):
with no brownout tier engaged and the reference's gating met
(:meth:`Text2ImagePipeline._staged_enabled`), ``generate`` hands the
request to the pipeline's :class:`~cassmantle_tpu_torch.serving.stages.
StagedImageServer`: CLIP, the denoise steps and the VAE as independently
batched stages, the denoise admitting requests at step boundaries. The
stages run this module's own CLIP block and VAE tail
(:meth:`Text2ImagePipeline.encode_ids`, :meth:`_decode_stage`) and the
same x_T draw, so a solo request's image is the monolithic one's.

Many devices (``mesh=``, ``parallel/mesh.py``), after the reference's
``dp_sharded_sampler``, ``pad_prompts_to_dp`` and
``spatially_shard_latents``: the prompts pad to a multiple of the mesh's
``dp`` with ``""`` rows (dropped from the output; the cost attribution
counts them, as the reference's does); x_T is drawn for the whole padded
batch as a meshless pipeline draws it, then each dp position takes its
rows (row i is the same draw either way) and runs CLIP, the CFG denoise
and the VAE on them, its cond/uncond pair together, on its own device's
stream. A position is a view of the pipeline (:meth:`Text2ImagePipeline.
_mesh_positions`) over its card's replica of the models: positions on one
card share one copy, each other card holds one (:func:`replicate_module`,
re-placed in place by the device-loss rebuild). Each position captures
its own step graphs (keyed by position and batch), so two positions on
one card never replay over one set of static buffers. With ``sp`` > 1 a
position's UNet is ``parallel/spatial.py::SpatialUNet`` over its sp
devices: the latent rows split over sp, which every sampler and every
brownout tier rides. Its step is captured like any other when its sp
positions share one card; sp across cards runs the denoise eagerly (a
capture cannot span devices), counted at
``pipeline.spatial_eager_denoises``. The fused-conv, W8A8 and int8 UNets
refuse sp > 1 (ROADMAP Queue 1 item 16). One ``_dispatch_lock`` covers
the whole meshed dispatch, as one jitted call does in the reference;
meshed serving is monolithic (the staged gate is false). img2img stays
the reference's single-device path, on the mesh's first device.

Brownout tiers (``serving/overload.py``): while the ladder is above tier
0, ``generate`` serves the tier's degraded ``SamplerConfig``
(``degraded_sampler_cfg``: fewer steps, a wider encprop stride, the
few-step consistency loop, half the size) as its own
:class:`SamplerVariant`, keyed as the reference keys its variants
(:func:`tier_key`): its schedule, its latents at the tier's size and its
own captured graphs per batch. Tier 0 is the untouched full path, bit for
bit; ``pipeline.brownout_images`` counts the degraded images.

Counters, on the host at the reference's sites: ``pipeline.images`` (or
``pipeline.sdxl_images``) per generated image, img2img's included;
``pipeline.encprop_{key,shallow,prop}_steps`` and
``pipeline.consistency_steps`` from the served schedule;
``pipeline.w8a8_dispatches`` (UNet forwards on the int8 W8A8 path,
:func:`note_w8a8_counter`);
``pipeline.text_fallbacks`` per round whose text fell back to the
template; ``decode.spec_chunks`` and the ``decode.spec_accept_rate``
gauge after a speculative decode's one host transfer. None reads the
device inside a captured step.

Weights: each pipeline takes a ``weights_dir`` beside ``state_dicts`` and
loads every model it serves from the reference's file there
(``clip_text.safetensors``, ``unet.safetensors``, ``vae.safetensors``,
the VAE encoder from ``vae.safetensors`` at its first use;
``gpt2.safetensors``, or ``mistral.safetensors`` or its shards, and
``gpt2_draft.safetensors``) through ``models/weights.py::maybe_load``; a
model whose file is absent, unreadable or incomplete serves the seeded
init, and a model given both ways raises. ``loaded_real_weights`` says
whether every stage came from a file, as the reference's does.

Serving seam: each pipeline serializes its device work under its own
dispatch lock (``_dispatch_lock``, as the reference's), since its CUDA
graphs replay over static buffers that two overlapping calls would
overwrite; the image paths run in an executor thread
(:meth:`TorchContentBackend.generate`) while the scorer and the prompt
decode run on the batching queue's dispatch thread. The integrity
sentinels sit where the reference has them (``serving/integrity.py``):
the ``device.lost`` fault point inside each dispatch, ``poison`` and the
degenerate-frame verdict on the uint8 batch, the token-range verdict on
the decoded ids; :meth:`PromptGenerator.generate_batch` returns a
rejected row as an ``OutputInvalid`` in its slot. ``reload_params``
runs each served model's recipe again into its live tensors in place
(``models/weights.py::Rebuilds``), so every captured graph stays valid.

The denoise stage is the reference's ``run_cfg_denoise``, in its order:
few-step consistency sampling (``sampler.consistency``), encoder
propagation over any kind (alone or composed with DeepCache), DeepCache
(DDIM or DPM++), else the plain loop of ``sampler.kind`` (DDIM, Euler,
DPM-Solver++(2M)); validated at build as the reference validates
(:func:`deepcache_schedule`, :func:`encprop_plan`,
:func:`consistency_plan`; :func:`sampler_mode`), with the kill switches
``CASSMANTLE_NO_ENCPROP`` and ``CASSMANTLE_NO_CONSISTENCY`` read at build.
DDIM at eta > 0 is refused as the reference's pipelines refuse it (they
call the sampler without a key).

On CUDA the two loops run as the reference compiles them, whole: the
CFG sampler loop replays its captured bodies per batch size (one step
graph; DeepCache's pair graph; encprop's key and segment graphs;
``ops/ddim.py::SamplerGraph``), img2img's tail one step graph per
(strength steps, batch), the prompt LM's decode steps one captured
step per (padded batch, prompt bucket, max_new, sampler), and a
speculative decode one captured draft/verify chunk per shape
(``ops/decode.py``). CLIP, x_T, the prefill and the VAE run eagerly.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import copy
import dataclasses
import itertools
import logging
import os
import random
import threading
import time
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.chaos import fault_point
from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.engine.rounds import RoundContent
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.weights import (
    CHECKPOINT_FILES,
    Rebuilds,
    add_model,
    checkpoint_paths,
    convert_gpt2,
    converter_for,
    fill_,
    state_dict_from_tree,
)
from cassmantle_tpu_torch.models.vae import (
    VAEDecoder,
    VAEEncoder,
    postprocess_images,
)
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.obs.device import note_dispatch
from cassmantle_tpu_torch.ops.ddim import (
    EncpropGraph,
    SamplerGraph,
    SpecDeepCacheGraph,
    SpecGraph,
    cfg_denoiser,
    cfg_denoiser_encprop,
    cfg_denoiser_pair,
    cfg_inputs,
    encprop_disabled,
    encprop_key_indices,
    encprop_sample,
    encprop_step_counts,
    initial_latents,
    sample_spec,
    sample_spec_deepcache,
)
from cassmantle_tpu_torch.ops.decode import (
    GreedyDecodeState,
    ModelDraft,
    NgramDraft,
    SpecDecodeState,
    greedy_decode,
    speculative_decode,
)
from cassmantle_tpu_torch.ops.fused_conv import describe as fc_describe
from cassmantle_tpu_torch.ops.quant import (
    int8_layout_,
    int8_modules,
    int8_site_count,
    load_quantized,
    tree_nbytes,
    w8a8_calibrated,
    w8a8_default_predicate,
    w8a8_modules,
    w8a8_site_count,
)
from cassmantle_tpu_torch.ops.quant_matmul import describe as w8a8_describe
from cassmantle_tpu_torch.ops.quant_matmul import w8a8_disabled
from cassmantle_tpu_torch.ops.samplers import (
    SAMPLER_KINDS,
    consistency_disabled,
    img2img_start,
    make_schedule,
)
from cassmantle_tpu_torch.parallel.collectives import device_scope, move
from cassmantle_tpu_torch.parallel.mesh import Mesh, indexed_device
from cassmantle_tpu_torch.parallel.spatial import SpatialUNet, check_spatial
from cassmantle_tpu_torch.server.assets import load_styles
from cassmantle_tpu_torch.serving import integrity
from cassmantle_tpu_torch.serving.overload import (
    degraded_sampler_cfg,
    quality_overrides,
)
from cassmantle_tpu_torch.utils import jax_random
from cassmantle_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    synchronize,
    torch_dtype,
)
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import metrics
from cassmantle_tpu_torch.utils.profiling import annotate, block_timer
from cassmantle_tpu_torch.utils.text import (
    is_wordlike,
    sanitize_text,
    template_text,
    tokenize_words,
    two_sentences,
)
from cassmantle_tpu_torch.utils.tokenizers import (
    load_tokenizer,
    tokenize_clip_prompts,
)

log = logging.getLogger(__name__)

# Seed offsets of the random init, one per model (the reference's init
# slots: CLIP 1, UNet 2, VAE 3, the VAE encoder 4, the prompt LM 5 (GPT-2
# or Mistral), the speculative decode's GPT-2 draft 6, SDXL's bigG
# tower 11).
INIT_SEEDS = {"clip_text": 1, "unet": 2, "vae": 3, "vae_enc": 4, "gpt2": 5,
              "mistral": 5, "gpt2_draft": 6, "clip_text_2": 11}


def unet_w8a8_armed(models_cfg) -> bool:
    """True when the UNet serves W8A8: the config asks for it and
    CASSMANTLE_NO_W8A8 (read here, at build) is not set."""
    return bool(models_cfg.unet_w8a8) and not w8a8_disabled()


def lm_w8a8_armed(models_cfg) -> bool:
    """The LM's twin of :func:`unet_w8a8_armed` (per-token scales)."""
    return bool(models_cfg.lm_w8a8) and not w8a8_disabled()


def int8_unet_tools(models_cfg
                    ) -> Optional[Callable[[torch.nn.Module], int]]:
    """The weights-only int8 UNet's transform (quantize a built
    submodule's large weights on the host, in place; returns the count),
    given to :func:`build_streamed`, or None when ``unet_int8`` is off.
    The one place the int8 serving contract lives, shared by the SD1.5
    and SDXL pipelines: quantized before placement, dequantized layer by
    layer in the forward."""
    if not models_cfg.unet_int8:
        return None
    return int8_modules


def w8a8_unet_tools(models_cfg) -> Optional[Callable[[torch.nn.Module], int]]:
    """The UNet's W8A8 transform (quantize every site of a built UNet in
    place; returns the site count), or None when W8A8 is off. Sites the
    committed calibration artifact covers for this config
    (``parallel/calibrate.py::load_act_scales``) get static activation
    scales; the others, or all when no entry matches, scale dynamically."""
    if not unet_w8a8_armed(models_cfg):
        return None
    if models_cfg.unet_int8:
        raise ValueError("unet_w8a8 and unet_int8 are mutually exclusive: "
                         "both rewrite the same kernel leaves")
    if not models_cfg.unet.fused_conv:
        raise ValueError("unet_w8a8 conv sites ride the fused GN+SiLU+conv "
                         "path; set models.unet.fused_conv=True")
    from cassmantle_tpu_torch.parallel.calibrate import load_act_scales

    pred = partial(w8a8_default_predicate, min_size=models_cfg.w8a8_min_size)
    return partial(w8a8_modules, act_scales=load_act_scales(models_cfg),
                   predicate=pred)


def build_model(module: torch.nn.Module, kind: str, device: torch.device,
                seed: int, state_dict: Optional[Mapping] = None,
                storage_dtype: Optional[torch.dtype] = None
                ) -> torch.nn.Module:
    """Fill ``module`` (already on ``device``) from ``state_dict`` (a dict
    or a checkpoint's :class:`Converted` plan, copied tensor by tensor) or
    a seeded random init, then store its parameters in ``storage_dtype``.
    A served model is never differentiated: its parameters require no
    grad, so no served forward records a graph, and the flash kernel,
    which has no backward, serves every call outside a trainer."""
    if state_dict is not None:
        fill_(module, state_dict)
    else:
        gen = torch.Generator(device).manual_seed(seed + INIT_SEEDS[kind])
        init_weights(module, gen)
    if storage_dtype is not None:
        module.to(storage_dtype)
    return module.requires_grad_(False).eval()


def build_streamed(factory: Callable[[], torch.nn.Module], kind: str,
                   device: torch.device, seed: int,
                   state_dict: Optional[Mapping] = None,
                   storage_dtype: Optional[torch.dtype] = None,
                   quantize: Optional[Callable[[torch.nn.Module], int]]
                   = None) -> torch.nn.Module:
    """:func:`build_model` for a model too large to hold in fp32 beside its
    stored copy (Mistral-7B: 29 GB in fp32, 14.5 GB in bf16). The module
    is made on the meta device, then each top-level submodule in turn is
    made on ``device`` in fp32, filled from ``state_dict`` or the seeded
    init (in build_model's order) and cast to ``storage_dtype``: the peak
    is the stored footprint plus one submodule in fp32. The module may
    hold no parameter or buffer of its own. A checkpoint's
    :class:`Converted` plan converts each submodule's tensors as it is
    filled, from the mapped file.

    ``quantize`` (weights-only int8, :func:`int8_unet_tools`) runs on each
    submodule once it holds its stored weights, so the card holds the
    int8 model built so far and one submodule in fp. A ``state_dict``
    of a quantized file (``weight_q8`` keys) fills those sites as given."""
    with torch.device("meta"):
        module = factory()
    if (next(module.parameters(recurse=False), None) is not None
            or next(module.buffers(), None) is not None):
        raise ValueError("build_streamed fills submodule parameters only")
    gen = (None if state_dict is not None else
           torch.Generator(device).manual_seed(seed + INIT_SEEDS[kind]))
    for name, child in module.named_children():
        child.to_empty(device=device)
        part = None
        if gen is not None:
            init_weights(child, gen)
        else:
            prefix = f"{name}."
            part = {k[len(prefix):]: state_dict[k]
                    for k in state_dict if k.startswith(prefix)}
        q8 = [k[:-len("weight_q8")].rstrip(".") for k in part or ()
              if k.split(".")[-1] == "weight_q8"]
        if q8:
            # int8 buffers as the file gives them; the cast first, so the
            # fp32 scales stay fp32
            if storage_dtype is not None:
                child.to(storage_dtype)
            int8_layout_(child, q8)
            fill_(child, part)
        else:
            if part is not None:
                fill_(child, part)
            if storage_dtype is not None:
                child.to(storage_dtype)
        if quantize is not None:
            quantize(child)
    if state_dict is not None:
        known = set(module.state_dict())
        # a site quantized here took its fp weight
        known |= {k[:-len("_q8")] for k in known if k.endswith("weight_q8")}
        unexpected = set(state_dict) - known
        if unexpected:
            raise ValueError(f"unexpected keys {sorted(unexpected)}")
    return module.requires_grad_(False).eval()


def _require(ok: bool, message: str) -> None:
    """The reference's ``assert``: an AssertionError with its message
    (raised, so it holds under ``python -O`` too)."""
    if not ok:
        raise AssertionError(message)


def deepcache_schedule(sampler_cfg) -> None:
    """Validate a DeepCache sampler config as the reference does: eta 0,
    DDIM with an even step count or DPM++(2M) with any."""
    s = sampler_cfg
    _require(s.eta == 0.0,
             "deepcache needs eta=0 (the paired loop is deterministic)")
    if s.kind == "ddim":
        _require(s.num_steps % 2 == 0,
                 "ddim deepcache pairing needs an even step count")
        return
    _require(s.kind == "dpmpp_2m", f"deepcache composes with ddim or "
             f"dpmpp_2m, not {s.kind!r}")


def encprop_plan(sampler_cfg) -> Tuple[int, int, int]:
    """Validate an encoder-propagation config as the reference does and
    return (stride, dense_steps, key forwards): eta 0, any sampler kind,
    stride >= 1, the dense prefix within the steps, and DeepCache's own
    kind rule when composed."""
    s = sampler_cfg
    _require(s.eta == 0.0, "encprop needs eta=0 (the propagated decoder "
             "loop is deterministic)")
    _require(s.kind in SAMPLER_KINDS,
             f"encprop composes with {SAMPLER_KINDS}, not {s.kind!r}")
    _require(s.encprop_stride >= 1,
             f"encprop stride must be >= 1, got {s.encprop_stride}")
    _require(0 <= s.encprop_dense_steps <= s.num_steps,
             "encprop dense prefix outside the step count")
    if s.deepcache:
        _require(s.kind in ("ddim", "dpmpp_2m"), f"deepcache composes with "
                 f"ddim or dpmpp_2m, not {s.kind!r}")
    keys = encprop_key_indices(s.num_steps, s.encprop_stride,
                               s.encprop_dense_steps)
    return s.encprop_stride, s.encprop_dense_steps, len(keys)


def consistency_plan(sampler_cfg) -> int:
    """Validate a few-step consistency config as the reference does and
    return its step count: eta 0, 1-8 steps, neither DeepCache nor
    encprop, and a teacher grid longer than the steps."""
    s = sampler_cfg
    _require(s.eta == 0.0, "consistency sampling is deterministic (eta=0)")
    _require(1 <= s.num_steps <= 8, (
        f"consistency serving is the few-step path (1-8 steps), got "
        f"{s.num_steps}; the teacher schedule lives in "
        f"consistency_teacher_steps"))
    _require(not s.deepcache,
             "consistency does not compose with deepcache (no paired loop)")
    _require(not s.encprop,
             "consistency does not compose with encprop (no key schedule)")
    _require(s.consistency_teacher_steps > s.num_steps, (
        f"consistency_teacher_steps ({s.consistency_teacher_steps}) must "
        f"exceed num_steps ({s.num_steps}): the student only ever trains "
        f"on the teacher discretization's query points "
        f"(ops/samplers.py::ConsistencySchedule), and the kill switch "
        f"reverts to this schedule"))
    return s.num_steps


def note_encprop_counters(counts, n_images: int) -> None:
    """The UNet forwards an encoder-propagation dispatch served, from its
    schedule's (key, shallow, propagated) counts (None: not encprop)."""
    if counts:
        keys, shallow, props = counts
        metrics.inc("pipeline.encprop_key_steps", keys * n_images)
        if shallow:
            metrics.inc("pipeline.encprop_shallow_steps", shallow * n_images)
        metrics.inc("pipeline.encprop_prop_steps", props * n_images)


def note_consistency_counter(sampler_cfg, n_images: int) -> None:
    """The consistency UNet forwards a dispatch served (the effective
    config: silent under the kill switch)."""
    if sampler_cfg.consistency:
        metrics.inc("pipeline.consistency_steps",
                    sampler_cfg.num_steps * n_images)


def note_w8a8_counter(models_cfg, sampler_cfg, n_images: int) -> None:
    """``pipeline.w8a8_dispatches``: the UNet forwards a dispatch ran on
    the int8 W8A8 path (the served schedule's steps a image), the
    reference's proof that the kernels engaged. Silent when the config
    or the kill switch left the UNet in fp."""
    if unet_w8a8_armed(models_cfg):
        metrics.inc("pipeline.w8a8_dispatches",
                    effective_sampler_steps(sampler_cfg) * n_images)


def effective_sampler_cfg(sampler_cfg):
    """The sampler config that is served: with consistency configured and
    CASSMANTLE_NO_CONSISTENCY (read here) set, the teacher path, the
    configured kind at ``consistency_teacher_steps``."""
    if sampler_cfg.consistency and consistency_disabled():
        return dataclasses.replace(
            sampler_cfg, consistency=False,
            num_steps=sampler_cfg.consistency_teacher_steps)
    return sampler_cfg


def effective_sampler_steps(sampler_cfg) -> int:
    """The step count of the served schedule (:func:`effective_sampler_cfg`)."""
    return effective_sampler_cfg(sampler_cfg).num_steps


def sampler_mode(sampler_cfg) -> str:
    """Validate ``sampler_cfg`` as the reference's pipelines do when they
    are built (:func:`deepcache_schedule`, :func:`encprop_plan`,
    :func:`consistency_plan`, then the kind) and return the loop the
    effective config serves, in ``run_cfg_denoise``'s order:
    "consistency", "encprop" (unless CASSMANTLE_NO_ENCPROP, read here, is
    set), "deepcache", else the kind ("ddim", "euler", "dpmpp_2m")."""
    s = sampler_cfg
    if s.deepcache:
        deepcache_schedule(s)
    if s.encprop:
        encprop_plan(s)
    if s.consistency:
        consistency_plan(s)
    eff = effective_sampler_cfg(s)
    if eff.consistency:
        return "consistency"
    if eff.kind not in SAMPLER_KINDS:
        raise ValueError(f"unknown sampler kind {eff.kind!r}; "
                         f"choose from {SAMPLER_KINDS}")
    if eff.encprop and not encprop_disabled():
        return "encprop"
    return "deepcache" if eff.deepcache else eff.kind


class SamplerVariant:
    """One served sampler config and what its denoise needs: the loop
    (:func:`sampler_mode`), its schedule, the encprop forward counts and
    the captured loop of each batch size (CUDA, made on first use: a
    SpecGraph, SpecDeepCacheGraph or EncpropGraph). A pipeline serves its
    own config's variant, and one more per brownout tier that engages
    (:meth:`Text2ImagePipeline.tier_variant`). Building one validates the
    config and builds its schedule on the host; nothing touches the
    device until its first denoise."""

    def __init__(self, sampler_cfg) -> None:
        self.mode = sampler_mode(sampler_cfg)
        # the config served: the teacher's under the consistency kill switch
        s = self.sampler_cfg = effective_sampler_cfg(sampler_cfg)
        self.schedule = make_schedule(s.kind, s.num_steps, s.consistency,
                                      s.consistency_teacher_steps)
        # (key, shallow, propagated) UNet forwards of a trajectory when
        # encoder propagation serves, else None
        self.encprop_counts = (
            encprop_step_counts(s.num_steps, s.encprop_stride,
                                s.encprop_dense_steps, s.deepcache)
            if self.mode == "encprop" else None)
        self.step_graphs: Dict[int, SamplerGraph] = {}


def tier_key(sampler_cfg) -> Tuple[int, int, int, bool]:
    """The reference's cache key of a degraded config: (steps, encprop
    stride, image size, consistency)."""
    s = sampler_cfg
    return (s.num_steps, s.encprop_stride, s.image_size, s.consistency)


def check_eta(sampler_cfg) -> None:
    """DDIM at eta > 0 needs a step key, and the reference's pipelines
    call their sampler without one: its error."""
    if sampler_cfg.kind == "ddim" and sampler_cfg.eta > 0.0:
        raise ValueError("eta > 0 requires an rng key")


def pad_prompts_to_dp(prompts: Sequence[str], dp: int
                      ) -> Tuple[List[str], int]:
    """Pad a prompt list to a multiple of the dp width (equal per-position
    shards) with ``""`` rows; callers drop the pad rows from the output.
    Returns (padded, the count before padding)."""
    n = len(prompts)
    return list(prompts) + [""] * ((-n) % dp), n


def serving_layout(mesh: Mesh) -> List[List[torch.device]]:
    """Per dp position, the devices of its sp positions (in row order).
    Serving shards over dp and sp only: tp, pp and ep are training's
    axes."""
    for axis in ("tp", "pp", "ep"):
        if mesh.shape.get(axis, 1) != 1:
            raise NotImplementedError(
                f"serving over {axis}={mesh.shape[axis]}: the serving "
                f"layouts are dp and sp; {axis} is ROADMAP Queue 1 item "
                f"16's training half")
    # the other axes are 1: dp before sp in axis order
    return [list(row) for row in
            mesh.devices.reshape(mesh.shape["dp"], mesh.shape["sp"])]


def replicate_module(module: torch.nn.Module,
                     device: torch.device) -> torch.nn.Module:
    """A copy of ``module`` on ``device``: its structure copied over meta
    tensors, then every parameter and buffer made on ``device`` and copied
    device to device (nothing staged through host memory; the source
    card holds no second copy)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else meta)
    twin = copy.deepcopy(module, memo).to_empty(device=device)
    copy_module_(twin, module)
    return twin


def copy_module_(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Every parameter and buffer of ``src`` into ``dst``'s, in place."""
    with torch.no_grad():
        for a, b in zip(itertools.chain(dst.parameters(), dst.buffers()),
                        itertools.chain(src.parameters(), src.buffers())):
            a.copy_(b)


class _ReloadsParams:
    """The device-loss rebuild of a pipeline with a ``_dispatch_lock``: it
    builds what it serves through ``self._rebuilds``, whose recipes run
    again into the same tensors under the lock, so the captured graphs
    keep their buffers and stay valid; then a meshed pipeline copies the
    rebuilt models into its other cards' replicas (``_replace_replicas``)."""

    _rebuilds: Rebuilds

    def param_tensors(self) -> List[torch.Tensor]:
        """The parameters and buffers the pipeline serves from."""
        return self._rebuilds.tensors()

    def _replace_replicas(self) -> None:
        """Re-place what other devices hold of the rebuilt models."""

    def reload_params(self) -> None:
        """Raises on a context an error left unusable (a sticky CUDA
        error)."""
        with self._dispatch_lock:
            self._rebuilds.reload()
            self._replace_replicas()
            synchronize(self.device)


def _replicate(value, device: torch.device):
    """A card's replica of one ``REPLICATED`` attribute: a module or a
    tensor copied there; a dict (made on demand per card) empty; None."""
    if isinstance(value, torch.nn.Module):
        return replicate_module(value, device)
    if isinstance(value, torch.Tensor):
        return move(value, device).clone()
    if isinstance(value, dict):
        return {}
    return value


class Text2ImagePipeline(_ReloadsParams):
    """prompts -> (B, H, W, 3) uint8 images: CLIP -> the CFG sampler loop
    -> VAE; and images + prompts -> images (:meth:`generate_img2img`)."""

    # the name its fault points, integrity verdicts and lock carry
    PIPELINE = "t2i"
    LOCK_RANK = 10
    # the checkpoint kinds of its UNet and VAE decoder (models/weights.py)
    UNET_KIND, VAE_KIND = "unet", "vae"
    # the profiler ranges of a dispatch's stages (utils/profiling.py)
    RANGES = ("clip_encode", "denoise_scan", "vae_decode")
    # what each card of a mesh holds a replica of (by attribute)
    REPLICATED = ("clip", "unet", "vae")
    # a mesh position's index (None: the pipeline itself, meshless)
    position: Optional[int] = None
    # False for a position whose sp devices span cards: its denoise runs
    # eagerly (a CUDA graph cannot span devices)
    graphable = True

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 weights_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None,
                 share_params_with: Optional["Text2ImagePipeline"] = None):
        """``mesh``: serve over its dp and sp axes (the module's
        docstring); its devices take the place of ``device``, the models
        building on its first. ``share_params_with``: serve another
        pipeline's models (same model configs, same device), as the
        reference's argument of that name: nothing is built or copied,
        and either's rebuild refills both."""
        # the configured sampler's loop, schedule and captured graphs
        self.full_variant = SamplerVariant(cfg.sampler)
        # the brownout tiers' variants, by tier_key, built as they engage
        self.tier_variants: Dict[Tuple[int, int, int, bool],
                                 SamplerVariant] = {}
        w8a8 = w8a8_unet_tools(cfg.models)
        int8 = int8_unet_tools(cfg.models)
        self.cfg = cfg
        self.mesh = mesh
        self._layout = None if mesh is None else serving_layout(mesh)
        if mesh is not None:
            device = mesh.home
        self.device = resolve_device(device)
        # the prompts a dispatch pads to a multiple of, and the distinct
        # devices it runs on (utilization divides by their peaks)
        self.dp = 1 if mesh is None else mesh.shape["dp"]
        self.cards = ([self.device] if mesh is None
                      else mesh.distinct_devices())
        # the mesh positions' views and each card's replicas, made at the
        # first meshed dispatch (_mesh_positions)
        self._positions: Optional[List["Text2ImagePipeline"]] = None
        self._replicas: Dict[torch.device, Dict[str, object]] = {}
        # the dispatch's dropped pad rows (uint8), for checks
        self.last_pad_images = np.zeros((0,), np.uint8)
        # serializes this pipeline's device work: its graphs replay over
        # static buffers (x_t, the conditioning) that two overlapping
        # calls would overwrite
        self._dispatch_lock = OrderedLock(
            f"pipeline.{self.PIPELINE}_dispatch", rank=self.LOCK_RANK)
        m = cfg.models
        sd = state_dicts or {}
        self.weights_dir = weights_dir
        # the encoder's weights, kept for its build on first use
        self._vae_enc_state = sd.get("vae_enc")
        if self._vae_enc_state is not None and checkpoint_paths(
                weights_dir, CHECKPOINT_FILES["vae_enc"]):
            raise ValueError("vae_enc: given in state_dicts and in "
                             f"{CHECKPOINT_FILES['vae_enc']}; give one")
        param_dtype = torch_dtype(m.param_dtype)
        if share_params_with is not None:
            self._share(share_params_with)
        else:
            self._rebuilds = Rebuilds()

            def unet(weights: Optional[Mapping]) -> UNet:
                if int8 is not None:
                    # submodule by submodule, each quantized on the host
                    return build_streamed(partial(UNet, m.unet), "unet",
                                          self.device, cfg.seed, weights,
                                          param_dtype, quantize=int8)
                model = self._build(partial(UNet, m.unet), "unet", weights,
                                    param_dtype)
                if w8a8 is not None:
                    w8a8(model)
                return model

            # the reference's pipeline runs CLIP in fp32 over parameters
            # stored in param_dtype, the UNet in its own dtype over
            # param_dtype storage, and the VAE over fp32 storage
            self.clip, clip_file = self._add(
                partial(self._build, partial(ClipTextEncoder, m.clip_text),
                        "clip_text", storage_dtype=param_dtype),
                "clip_text", sd.get("clip_text"))
            self.unet, unet_file = self._add(
                unet, self.UNET_KIND, sd.get("unet"),
                param_dtype if w8a8 is not None else None)
            self.vae, vae_file = self._add(
                partial(self._build, partial(VAEDecoder, m.vae), "vae"),
                self.VAE_KIND, sd.get("vae"))
            # True only when every stage came from a checkpoint (the
            # reference's flag: quality checks refuse a seeded stage)
            self.loaded_real_weights = clip_file and unet_file and vae_file
        if self._layout is not None and len(self._layout[0]) > 1:
            check_spatial(self.unet)
        for part in (m.unet, m.vae):
            if fc_describe(part):
                log.info("%s", fc_describe(part))
        if w8a8 is not None:
            log.info("%s", w8a8_describe(w8a8_calibrated(self.unet),
                                         w8a8_site_count(self.unet)))
        if int8 is not None:
            log.info("unet_int8: %d weights-only int8 weights, %.2f GB "
                     "UNet", int8_site_count(self.unet),
                     tree_nbytes(self.unet) / 1e9)
        # SDXL's two towers share the CLIP vocabulary and one tokenization
        self.tokenizer = load_tokenizer("clip", m.clip_text.vocab_size,
                                        weights_dir)
        self._set_shapes(cfg)
        # img2img: the VAE encoder (built on first use) and the captured
        # tail of each (strength steps, latent shape (B, h, w, 4))
        self.vae_enc: Optional[VAEEncoder] = None
        self.img2img_graphs: Dict[Tuple[int, Tuple[int, ...]],
                                  SamplerGraph] = {}
        # host seconds of the last generate() per stage, each ended by a
        # device synchronize; and whether the last decode was finite
        # before its uint8 quantisation
        self.last_stage_seconds: Dict[str, float] = {}
        self.last_decoded_finite = True
        # the serving supervisor (set by InferenceService): the staged
        # server's stage progress and quarantines report to it
        self.supervisor = None
        # the staged server, made at the first staged generate (one
        # denoise thread a pipeline) and dropped by reload_params
        self._staged = None
        # the models' published-width twins on the meta device, made at
        # the first cost count (image_products)
        self._meta_twins: Optional[Dict[str, object]] = None
        self._staged_init_lock = OrderedLock("pipeline.staged_init",
                                             rank=13)

    def _share(self, donor: "Text2ImagePipeline") -> None:
        """Serve ``donor``'s models (``share_params_with``)."""
        if donor.cfg.models != self.cfg.models:
            raise ValueError("share_params_with needs the same model "
                             "configs")
        if indexed_device(donor.device) != indexed_device(self.device):
            raise ValueError(f"share_params_with: the donor's models are "
                             f"on {donor.device}, this pipeline's on "
                             f"{self.device}")
        self._rebuilds = donor._rebuilds
        for name in self.REPLICATED:
            setattr(self, name, getattr(donor, name))
        self.loaded_real_weights = donor.loaded_real_weights

    def _build(self, factory: Callable[[], torch.nn.Module], kind: str,
               state_dict: Optional[Mapping],
               storage_dtype: Optional[torch.dtype] = None
               ) -> torch.nn.Module:
        """:func:`build_model` of ``factory()``, made on this device."""
        with torch.device(self.device):
            module = factory()
        return build_model(module, kind, self.device, self.cfg.seed,
                           state_dict, storage_dtype)

    def _add(self, build: Callable[[Optional[Mapping]], torch.nn.Module],
             kind: str, state_dict: Optional[Mapping],
             quant_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.nn.Module, bool]:
        """:func:`add_model` of checkpoint ``kind`` from this pipeline's
        weights directory."""
        return add_model(self._rebuilds, build, kind, self.weights_dir,
                         CHECKPOINT_FILES[kind],
                         converter_for(kind, self.cfg.models), state_dict,
                         quant_dtype)

    def _tokenize_host(self, prompts: Sequence[str]) -> np.ndarray:
        return tokenize_clip_prompts(self.tokenizer, prompts, self.pad_len,
                                     self.cfg.models.clip_text.vocab_size)

    def _tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        return self._ids_on_device(self._tokenize_host(prompts))

    def _ids_on_device(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids).long().to(self.device)

    # -- many devices (parallel/mesh.py) -----------------------------------
    def _mesh_positions(self) -> List["Text2ImagePipeline"]:
        """The dp positions a dispatch runs on: the pipeline itself
        without a mesh; with one, a view per dp position (a shallow copy
        over its card's replica of ``REPLICATED``, its ``position`` and
        device; with sp > 1 a :class:`SpatialUNet` over its sp devices'
        UNets), made at the first call. The replicas: the pipeline's own
        models on the mesh's first device, :func:`replicate_module` on
        every other."""
        if self._positions is not None:
            return self._positions
        if self.mesh is None:
            self._positions = [self]
            return self._positions
        self._replicas = {indexed_device(self.device): {
            name: getattr(self, name) for name in self.REPLICATED}}
        for dev in self.cards:
            if dev not in self._replicas:
                self._replicas[dev] = {
                    name: _replicate(getattr(self, name), dev)
                    for name in self.REPLICATED}
        views = []
        for index, devs in enumerate(self._layout):
            view = copy.copy(self)
            view.__dict__.update(self._replicas[devs[0]])
            view.device, view.position = devs[0], index
            if len(devs) > 1:
                view.unet = SpatialUNet(
                    [self._replicas[d]["unet"] for d in devs], devs)
                if len(set(devs)) > 1:
                    # a CUDA graph cannot span devices
                    view.graphable = False
                    log.warning("dp position %d: its sp positions span "
                                "%d cards; its denoise runs eagerly", index,
                                len(set(devs)))
            views.append(view)
        self._positions = views
        return views

    def _replace_replicas(self) -> None:
        """After a rebuild: every other card's replica refilled from the
        rebuilt models, in place (their graphs stay valid)."""
        home = indexed_device(self.device)
        for dev, replica in self._replicas.items():
            if dev == home:
                continue
            for name in self.REPLICATED:
                src, dst = getattr(self, name), replica[name]
                if isinstance(src, torch.nn.Module):
                    copy_module_(dst, src)
                elif isinstance(src, torch.Tensor):
                    dst.copy_(src)
            synchronize(dev)

    def _synchronize_cards(self) -> None:
        for dev in self.cards:
            synchronize(dev)

    def encode(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The CFG conditioning of ``prompts`` and the negative prompt, as
        :func:`cfg_inputs`'s keyword arguments."""
        return self.encode_ids(self._tokenize(prompts), self._tokenize(
            [self.cfg.sampler.negative_prompt] * len(prompts)))

    def encode_ids(self, ids: torch.Tensor,
                   uncond_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """:meth:`encode` from token ids (B, pad) of the prompts and of
        the negative prompt."""
        return {"context": self.clip(ids)["hidden"],
                "uncond_context": self.clip(uncond_ids)["hidden"]}

    def denoise(self, latents: torch.Tensor, cond: Dict[str, torch.Tensor],
                graphed: Optional[bool] = None,
                variant: Optional[SamplerVariant] = None) -> torch.Tensor:
        """The CFG sampler steps from x_T under ``cond`` (:meth:`encode`'s
        output) -> the final latents, the denoise stage both pipelines
        share (the reference's ``run_cfg_denoise``), by ``sampler_mode``:
        consistency, encoder propagation, DeepCache pairs, or the kind's
        plain loop. ``graphed`` (default: on CUDA) replays the captured
        loop of this batch size, captured on first use, as the reference
        jits its sampler per batch; a capture failure raises.
        ``graphed=False`` runs the same steps eagerly. ``variant`` (default:
        the pipeline's own config) is the sampler config served, a
        brownout tier's with its own graphs."""
        v = variant or self.full_variant
        s = v.sampler_cfg
        check_eta(s)
        inputs = cfg_inputs(**cond)
        gs = s.guidance_scale
        mode = v.mode
        schedule = v.schedule
        if graphed is None:
            graphed = self.device.type == "cuda" and self.graphable
            if self.device.type == "cuda" and not graphed:
                metrics.inc("pipeline.spatial_eager_denoises")
        if mode == "encprop":
            make = partial(cfg_denoiser_encprop, self.unet,
                           guidance_scale=gs, deepcache=s.deepcache)
            stride, dense = s.encprop_stride, s.encprop_dense_steps
            if not graphed:
                key, prop, shallow = make(**inputs)
                return encprop_sample(schedule.spec(latents), key, prop,
                                      latents, stride, dense,
                                      denoise_shallow=shallow)
            build = partial(EncpropGraph, make, schedule, latents, stride,
                            dense)
        elif mode == "deepcache":
            make = partial(cfg_denoiser_pair, self.unet, guidance_scale=gs)
            if not graphed:
                return sample_spec_deepcache(schedule.spec(latents),
                                             *make(**inputs), latents)
            build = partial(SpecDeepCacheGraph, make, schedule, latents)
        else:
            make = partial(cfg_denoiser, self.unet, guidance_scale=gs)
            if not graphed:
                return sample_spec(schedule.spec(latents), make(**inputs),
                                   latents)
            build = partial(SpecGraph, make, schedule, latents)
        # a mesh position's own graphs: two positions never replay over
        # one set of static buffers
        key = (latents.shape[0] if self.position is None
               else (self.position, latents.shape[0]))
        graph = v.step_graphs.get(key)
        if graph is None:
            graph = build(**inputs)
            v.step_graphs[key] = graph
        return graph(latents, **inputs)

    # -- brownout tiers (serving/overload.py) ------------------------------
    def tier_variant(self, tier) -> Optional[SamplerVariant]:
        """The variant a brownout tier serves, or None for the untouched
        full-quality path (tier 0, or a delta equal to the configured
        sampler). Each delta is planned once and cached by
        :func:`tier_key`; its graphs capture at its first denoise, so only
        the tiers that engage hold a graph pool. A delta the config cannot
        take (its plan raises before any device work) is counted at
        ``pipeline.brownout_delta_unusable`` and serves full quality, as
        the reference's does; anything the device raises propagates."""
        if tier is None:
            return None
        scfg = degraded_sampler_cfg(self.cfg.sampler, tier)
        if scfg == self.cfg.sampler:
            return None
        key = tier_key(scfg)
        variant = self.tier_variants.get(key)
        if variant is None:
            try:
                variant = SamplerVariant(scfg)
                check_eta(variant.sampler_cfg)
            except (AssertionError, ValueError):
                # the ladder believes it engaged a cheaper tier while this
                # config serves full quality: invisible in the tier
                # gauge, so the mismatch has its own counter
                metrics.inc("pipeline.brownout_delta_unusable")
                log.exception("brownout tier delta unusable for this "
                              "config; serving full quality")
                return None
            self.tier_variants[key] = variant
        return variant

    def _set_shapes(self, cfg: FrameworkConfig) -> None:
        m = cfg.models
        self.pad_len = min([cfg.sampler.prompt_pad_len] + [
            t.max_positions for t in (m.clip_text, m.clip_text_2)
            if t is not None])
        # pixels per latent: one 2x upsample per VAE level transition
        self.vae_scale = 2 ** (len(m.vae.channel_mults) - 1)

    # -- the cost model (obs/costmodel.py) ---------------------------------
    @classmethod
    def shape_twin(cls, cfg: FrameworkConfig) -> "Text2ImagePipeline":
        """A pipeline of ``cfg`` holding only what the cost counts read
        (config, variant, shapes) and no model: :meth:`image_products`
        and :meth:`staged_denoise_products` of a config at any width,
        without building it."""
        twin = cls.__new__(cls)
        twin.cfg = cfg
        twin.full_variant = SamplerVariant(cfg.sampler)
        twin._set_shapes(cfg)
        twin._meta_twins = None
        return twin

    def cost_signature(self, variant: Optional[SamplerVariant] = None
                       ) -> str:
        """The cost model's key of one dispatch variant (default: the
        pipeline's own)."""
        s = (variant or self.full_variant).sampler_cfg
        return costmodel.t2i_signature(self.cfg, s)

    def _meta_models(self) -> Dict[str, object]:
        """The served models' twins on the meta device, by attribute: the
        same modules at the same width (the UNet under W8A8 or
        weights-only int8 when that is served), with no storage."""
        m = self.cfg.models
        unet = costmodel.meta_module(partial(UNet, m.unet))
        w8a8, int8 = w8a8_unet_tools(m), int8_unet_tools(m)
        if w8a8 is not None:
            w8a8(unet)
        if int8 is not None:
            int8(unet)
        return {"clip": costmodel.meta_module(
                    partial(ClipTextEncoder, m.clip_text)),
                "unet": unet,
                "vae": costmodel.meta_module(partial(VAEDecoder, m.vae))}

    def _twins(self) -> Dict[str, object]:
        if self._meta_twins is None:
            self._meta_twins = self._meta_models()
        return self._meta_twins

    def image_products(self, variant: Optional[SamplerVariant] = None
                       ) -> costmodel.Products:
        """The products of one image under ``variant`` (default: the
        pipeline's own): this pipeline's encode, denoise loop (eager,
        every step) and VAE decode run at batch 1 on the meta twins of its
        models, each distinct UNet forward walked once. Nothing touches
        the card."""
        v = variant or self.full_variant
        twins = self._twins()

        def walk(counter: costmodel.ProductCounter) -> None:
            shadow = copy.copy(self)
            shadow.__dict__.update(twins)
            shadow.unet = costmodel.MemoCall(twins["unet"], counter)
            shadow.device = torch.device("meta")
            ids = torch.zeros((1, self.pad_len), dtype=torch.long,
                              device="meta")
            cond = shadow.encode_ids(ids, ids)
            size = v.sampler_cfg.image_size // self.vae_scale
            x = torch.zeros((1, size, size, 4), device="meta")
            final = Text2ImagePipeline.denoise(shadow, x, cond,
                                               graphed=False, variant=v)
            shadow.vae(final)

        return costmodel.count_products(walk)

    def staged_denoise_products(self) -> costmodel.Products:
        """One staged request's denoise: the served schedule's steps, each
        one CFG forward at width 1 (the slot denoiser over the meta UNet
        at batch 2)."""
        from cassmantle_tpu_torch.ops.ddim import make_slot_denoiser

        unet = self._twins()["unet"]
        s = self.full_variant.sampler_cfg
        m = self.cfg.models
        size = s.image_size // self.vae_scale

        def walk(counter: costmodel.ProductCounter) -> None:
            def meta(*shape):
                return torch.zeros(shape, device="meta")

            denoise = make_slot_denoiser(unet, s.guidance_scale)
            ctx = meta(1, self.pad_len, m.unet.context_dim)
            add = (meta(1, m.unet.addition_embed_dim)
                   if m.unet.addition_embed_dim else None)
            denoise(meta(1, size, size, 4), meta(1), ctx, ctx, add, add)

        return costmodel.count_products(walk).scaled(s.num_steps)

    def cost_entries(self) -> List[tuple]:
        """(kind, signature, counter) of the counts this pipeline's own
        config reads: a monolithic image, and a staged request's denoise
        (:func:`costmodel.flops_per_item` keys)."""
        sig = self.cost_signature()
        return [(self.PIPELINE, sig, self.image_products),
                ("staged_denoise", sig, self.staged_denoise_products)]

    def _dispatch_flops(self, variant: SamplerVariant
                        ) -> Optional[costmodel.Products]:
        """One image's products for the variant dispatched (a brownout
        tier's counted by its own signature), or None while it is being
        counted on a thread of its own."""
        return costmodel.dispatch_count(
            self.PIPELINE, self.cost_signature(variant),
            partial(self.image_products, variant))

    # -- staged serving (serving/stages.py) --------------------------------
    def _staged_enabled(self) -> bool:
        """The reference's per-call routing decision: the config's
        ``staged_serving``, minus the kill switch
        CASSMANTLE_NO_STAGED_SERVING, minus meshed (dp/sp) serving, which
        stays monolithic, minus what the slot stepper cannot replay
        (DeepCache's pairs, encprop's segments, eta > 0's noise chain, a
        kind outside ``STAGEABLE_KINDS``)."""
        from cassmantle_tpu_torch.serving.stages import (
            STAGEABLE_KINDS,
            staged_serving_disabled,
        )

        s = self.cfg.sampler
        return (self.cfg.serving.staged_serving
                and not staged_serving_disabled()
                and self.mesh is None
                and not s.deepcache
                and not s.encprop
                and s.eta == 0.0
                and s.kind in STAGEABLE_KINDS)

    def _encode_stage(self, ids: torch.Tensor,
                      uncond_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The encode stage: :meth:`encode_ids` under the reference's key
        names (ctx, uctx; SDXL's add, uadd)."""
        cond = self.encode_ids(ids, uncond_ids)
        out = {"ctx": cond["context"], "uctx": cond["uncond_context"]}
        if cond.get("addition_embeds") is not None:
            out["add"] = cond["addition_embeds"]
            out["uadd"] = cond["uncond_addition_embeds"]
        return out

    def _decode_stage(self, latents: torch.Tensor) -> torch.Tensor:
        """The decode stage: the monolithic path's VAE and uint8 tail."""
        return postprocess_images(self.vae(latents))

    def _staged_server(self):
        """The pipeline's staged server, made on first use."""
        if self._staged is None:
            with self._staged_init_lock:
                if self._staged is None:
                    from cassmantle_tpu_torch.serving.stages import (
                        StagedImageServer,
                    )

                    self._staged = StagedImageServer(
                        self.cfg, self.device,
                        encode_fn=self._encode_stage,
                        decode_fn=self._decode_stage, unet=self.unet,
                        tokenize=self._tokenize_host,
                        vae_scale=self.vae_scale,
                        supervisor=self.supervisor,
                        denoise_cost=("staged_denoise",
                                      self.cost_signature(),
                                      self.staged_denoise_products))
        return self._staged

    def drop_staged(self) -> None:
        """Stop and drop the staged server; the next staged generate
        makes a new one."""
        staged, self._staged = self._staged, None
        if staged is not None:
            try:
                staged.stop()
            except Exception:  # noqa: BLE001 — dropped either way
                log.exception("staged server stop failed")

    def reload_params(self) -> None:
        """The device-loss rebuild: the staged server is stopped and
        dropped (it restarts on the next generate), then every model is
        rebuilt in place (:class:`_ReloadsParams`)."""
        self.drop_staged()
        super().reload_params()

    def generate(self, prompts: Sequence[str], seed: int = 0,
                 latents: Optional[torch.Tensor] = None,
                 deadline_s: Optional[float] = None) -> np.ndarray:
        """prompts -> (B, H, W, 3) uint8 host array. ``latents`` (B, h, w, 4)
        replaces the seeded x_T (the parity tests feed the reference's).
        The device work runs under the dispatch lock; a degenerate
        (constant) frame raises ``OutputInvalid``. The active brownout
        tier (``serving/overload.py::quality_overrides``) serves its own
        variant (:meth:`tier_variant`): its steps, loop and size, through
        its own captured graphs; tier 0 is the untouched path. With
        staged serving enabled (:meth:`_staged_enabled`) and no tier
        engaged, the staged server serves the request instead, honoring
        ``deadline_s`` at step boundaries (the monolithic dispatch is
        all or nothing and ignores it). With a mesh the prompts pad to a
        multiple of dp (:func:`pad_prompts_to_dp`; ``latents`` may cover
        the pad rows too, else theirs are zeros) and the dropped pad
        rows' images stay in ``last_pad_images``."""
        if (self._staged_enabled()
                and self.tier_variant(quality_overrides()) is None):
            out = self._staged_server().generate(
                prompts, seed, deadline_s=deadline_s, latents=latents)
            note_dispatch(self.PIPELINE)
            metrics.inc("pipeline.sdxl_images" if self.PIPELINE == "sdxl"
                        else "pipeline.images", len(out))
            note_consistency_counter(self.full_variant.sampler_cfg, len(out))
            note_w8a8_counter(self.cfg.models, self.full_variant.sampler_cfg,
                              len(out))
            return out
        padded, n = pad_prompts_to_dp(prompts, self.dp)
        with self._dispatch_lock:
            variant = self.tier_variant(quality_overrides())
            per_image = self._dispatch_flops(variant or self.full_variant)
            # the stage span ends when the uint8 batch is on the host (no
            # second sync); attribution counts the variant served (the
            # padded rows too) against the peaks of the cards it ran on,
            # and block_timer reports the dispatch to the device telemetry
            with block_timer(
                    f"pipeline.{self.PIPELINE}_s",
                    flops_est=(per_image.scaled(len(padded))
                               if per_image is not None else None),
                    pipeline=self.PIPELINE, cards=len(self.cards)):
                fault_point("device.lost", peer=self.PIPELINE)
                images = self._generate_locked(padded, seed, latents,
                                               variant)
        self.last_pad_images = images[n:]
        out = integrity.poison(images[:n], peer=self.PIPELINE)
        # the host-side sentinel on the uint8 batch already copied back:
        # the verdict stays out of the captured graphs
        integrity.enforce(np.ones(len(out), dtype=bool),
                          pipeline=self.PIPELINE, stage="sample", images=out)
        served = variant or self.full_variant
        metrics.inc("pipeline.sdxl_images" if self.PIPELINE == "sdxl"
                    else "pipeline.images", len(out))
        if variant is not None:
            metrics.inc("pipeline.brownout_images", len(out))
        note_encprop_counters(served.encprop_counts, len(out))
        note_consistency_counter(served.sampler_cfg, len(out))
        note_w8a8_counter(self.cfg.models, served.sampler_cfg, len(out))
        return out

    def _generate_locked(self, prompts: Sequence[str], seed: int,
                         latents: Optional[torch.Tensor],
                         variant: Optional[SamplerVariant] = None
                         ) -> np.ndarray:
        """CLIP, the denoise and the VAE of ``prompts`` (a multiple of dp),
        each stage launched on every dp position before the cards are
        waited for, so distinct cards overlap; x_T drawn (or given) for
        the whole batch on the first device, each position taking its
        rows."""
        s = (variant or self.full_variant).sampler_cfg
        positions = self._mesh_positions()
        if latents is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            latents = initial_latents(gen, len(prompts), s.image_size,
                                      self.vae_scale, device=self.device)
        latents = latents.to(self.device, torch.float32)
        if len(latents) < len(prompts):
            latents = torch.cat([latents, latents.new_zeros(
                (len(prompts) - len(latents),) + latents.shape[1:])])
        rows = len(prompts) // len(positions)
        parts = [slice(p * rows, (p + 1) * rows)
                 for p in range(len(positions))]
        ids = self._tokenize_host(prompts)
        uncond = self._tokenize_host(
            [self.cfg.sampler.negative_prompt] * len(prompts))
        times = {}
        encode_range, denoise_range, vae_range = self.RANGES
        with torch.inference_mode():
            t0 = time.perf_counter()
            conds = []
            with annotate(encode_range):
                for view, rows_p in zip(positions, parts):
                    with device_scope(view.device):
                        conds.append(view.encode_ids(
                            view._ids_on_device(ids[rows_p]),
                            view._ids_on_device(uncond[rows_p])))
            self._synchronize_cards()
            t1 = time.perf_counter()
            times["clip"] = t1 - t0
            finals = []
            with annotate(denoise_range):
                for view, rows_p, cond in zip(positions, parts, conds):
                    with device_scope(view.device):
                        finals.append(view.denoise(
                            move(latents[rows_p], view.device), cond,
                            variant=variant))
            self._synchronize_cards()
            t2 = time.perf_counter()
            times["denoise"] = t2 - t1
            decoded, images = [], []
            with annotate(vae_range):
                for view, final in zip(positions, finals):
                    with device_scope(view.device):
                        decoded.append(view.vae(final))
                        images.append(postprocess_images(decoded[-1]))
            self.last_decoded_finite = all(
                bool(torch.isfinite(d).all()) for d in decoded)
            self._synchronize_cards()
            times["vae"] = time.perf_counter() - t2
        self.last_stage_seconds = times
        return np.concatenate([im.cpu().numpy() for im in images])

    # -- img2img ----------------------------------------------------------
    def _ensure_encoder(self) -> VAEEncoder:
        """The VAE encoder, built on first use (only img2img needs it):
        from the encoder half of ``vae.safetensors`` in the weights
        directory, ``state_dicts["vae_enc"]`` or the seeded init, fp32
        storage as the decoder's."""
        if self.vae_enc is None:
            self.vae_enc, _ = self._add(
                partial(self._build, partial(VAEEncoder, self.cfg.models.vae),
                        "vae_enc"), "vae_enc", self._vae_enc_state)
        return self.vae_enc

    def img2img_tail(self, x: torch.Tensor, cond: Dict[str, torch.Tensor],
                     k: int, graphed: Optional[bool] = None
                     ) -> torch.Tensor:
        """The last ``k`` steps of the configured kind's schedule from the
        prepared state ``x`` under ``cond``: DDIM, Euler (k-space,
        prescaled) or DPM++ (first order at its first step). On CUDA
        (``graphed`` None or True) one captured step graph per (k,
        latent shape), captured on first use, as the reference jits per
        k and shape."""
        s = self.cfg.sampler
        _, schedule = img2img_start(s.kind, s.num_steps, s.num_steps - k)
        inputs = cfg_inputs(**cond)
        make = partial(cfg_denoiser, self.unet,
                       guidance_scale=s.guidance_scale)
        if graphed is None:
            graphed = self.device.type == "cuda"
        if not graphed:
            return sample_spec(schedule.spec(x), make(**inputs), x)
        key = (k, tuple(x.shape))
        graph = self.img2img_graphs.get(key)
        if graph is None:
            graph = SpecGraph(make, schedule, x, **inputs)
            self.img2img_graphs[key] = graph
        return graph(x, **inputs)

    def generate_img2img(self, images: np.ndarray, prompts: Sequence[str],
                         strength: float = 0.6, seed: int = 0,
                         graphed: Optional[bool] = None) -> np.ndarray:
        """Image-conditioned generation: (B, H, W, 3) uint8 images and
        prompts -> (B, H, W, 3) uint8. The VAE encoder's sample of the
        images is noised to schedule step ``num_steps - k``, k =
        round(strength * num_steps) clamped to [1, num_steps], and the
        last k steps of the configured sampler denoise it, as the
        reference's ``generate_img2img``: its keys ``split(PRNGKey(seed))``
        (the encoder's sample, the noise) drawn as ``jax.random`` draws
        them. DeepCache, encprop and consistency configs are refused, as
        the reference refuses them; so is DDIM at eta > 0. The device work
        runs under the dispatch lock; a degenerate frame raises
        ``OutputInvalid``."""
        if not 0.0 < strength <= 1.0:
            raise AssertionError(f"strength {strength} outside (0, 1]")
        s = self.cfg.sampler
        if s.deepcache:
            raise NotImplementedError(
                "img2img does not support deepcache (schedule tails have "
                "arbitrary parity); use a non-deepcache config for "
                "image-conditioned generation")
        if s.encprop:
            raise NotImplementedError(
                "img2img does not support encoder propagation (strength "
                "tails start mid-schedule, where the dense-prefix key "
                "accounting no longer holds); use a non-encprop config "
                "for image-conditioned generation")
        if s.consistency:
            raise NotImplementedError(
                "img2img does not support the few-step consistency "
                "sampler (the student is trained to map noise states on "
                "the schedule, not arbitrary strength tails); use a "
                "non-consistency config for image-conditioned generation")
        check_eta(s)
        with self._dispatch_lock, block_timer("pipeline.i2i_s"):
            out = self._img2img_locked(images, prompts, strength, seed,
                                       graphed)
        integrity.enforce(np.ones(len(out), dtype=bool),
                          pipeline=self.PIPELINE, stage="img2img",
                          images=out)
        metrics.inc("pipeline.images", len(out))
        return out

    def _img2img_locked(self, images: np.ndarray, prompts: Sequence[str],
                        strength: float, seed: int,
                        graphed: Optional[bool]) -> np.ndarray:
        s = self.cfg.sampler
        encoder = self._ensure_encoder()
        steps = s.num_steps
        k = max(1, min(steps, int(round(strength * steps))))
        prepare, _ = img2img_start(s.kind, steps, steps - k)
        times = {}
        with torch.inference_mode():
            t0 = time.perf_counter()
            pixels = torch.from_numpy(np.asarray(images, dtype=np.uint8)).to(
                self.device).float()
            imgf = pixels / pixels.new_full((), 127.5) - 1.0
            cond = self.encode(prompts)
            rng_enc, rng_noise = jax_random.split(
                jax_random.PRNGKey(seed, self.device))
            lat0 = encoder(imgf, rng_enc)
            x = prepare(lat0, jax_random.normal(rng_noise, lat0.shape))
            synchronize(self.device)
            t1 = time.perf_counter()
            times["encode"] = t1 - t0
            final = self.img2img_tail(x, cond, k, graphed)
            synchronize(self.device)
            t2 = time.perf_counter()
            times["denoise"] = t2 - t1
            decoded = self.vae(final)
            out = postprocess_images(decoded)
            self.last_decoded_finite = bool(torch.isfinite(decoded).all())
            synchronize(self.device)
            times["vae"] = time.perf_counter() - t2
        self.last_stage_seconds = times
        return out.cpu().numpy()


class PromptGenerator(_ReloadsParams):
    """Story-episode text: bucketed decode of the prompt LM, GPT-2 or, when
    ``cfg.models.mistral`` is set, Mistral-7B. Greedy at
    ``text_temperature`` 0, else top-``text_top_k`` sampled with a seed
    that advances per call; greedy decodes run speculatively under
    ``cfg.spec_decode`` (same tokens). Under ``lm_int8`` the LM's large
    weights are int8 (quantized on the host before placement, or read
    from ``<family>.int8.safetensors``), each dequantized in its layer's
    forward."""

    PROMPT_BUCKETS = (32, 64, 128, 256)
    BATCH_BUCKETS = (1, 2, 4, 8)
    PIPELINE = "prompt"

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dict: Optional[Mapping] = None,
                 draft_state_dict: Optional[Mapping] = None,
                 weights_dir: Optional[str] = None):
        models = cfg.models
        _require(not (models.lm_int8 and models.lm_w8a8),
                 "lm_w8a8 and lm_int8 are mutually exclusive: both rewrite "
                 "the same kernel leaves")
        self.cfg = cfg
        self.device = resolve_device(device)
        # serializes the decodes: their graphs replay over static KV
        # caches and token buffers
        self._dispatch_lock = OrderedLock("pipeline.prompt_dispatch",
                                          rank=12)
        param_dtype = torch_dtype(models.param_dtype)
        self.weights_dir = weights_dir
        self._rebuilds = Rebuilds()
        t0 = time.perf_counter()
        if models.mistral is not None:
            if lm_w8a8_armed(models):
                raise NotImplementedError(
                    "lm_w8a8 with Mistral: its projections are plain Dense "
                    "layers in the reference, with no int8 site")
            self.mcfg = m = models.mistral
            kind = "mistral"
            build = partial(build_streamed, partial(MistralLM, m), kind,
                            self.device, cfg.seed,
                            storage_dtype=param_dtype,
                            quantize=int8_modules if models.lm_int8 else None)
            quant = None
        elif models.lm_int8:
            self.mcfg = m = models.gpt2
            kind = "gpt2"
            build = partial(build_streamed, partial(GPT2LM, m), kind,
                            self.device, cfg.seed,
                            storage_dtype=param_dtype, quantize=int8_modules)
            quant = None
        else:
            self.mcfg = m = models.gpt2
            kind = "gpt2"

            def build(weights: Optional[Mapping]) -> GPT2LM:
                with torch.device(self.device):
                    model = build_model(GPT2LM(m), kind, self.device,
                                        cfg.seed, weights, param_dtype)
                if lm_w8a8_armed(models):
                    # no static scales: the LM quantizes activations per
                    # token
                    w8a8_modules(model, predicate=partial(
                        w8a8_default_predicate,
                        min_size=models.w8a8_min_size))
                return model

            quant = param_dtype if lm_w8a8_armed(models) else None
        self.kind = kind
        self._int8_path = (os.path.join(weights_dir, f"{kind}.int8.safetensors")
                           if weights_dir else None)
        int8_state = (self._load_int8_checkpoint(kind)
                      if models.lm_int8 and state_dict is None else None)
        # whether the int8 weights came from <family>.int8.safetensors
        self.int8_from_file = int8_state is not None
        if int8_state is not None:
            # the quantized file straight from disk; it counts as real
            # weights only beside its fp source (quantize-weights writes
            # one from the seeded init when no fp file exists)
            self.model = self._rebuilds.add(partial(build, int8_state))
            self.loaded_real_weights = bool(checkpoint_paths(
                weights_dir, CHECKPOINT_FILES[kind]))
        else:
            # mistral.safetensors or its shards, or gpt2.safetensors
            self.model, self.loaded_real_weights = add_model(
                self._rebuilds, build, kind, weights_dir,
                CHECKPOINT_FILES[kind], converter_for(kind, models),
                state_dict, quant)
        if quant is not None:
            log.info("lm_w8a8: int8 W8A8 matmuls at %d sites (per-token "
                     "activation scales)", w8a8_site_count(self.model))
        synchronize(self.device)
        # host seconds of building the LM, and its tensors' bytes (int8
        # weights at one byte)
        self.build_seconds = time.perf_counter() - t0
        self.param_bytes = tree_nbytes(self.model)
        if models.lm_int8:
            log.info("lm_int8: serving %.2f GB, %d int8 weights",
                     self.param_bytes / 1e9, int8_site_count(self.model))
        self.tokenizer = load_tokenizer(kind, m.vocab_size, weights_dir)
        self.last_seconds = 0.0
        # the sampling seed of the next call that gives none
        self._decode_calls = 0
        # decode states and their captured step or chunk (CUDA), per
        # decode shape, made on first use
        self.decode_graphs: Dict[tuple, GreedyDecodeState] = {}
        self.spec_graphs: Dict[tuple, SpecDecodeState] = {}
        # (seed texts, max_new, seed, graphed) of the last decode
        self._last_call: Optional[tuple] = None
        self._init_spec_decode(cfg, draft_state_dict, param_dtype)
        # the cost model: the LM's meta twin (made at the first count)
        # and, per thread, the products of that thread's last decode (a
        # decode that raised attributes nothing)
        self._meta_twin = None
        self._decode_flops_tls = threading.local()

    def _load_int8_checkpoint(self, name: str) -> Optional[Dict]:
        """The port ``state_dict`` of ``<name>.int8.safetensors``, or None
        (the fp path) when the file is absent, older than the fp
        checkpoint (re-fetched weights not re-quantized), or unloadable."""
        path = self._int8_path
        if not (path and os.path.exists(path)):
            return None
        fp_path = os.path.join(self.weights_dir, f"{name}.safetensors")
        if (os.path.exists(fp_path)
                and os.path.getmtime(fp_path) > os.path.getmtime(path)):
            log.warning("%s is older than %s; re-quantizing from the fp "
                        "checkpoint (run quantize-weights to refresh)",
                        path, fp_path)
            return None
        log.info("%s: loading quantized %s", name, path)
        try:
            return state_dict_from_tree(load_quantized(path))
        except Exception:
            # the reference's load-time degrade: the fp path serves, and
            # the log says to re-quantize
            log.exception("quantized checkpoint %s failed to load (model "
                          "config changed since quantization?); falling "
                          "back to the fp path", path)
            return None

    def save_quantized(self, path: Optional[str] = None) -> str:
        """Write the int8 LM as ``<family>.int8.safetensors`` (default: in
        the weights directory, where a later ``lm_int8`` build reads it)
        in the reference's format; returns the path."""
        _require(self.cfg.models.lm_int8, "construct with lm_int8=True first")
        path = path or self._int8_path
        _require(bool(path), "no weights_dir: pass an explicit path")
        from cassmantle_tpu_torch.ops.quant import save_quantized

        save_quantized(self.model, path)
        return path

    def _init_spec_decode(self, cfg: FrameworkConfig,
                          draft_state_dict: Optional[Mapping],
                          param_dtype: torch.dtype) -> None:
        """The draft of speculative decode (``spec_draft``, None when off):
        an :class:`NgramDraft`, or a :class:`ModelDraft` over a GPT-2 with
        the target's vocabulary (the target itself when the draft config
        is the target's GPT-2 config). The counts of the last speculative
        decode land in ``last_spec_stats``."""
        spec = cfg.spec_decode
        self.spec_draft = None
        self.last_spec_stats: Optional[dict] = None
        if spec.mode == "off":
            return
        if spec.mode == "ngram":
            self.spec_draft = NgramDraft(ngram=spec.ngram)
            return
        if spec.mode != "draft_model":
            raise ValueError(f"unknown spec_decode.mode {spec.mode!r}")
        d = spec.draft_model
        if d is None:
            raise ValueError("spec_decode.mode='draft_model' needs a "
                             "draft_model config")
        if d.vocab_size != self.mcfg.vocab_size:
            raise ValueError(
                f"the draft and the target must share a vocabulary "
                f"({d.vocab_size} vs {self.mcfg.vocab_size}): acceptance "
                f"compares token ids")
        if cfg.models.mistral is None and d == cfg.models.gpt2:
            self.spec_draft = ModelDraft(self.model)
            return

        def draft(weights: Optional[Mapping]) -> GPT2LM:
            with torch.device(self.device):
                return build_model(GPT2LM(d), "gpt2_draft", self.device,
                                   cfg.seed, weights, param_dtype)

        model, _ = add_model(
            self._rebuilds, draft, "gpt2_draft", self.weights_dir,
            "gpt2_draft.safetensors",
            lambda t: convert_gpt2(t, d.num_layers, d.hidden_size),
            draft_state_dict)
        self.spec_draft = ModelDraft(model)

    @classmethod
    def shape_twin(cls, cfg: FrameworkConfig) -> "PromptGenerator":
        """A generator of ``cfg`` with no model: :meth:`row_products` at
        any width without building the LM."""
        twin = cls.__new__(cls)
        twin.cfg = cfg
        twin.mcfg = (cfg.models.mistral if cfg.models.mistral is not None
                     else cfg.models.gpt2)
        twin._meta_twin = None
        return twin

    def _meta_lm(self) -> torch.nn.Module:
        """The LM's twin on the meta device (W8A8 sites when armed)."""
        if self._meta_twin is None:
            if self.cfg.models.mistral is not None:
                twin = costmodel.meta_module(partial(MistralLM, self.mcfg))
            else:
                twin = costmodel.meta_module(partial(GPT2LM, self.mcfg))
                if lm_w8a8_armed(self.cfg.models):
                    w8a8_modules(twin, predicate=partial(
                        w8a8_default_predicate,
                        min_size=self.cfg.models.w8a8_min_size))
            self._meta_twin = twin
        return self._meta_twin

    def row_products(self, bucket: int, max_new: int) -> costmodel.Products:
        """One row's decode at prompt bucket ``bucket``: the prefill, then
        ``max_new - 1`` cached steps, each attending over the whole static
        cache as the device does (the last token needs no step). Walked on
        the meta twin; speculative decode is counted as this greedy
        budget."""
        model = self._meta_lm()
        max_len = bucket + max_new
        cache = model.new_cache(1, max_len, "meta")

        def prefill(counter) -> None:
            ids = torch.zeros((1, bucket), dtype=torch.long, device="meta")
            lens = torch.full((1,), bucket, dtype=torch.long, device="meta")
            model.prefill(ids, lens, max_len, cache)

        def step(counter) -> None:
            token = torch.zeros((1,), dtype=torch.int32, device="meta")
            index = torch.full((1,), bucket, dtype=torch.long,
                               device="meta")
            valid = torch.ones((1, max_len), dtype=torch.bool,
                               device="meta")
            model.decode_step(token, index, cache, valid)

        return costmodel.count_products(prefill) + costmodel.count_products(
            step).scaled(max_new - 1)

    def cost_entries(self, bucket: int, max_new: int) -> List[tuple]:
        """(kind, signature, counter) of one row's decode at ``bucket``
        and ``max_new`` (:func:`costmodel.flops_per_item` keys)."""
        sig = costmodel.lm_signature(self.mcfg,
                                     lm_w8a8_armed(self.cfg.models))
        return [(self.PIPELINE, f"{sig}:{bucket}:{max_new}",
                 partial(self.row_products, bucket, max_new))]

    def _group_products(self, n_pad: int, bucket: int, max_new: int
                        ) -> Optional[costmodel.Products]:
        row = costmodel.dispatch_count(*self.cost_entries(bucket,
                                                          max_new)[0])
        return None if row is None else row.scaled(n_pad)

    def _spec_enabled(self, bucket: int, max_new: int) -> bool:
        """Per bucket group: speculative decode serves greedy decodes only,
        only while the chunk's scratch tail fits the position table, and
        only with CASSMANTLE_NO_SPEC_DECODE (read here) clear."""
        if self.spec_draft is None:
            return False
        if self.cfg.sampler.text_temperature > 0.0:
            return False
        if os.environ.get("CASSMANTLE_NO_SPEC_DECODE", "").lower() \
                not in ("", "0", "false", "no", "off"):
            return False
        gamma = self.cfg.spec_decode.gamma
        return bucket + max_new + gamma + 1 <= self.mcfg.max_positions

    def _bucket_for(self, n_tokens: int, max_new: int, limit: int) -> int:
        return next(
            (b for b in self.PROMPT_BUCKETS
             if n_tokens <= b and b + max_new <= self.mcfg.max_positions),
            limit)

    def decode_ids_batch(self, seed_texts: Sequence[str],
                         max_new_tokens: Optional[int] = None,
                         seed: Optional[int] = None,
                         graphed: Optional[bool] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """N seed texts -> (tokens (N, max_new), gen_len (N,)) host arrays.
        Rows group by their own prompt bucket (so a row decodes at the
        same positions whatever it is batched with); each group's batch
        pads to the next BATCH_BUCKETS size with 1-token dummy rows. A
        sampled decode draws from a generator seeded with ``seed`` (None:
        a count of calls, so sampled text varies from call to call). On
        CUDA (``graphed`` None or True) each group's decode replays the
        captured step (or speculative chunk) of its shape, captured on
        first use; ``graphed=False`` runs the same steps eagerly. Each
        group decodes under the dispatch lock."""
        tokens, lengths, _ = self._decode(seed_texts, max_new_tokens, seed,
                                          graphed)
        return tokens, lengths

    def _decode(self, seed_texts: Sequence[str],
                max_new_tokens: Optional[int], seed: Optional[int],
                graphed: Optional[bool]
                ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
        """:meth:`decode_ids_batch`, and the rows whose tokens fall outside
        the vocabulary (the integrity sentinel)."""
        if not seed_texts:
            raise ValueError("decode_ids_batch needs at least one prompt")
        m = self.mcfg
        s = self.cfg.sampler
        max_new = max_new_tokens or s.max_new_tokens
        limit = m.max_positions - max_new - 1
        rows = []
        for text in seed_texts:
            toks = self.tokenizer.encode(text)
            rows.append(toks[-limit:] if len(toks) > limit else toks)
        if seed is None:
            seed = self._decode_calls
            self._decode_calls += 1
        groups: Dict[int, List[int]] = {}
        for i, toks in enumerate(rows):
            groups.setdefault(self._bucket_for(len(toks), max_new, limit),
                              []).append(i)
        out_tokens = np.zeros((len(rows), max_new), dtype=np.int32)
        out_len = np.zeros((len(rows),), dtype=np.int32)
        # an out-of-vocab eos (byte tokenizer vs a smaller model vocab) can
        # never be emitted: vocab_size is an unreachable sentinel
        eos = (self.tokenizer.eos_id if self.tokenizer.eos_id < m.vocab_size
               else m.vocab_size)
        spec_stats = []
        bad_members = set()
        dispatch = costmodel.Products()
        self._decode_flops_tls.value = None
        for bucket, idxs in groups.items():
            n = len(idxs)
            n_pad = next((b for b in self.BATCH_BUCKETS if n <= b), n)
            ids = np.full((n_pad, bucket), self.tokenizer.pad_id % m.vocab_size,
                          dtype=np.int64)
            lens = np.ones((n_pad,), dtype=np.int64)
            for row, src in enumerate(idxs):
                toks = rows[src]
                ids[row, : len(toks)] = np.asarray(toks) % m.vocab_size
                lens[row] = max(1, len(toks))
            group = self._group_products(n_pad, bucket, max_new)
            if group is not None:
                dispatch = dispatch + group
            # a speculative group's draft and verify, timed until its
            # tokens are on the host
            timer = (block_timer("decode.verify_s")
                     if self._spec_enabled(bucket, max_new)
                     else contextlib.nullcontext())
            with self._dispatch_lock, timer:
                fault_point("device.lost", peer=self.PIPELINE)
                tokens, gen_len = self._decode_group(
                    ids, lens, n, bucket, max_new, eos, seed, graphed,
                    spec_stats)
                # copied out under the lock: a graph's output buffers are
                # the next replay's
                tokens = tokens[:n].cpu().numpy()
                gen_len = gen_len[:n].cpu().numpy()
            toks_host = integrity.poison(tokens, peer=self.PIPELINE)
            if not integrity.integrity_disabled():
                # tokens are ints: their range is the sentinel (garbage
                # buffers and the chaos poison's -1 fall outside it)
                ok = ((toks_host >= 0)
                      & (toks_host < m.vocab_size)).all(axis=1)
                bad_members.update(idxs[row]
                                   for row in np.nonzero(~ok)[0])
            out_tokens[idxs] = toks_host
            out_len[idxs] = gen_len
        self._record_spec_stats(spec_stats)
        self._last_call = (list(seed_texts), max_new, seed, graphed)
        self._decode_flops_tls.value = dispatch
        return out_tokens, out_len, tuple(sorted(bad_members))

    def replay_last_decode(self) -> bool:
        """The last decode again, at its shapes and seed: on CUDA, replays
        of the graphs it captured (the recovery warm). False when nothing
        was decoded yet."""
        if self._last_call is None:
            return False
        self._decode(*self._last_call)
        return True

    def _decode_group(self, ids: np.ndarray, lens: np.ndarray, n: int,
                      bucket: int, max_new: int, eos: int, seed: int,
                      graphed: Optional[bool],
                      spec_stats: List[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One bucket group's decode on the device (under the lock)."""
        s = self.cfg.sampler
        n_pad = ids.shape[0]
        ids_t = torch.from_numpy(ids).to(self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        with torch.inference_mode():
            if self._spec_enabled(bucket, max_new):
                # the pad rows never hold back the lockstep commit
                row_mask = torch.from_numpy(np.arange(n_pad) < n)
                tokens, gen_len, stats = speculative_decode(
                    self.model, ids_t, lens_t, max_new, eos,
                    self.cfg.spec_decode.gamma, self.spec_draft,
                    row_mask.to(self.device), graphs=self.spec_graphs,
                    graphed=graphed)
                spec_stats.append(stats.clone())
                return tokens, gen_len
            gen = None
            if s.text_temperature > 0.0:
                gen = torch.Generator(self.device).manual_seed(seed)
            return greedy_decode(
                self.model, ids_t, lens_t, max_new, eos,
                graphs=self.decode_graphs, graphed=graphed,
                temperature=s.text_temperature, top_k=s.text_top_k,
                generator=gen)

    def _record_spec_stats(self, spec_stats: List[torch.Tensor]) -> None:
        """One host transfer of the decode's speculative counts, after its
        groups: chunks (verify forwards), drafted and accepted tokens."""
        if not spec_stats:
            return
        chunks, drafted, accepted = torch.stack(spec_stats).sum(
            dim=0).tolist()
        self.last_spec_stats = {
            "chunks": chunks, "drafted": drafted, "accepted": accepted,
            "accept_rate": (accepted / drafted) if drafted else 0.0}
        metrics.inc("decode.spec_chunks", chunks)
        if drafted:
            metrics.gauge("decode.spec_accept_rate", accepted / drafted)

    def generate_batch(self, seed_texts: Sequence[str],
                       max_new_tokens: Optional[int] = None) -> List:
        """Continuations, each trimmed to two sentences. A row the
        integrity sentinel rejected comes back as an ``OutputInvalid``
        instance in its slot (not raised): the prompt queue fails that
        request alone while the batch's other rows serve."""
        t0 = time.perf_counter()
        # the products are known once the rows are grouped into buckets:
        # read at exit, on this thread
        with block_timer("pipeline.prompt_s", flops_est=lambda: getattr(
                self._decode_flops_tls, "value", None),
                pipeline=self.PIPELINE):
            tokens, lengths, bad = self._decode(seed_texts, max_new_tokens,
                                                None, None)
        self.last_seconds = time.perf_counter() - t0
        if bad:
            integrity.note_invalid(self.PIPELINE, "decode", sorted(bad))
        return [integrity.OutputInvalid(self.PIPELINE, "decode", [i])
                if i in bad else
                two_sentences(self.tokenizer.decode(
                    tokens[i, : lengths[i]].tolist()))
                for i in range(len(seed_texts))]

    def generate(self, seed_text: str,
                 max_new_tokens: Optional[int] = None) -> str:
        """One continuation; raises ``OutputInvalid`` when the sentinel
        rejects the row."""
        out = self.generate_batch([seed_text], max_new_tokens)[0]
        if isinstance(out, Exception):
            raise out
        return out


class TorchContentBackend:
    """Prompt-LM episode text + diffusion image: one round's content. The image
    comes from :class:`SDXLPipeline` when the config has a second text
    tower, else from :class:`Text2ImagePipeline`, over ``mesh`` when one
    is given (the prompt LM serves on the mesh's first device). ``t2i``:
    a caller-owned image pipeline instead (the reference's argument: one
    already built for this mesh). ``weights_dir``: the checkpoints and
    vocabularies every model loads from (absent files: the seeded
    init)."""

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 styles: Optional[List[str]] = None,
                 rng: Optional[random.Random] = None,
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 weights_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None,
                 t2i: Optional[Text2ImagePipeline] = None):
        sd = state_dicts or {}
        self.cfg = cfg
        if t2i is not None:
            self.t2i = t2i
        elif cfg.models.clip_text_2 is not None:
            # serving/sdxl.py builds on this module
            from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

            self.t2i = SDXLPipeline(cfg, device, state_dicts=sd,
                                    weights_dir=weights_dir, mesh=mesh)
        else:
            self.t2i = Text2ImagePipeline(cfg, device, state_dicts=sd,
                                          weights_dir=weights_dir, mesh=mesh)
        if mesh is not None:
            device = mesh.home
        lm = "gpt2" if cfg.models.mistral is None else "mistral"
        self.prompt_gen = PromptGenerator(cfg, device, sd.get(lm),
                                          sd.get("gpt2_draft"), weights_dir)
        self.styles = styles or load_styles()
        self.rng = rng or random.Random(cfg.seed)
        self._round = 0
        self.text_fallbacks = 0
        # concurrent rounds draw their style and image seed one at a time
        self._draw_lock = threading.Lock()

    def _style_prompt(self, prompt: str) -> str:
        style = self.rng.choice(self.styles)
        return f"A {style.lower()} style piece depicting: {prompt}"

    def generate_sync(self, seed: str, is_seed: bool = True,
                      text: Optional[str] = None) -> RoundContent:
        """``text`` injects an already-decoded continuation (the service's
        prompt queue batches decodes across concurrent rounds); None
        decodes here. Degenerate text (fewer words than the round masks,
        plus one) falls back to the deterministic template. The round's
        style and image seed are drawn in call order (``rng``,
        ``_round``) and returned with the content."""
        if text is None:
            text = self.prompt_gen.generate(seed)
        text = sanitize_text(text)
        wordy = sum(is_wordlike(t) for t in tokenize_words(text))
        if wordy < self.cfg.game.num_masked + 1:
            # degenerate LM output (random weights): keep the round
            # playable with the deterministic template text
            log.warning("degenerate generated text; using template fallback")
            self.text_fallbacks += 1
            metrics.inc("pipeline.text_fallbacks")
            text = template_text(seed)
        with self._draw_lock:
            self._round += 1
            image_seed = self._round
            prompt = self._style_prompt(text)
        images = self.t2i.generate([prompt], seed=image_seed)
        return RoundContent(prompt_text=text, image=images[0],
                            image_prompt=prompt, image_seed=image_seed)

    async def generate(self, seed: str, is_seed: bool = True,
                       text: Optional[str] = None) -> RoundContent:
        """:meth:`generate_sync` in the event loop's default executor,
        with the caller's context copied onto the worker thread (the
        reference's ``TPUContentBackend.generate``)."""
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            None, ctx.run, self.generate_sync, seed, is_seed, text)
