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
build, from their bf16 weights (``w8a8_unet_tools``, ``lm_w8a8_armed``).
A config with a second text tower (``sdxl_config()``) makes the backend
serve its image with ``serving/sdxl.py::SDXLPipeline``, as the reference's
``TPUContentBackend`` does. Staged serving and brownout tiers are later
slices.

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
import contextvars
import dataclasses
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
)
from cassmantle_tpu_torch.models.vae import (
    VAEDecoder,
    VAEEncoder,
    postprocess_images,
)
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
from cassmantle_tpu_torch.serving import integrity
from cassmantle_tpu_torch.utils import jax_random
from cassmantle_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    synchronize,
    torch_dtype,
)
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.text import (
    is_wordlike,
    load_styles,
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


def w8a8_unet_tools(models_cfg) -> Optional[Callable[[torch.nn.Module], int]]:
    """The UNet's W8A8 transform (quantize every site of a built UNet in
    place, with dynamic activation scales; returns the site count), or
    None when W8A8 is off. Weights-only int8 (``unet_int8``) is not
    ported: it raises here, with or without W8A8."""
    if models_cfg.unet_int8:
        raise ValueError("unet_int8 (weights-only int8) is not ported, and "
                         "unet_w8a8 and unet_int8 are mutually exclusive: "
                         "both rewrite the same kernel leaves")
    if not unet_w8a8_armed(models_cfg):
        return None
    if not models_cfg.unet.fused_conv:
        raise ValueError("unet_w8a8 conv sites ride the fused GN+SiLU+conv "
                         "path; set models.unet.fused_conv=True")
    pred = partial(w8a8_default_predicate, min_size=models_cfg.w8a8_min_size)
    return partial(w8a8_modules, predicate=pred)


def build_model(module: torch.nn.Module, kind: str, device: torch.device,
                seed: int, state_dict: Optional[Mapping] = None,
                storage_dtype: Optional[torch.dtype] = None
                ) -> torch.nn.Module:
    """Fill ``module`` (already on ``device``) from ``state_dict`` (a dict
    or a checkpoint's :class:`Converted` plan, copied tensor by tensor) or
    a seeded random init, then store its parameters in ``storage_dtype``."""
    if state_dict is not None:
        fill_(module, state_dict)
    else:
        gen = torch.Generator(device).manual_seed(seed + INIT_SEEDS[kind])
        init_weights(module, gen)
    if storage_dtype is not None:
        module.to(storage_dtype)
    return module.eval()


def build_streamed(factory: Callable[[], torch.nn.Module], kind: str,
                   device: torch.device, seed: int,
                   state_dict: Optional[Mapping] = None,
                   storage_dtype: Optional[torch.dtype] = None
                   ) -> torch.nn.Module:
    """:func:`build_model` for a model too large to hold in fp32 beside its
    stored copy (Mistral-7B: 29 GB in fp32, 14.5 GB in bf16). The module
    is made on the meta device, then each top-level submodule in turn is
    made on ``device`` in fp32, filled from ``state_dict`` or the seeded
    init (in build_model's order) and cast to ``storage_dtype``: the peak
    is the stored footprint plus one submodule in fp32. The module may
    hold no parameter or buffer of its own. A checkpoint's
    :class:`Converted` plan converts each submodule's tensors as it is
    filled, from the mapped file."""
    with torch.device("meta"):
        module = factory()
    if (next(module.parameters(recurse=False), None) is not None
            or next(module.buffers(), None) is not None):
        raise ValueError("build_streamed fills submodule parameters only")
    gen = (None if state_dict is not None else
           torch.Generator(device).manual_seed(seed + INIT_SEEDS[kind]))
    for name, child in module.named_children():
        child.to_empty(device=device)
        if gen is not None:
            init_weights(child, gen)
        else:
            prefix = f"{name}."
            fill_(child, {k[len(prefix):]: state_dict[k]
                          for k in state_dict if k.startswith(prefix)})
        if storage_dtype is not None:
            child.to(storage_dtype)
    if state_dict is not None:
        unexpected = set(state_dict) - set(module.state_dict())
        if unexpected:
            raise ValueError(f"unexpected keys {sorted(unexpected)}")
    return module.eval()


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


def check_eta(sampler_cfg) -> None:
    """DDIM at eta > 0 needs a step key, and the reference's pipelines
    call their sampler without one: its error."""
    if sampler_cfg.kind == "ddim" and sampler_cfg.eta > 0.0:
        raise ValueError("eta > 0 requires an rng key")


class _ReloadsParams:
    """The device-loss rebuild of a pipeline with a ``_dispatch_lock``: it
    builds what it serves through ``self._rebuilds``, whose recipes run
    again into the same tensors under the lock, so the captured graphs
    keep their buffers and stay valid."""

    _rebuilds: Rebuilds

    def param_tensors(self) -> List[torch.Tensor]:
        """The parameters and buffers the pipeline serves from."""
        return self._rebuilds.tensors()

    def reload_params(self) -> None:
        """Raises on a context an error left unusable (a sticky CUDA
        error)."""
        with self._dispatch_lock:
            self._rebuilds.reload()
            synchronize(self.device)


class Text2ImagePipeline(_ReloadsParams):
    """prompts -> (B, H, W, 3) uint8 images: CLIP -> the CFG sampler loop
    -> VAE; and images + prompts -> images (:meth:`generate_img2img`)."""

    # the name its fault points, integrity verdicts and lock carry
    PIPELINE = "t2i"
    LOCK_RANK = 10
    # the checkpoint kinds of its UNet and VAE decoder (models/weights.py)
    UNET_KIND, VAE_KIND = "unet", "vae"

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 weights_dir: Optional[str] = None):
        self.sampler_mode = sampler_mode(cfg.sampler)
        # the config served: the teacher's under the consistency kill switch
        self.sampler_cfg = effective_sampler_cfg(cfg.sampler)
        w8a8 = w8a8_unet_tools(cfg.models)
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self._rebuilds = Rebuilds()

        def unet(weights: Optional[Mapping]) -> UNet:
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
        for part in (m.unet, m.vae):
            if fc_describe(part):
                log.info("%s", fc_describe(part))
        if w8a8 is not None:
            log.info("%s", w8a8_describe(w8a8_calibrated(self.unet),
                                         w8a8_site_count(self.unet)))
        # SDXL's two towers share the CLIP vocabulary and one tokenization
        self.tokenizer = load_tokenizer("clip", m.clip_text.vocab_size,
                                        weights_dir)
        self.pad_len = min([cfg.sampler.prompt_pad_len] + [
            t.max_positions for t in (m.clip_text, m.clip_text_2)
            if t is not None])
        # pixels per latent: one 2x upsample per VAE level transition
        self.vae_scale = 2 ** (len(m.vae.channel_mults) - 1)
        s = self.sampler_cfg
        self.schedule = make_schedule(s.kind, s.num_steps, s.consistency,
                                      s.consistency_teacher_steps)
        # (key, shallow, propagated) UNet forwards of a trajectory when
        # encoder propagation serves, else None
        self.encprop_counts = (
            encprop_step_counts(s.num_steps, s.encprop_stride,
                                s.encprop_dense_steps, s.deepcache)
            if self.sampler_mode == "encprop" else None)
        # the captured loop of each batch size (CUDA), made on first use:
        # by sampler_mode, a SpecGraph, SpecDeepCacheGraph or EncpropGraph
        self.step_graphs: Dict[int, SamplerGraph] = {}
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

    def _tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = tokenize_clip_prompts(self.tokenizer, prompts, self.pad_len,
                                    self.cfg.models.clip_text.vocab_size)
        return torch.from_numpy(ids).long().to(self.device)

    def encode(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The CFG conditioning of ``prompts`` and the negative prompt, as
        :func:`cfg_inputs`'s keyword arguments."""
        ids = self._tokenize(prompts)
        uncond_ids = self._tokenize(
            [self.cfg.sampler.negative_prompt] * len(prompts))
        return {"context": self.clip(ids)["hidden"],
                "uncond_context": self.clip(uncond_ids)["hidden"]}

    def denoise(self, latents: torch.Tensor, cond: Dict[str, torch.Tensor],
                graphed: Optional[bool] = None) -> torch.Tensor:
        """The CFG sampler steps from x_T under ``cond`` (:meth:`encode`'s
        output) -> the final latents, the denoise stage both pipelines
        share (the reference's ``run_cfg_denoise``), by ``sampler_mode``:
        consistency, encoder propagation, DeepCache pairs, or the kind's
        plain loop. ``graphed`` (default: on CUDA) replays the captured
        loop of this batch size, captured on first use, as the reference
        jits its sampler per batch; a capture failure raises.
        ``graphed=False`` runs the same steps eagerly."""
        s = self.sampler_cfg
        check_eta(s)
        inputs = cfg_inputs(**cond)
        gs = s.guidance_scale
        mode = self.sampler_mode
        schedule = self.schedule
        if graphed is None:
            graphed = self.device.type == "cuda"
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
        graph = self.step_graphs.get(latents.shape[0])
        if graph is None:
            graph = build(**inputs)
            self.step_graphs[latents.shape[0]] = graph
        return graph(latents, **inputs)

    def generate(self, prompts: Sequence[str], seed: int = 0,
                 latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """prompts -> (B, H, W, 3) uint8 host array. ``latents`` (B, h, w, 4)
        replaces the seeded x_T (the parity tests feed the reference's).
        The device work runs under the dispatch lock; a degenerate
        (constant) frame raises ``OutputInvalid``."""
        with self._dispatch_lock:
            fault_point("device.lost", peer=self.PIPELINE)
            images = self._generate_locked(prompts, seed, latents)
        out = integrity.poison(images, peer=self.PIPELINE)
        # the host-side sentinel on the uint8 batch already copied back:
        # the verdict stays out of the captured graphs
        integrity.enforce(np.ones(len(out), dtype=bool),
                          pipeline=self.PIPELINE, stage="sample", images=out)
        return out

    def _generate_locked(self, prompts: Sequence[str], seed: int,
                         latents: Optional[torch.Tensor]) -> np.ndarray:
        s = self.cfg.sampler
        if latents is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            latents = initial_latents(gen, len(prompts), s.image_size,
                                      self.vae_scale, device=self.device)
        latents = latents.to(self.device, torch.float32)
        times = {}
        with torch.inference_mode():
            t0 = time.perf_counter()
            cond = self.encode(prompts)
            synchronize(self.device)
            t1 = time.perf_counter()
            times["clip"] = t1 - t0
            final = self.denoise(latents, cond)
            synchronize(self.device)
            t2 = time.perf_counter()
            times["denoise"] = t2 - t1
            decoded = self.vae(final)
            images = postprocess_images(decoded)
            self.last_decoded_finite = bool(torch.isfinite(decoded).all())
            synchronize(self.device)
            times["vae"] = time.perf_counter() - t2
        self.last_stage_seconds = times
        return images.cpu().numpy()

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
        with self._dispatch_lock:
            out = self._img2img_locked(images, prompts, strength, seed,
                                       graphed)
        integrity.enforce(np.ones(len(out), dtype=bool),
                          pipeline=self.PIPELINE, stage="img2img",
                          images=out)
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
    ``cfg.spec_decode`` (same tokens)."""

    PROMPT_BUCKETS = (32, 64, 128, 256)
    BATCH_BUCKETS = (1, 2, 4, 8)
    PIPELINE = "prompt"

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dict: Optional[Mapping] = None,
                 draft_state_dict: Optional[Mapping] = None,
                 weights_dir: Optional[str] = None):
        models = cfg.models
        if models.lm_int8:
            raise NotImplementedError(
                "lm_int8 (weights-only int8 of the prompt LM) is not ported")
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
                            storage_dtype=param_dtype)
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
        # mistral.safetensors or its shards, or gpt2.safetensors
        self.model, self.loaded_real_weights = add_model(
            self._rebuilds, build, kind, weights_dir, CHECKPOINT_FILES[kind],
            converter_for(kind, models), state_dict, quant)
        if quant is not None:
            log.info("lm_w8a8: int8 W8A8 matmuls at %d sites (per-token "
                     "activation scales)", w8a8_site_count(self.model))
        synchronize(self.device)
        # host seconds of building the LM, and its parameters' bytes
        self.build_seconds = time.perf_counter() - t0
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in self.model.parameters())
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
            with self._dispatch_lock:
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

    def generate_batch(self, seed_texts: Sequence[str],
                       max_new_tokens: Optional[int] = None) -> List:
        """Continuations, each trimmed to two sentences. A row the
        integrity sentinel rejected comes back as an ``OutputInvalid``
        instance in its slot (not raised): the prompt queue fails that
        request alone while the batch's other rows serve."""
        t0 = time.perf_counter()
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


@dataclasses.dataclass
class RoundContent:
    """One round's generated content."""

    prompt_text: str          # the two-sentence episode text
    image: np.ndarray         # uint8 HWC RGB
    # what the round drew for its image: the styled prompt and the seed
    image_prompt: str = ""
    image_seed: int = 0


class TorchContentBackend:
    """Prompt-LM episode text + diffusion image: one round's content. The image
    comes from :class:`SDXLPipeline` when the config has a second text
    tower, else from :class:`Text2ImagePipeline`. ``weights_dir``: the
    checkpoints and vocabularies every model loads from (absent files:
    the seeded init)."""

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 styles: Optional[List[str]] = None,
                 rng: Optional[random.Random] = None,
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 weights_dir: Optional[str] = None):
        sd = state_dicts or {}
        self.cfg = cfg
        if cfg.models.clip_text_2 is not None:
            # serving/sdxl.py builds on this module
            from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline

            self.t2i = SDXLPipeline(cfg, device, state_dicts=sd,
                                    weights_dir=weights_dir)
        else:
            self.t2i = Text2ImagePipeline(cfg, device, state_dicts=sd,
                                          weights_dir=weights_dir)
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
            self.text_fallbacks += 1
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
