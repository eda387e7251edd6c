"""SDXL-base text -> image: dual text towers and micro-conditioning.

Port of the monolithic path of
``cassmantle_tpu/serving/sdxl.py::SDXLPipeline`` at full 1024x1024 scale
(``sdxl_config()``). On top of :class:`Text2ImagePipeline` it adds:

- two text towers (CLIP ViT-L and OpenCLIP bigG), each contributing its
  second-to-last hidden state, concatenated into the 2048-wide UNet
  context;
- bigG's pooled embedding (projected when a ``text_projection`` is given)
  and the sinusoidal size/crop time ids, fed through the UNet's
  addition-embedding MLP (micro-conditioning);
- the VAE with SDXL's 0.13025 scaling factor (in the config).

From a weights directory it loads the reference's files:
``clip_text.safetensors``, ``clip_text_2.safetensors`` (read once for the
bigG tower and its ``text_projection``), ``unet_xl.safetensors`` and
``vae_xl.safetensors``.

``generate`` (inherited) is the reference's ``_sample_impl`` and
``generate``: encode both prompts, stack the CFG batch, the sampler loop
(50 DDIM steps by default), VAE decode, uint8. The denoise stage is the
one both pipelines share (``Text2ImagePipeline.denoise``, the
reference's ``run_cfg_denoise``), so every sampler kind, consistency,
DeepCache and encoder propagation serve here as at SD1.5, the CFG
addition embeds riding each forward's batch. On the card the loop
replays its captured bodies per batch size, whose static inputs include
the addition embeds. A brownout tier serves its own variant as at SD1.5,
its micro-conditioning time ids at the tier's image size (built once a
size, swapped into the addition embeds by ``denoise``). The reference's
SDXL pipeline has no img2img; nor has this one. Staged serving
(``ServingConfig.staged_serving``) serves SDXL as SD1.5
(``Text2ImagePipeline.generate``): its encode stage is :meth:`encode_ids`
(both towers and the micro-conditioning: ctx, uctx, add, uadd), its
denoise slots carry the addition embeds beside the contexts, and
``reload_params`` drops the staged server.

The UNet builds as SD1.5's does (``Text2ImagePipeline.__init__``): with
``fused_conv`` its ResBlock convs run the fused GroupNorm + SiLU + conv3x3
kernel (at 128x128 latents past W = 64); under ``unet_w8a8`` (with
``fused_conv``) its attention, GEGLU and conv3x3 sites run the int8
kernels with dynamic activation scales (the calibration artifact's entry
is SD1.5's, so no SDXL config matches it); under ``unet_int8`` its large
weights are int8, dequantized layer by layer. ``pipeline.w8a8_dispatches``
counts the W8A8 forwards of each dispatch, monolithic, tier and staged.

Over a mesh (``mesh=``) it serves as SD1.5 does
(``serving/pipeline.py``'s module docstring): prompts padded to dp, one
view per dp position over its card's replicas of both towers, bigG's
projection, the time ids and the UNet and VAE, and with sp > 1 the
spatially partitioned UNet (``parallel/spatial.py``), the micro-
conditioning replicated. A brownout tier's time ids are built once a
size on each card.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.layers import timestep_embedding
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.models.weights import (
    CHECKPOINT_FILES,
    checkpoint_paths,
    convert_clip_text_projection,
    convert_tensors,
    converter_for,
    load_checkpoint_tensors,
    refill_from_file,
    reread,
)
from cassmantle_tpu_torch.parallel.mesh import Mesh
from cassmantle_tpu_torch.serving.pipeline import (
    SamplerVariant,
    Text2ImagePipeline,
)
from cassmantle_tpu_torch.utils.device import DeviceLike, torch_dtype


def check_sdxl(cfg: FrameworkConfig) -> None:
    """What the port's SDXL path needs: both towers and micro-conditioning
    wider than bigG's pooled width."""
    m = cfg.models
    if m.clip_text_2 is None:
        raise ValueError("SDXL needs both text towers; use sdxl_config()")
    if (m.unet.addition_embed_dim - m.clip_text_2.hidden_size) // 6 <= 0:
        raise ValueError("SDXL's UNet needs micro-conditioning wider than "
                         "the bigG pooled width")


class SDXLPipeline(Text2ImagePipeline):
    """prompts -> (B, 1024, 1024, 3) uint8 under ``sdxl_config()`` (or the
    tiny ``test_sdxl_config()`` on the CPU).

    ``state_dicts`` takes the port ``state_dict`` of ``clip_text``,
    ``clip_text_2``, ``unet`` and ``vae`` and, optionally, bigG's
    ``clip_text_2_projection`` (the reference's square matrix, applied as
    ``pooled @ proj``); absent ones are random (seeds: CLIP 1, bigG 11,
    UNet 2, VAE 3), and with random weights there is no projection, as in
    the reference. ``weights_dir``: the checkpoints above; bigG's
    projection comes from its file when that holds one."""

    PIPELINE = "sdxl"
    LOCK_RANK = 11
    UNET_KIND, VAE_KIND = "unet_xl", "vae_xl"
    RANGES = ("sdxl_encode", "sdxl_denoise_scan", "sdxl_vae_decode")
    REPLICATED = ("clip", "clip2", "clip2_proj", "unet", "vae", "time_ids",
                  "tier_time_ids")

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dicts: Optional[Mapping[str, object]] = None,
                 weights_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None,
                 share_params_with: Optional["SDXLPipeline"] = None):
        check_sdxl(cfg)
        super().__init__(cfg, device, state_dicts, weights_dir, mesh,
                         share_params_with)
        m = cfg.models
        # addition vector = pooled bigG ++ 6 sinusoidal time-id embeddings
        self.time_id_dim = (m.unet.addition_embed_dim
                            - m.clip_text_2.hidden_size) // 6
        if share_params_with is not None:
            return
        sd = state_dicts or {}
        param_dtype = torch_dtype(m.param_dtype)
        kind, filename = "clip_text_2", CHECKPOINT_FILES["clip_text_2"]
        convert = converter_for(kind, m)
        given = sd.get(kind)
        proj = sd.get("clip_text_2_projection")
        if (given is not None or proj is not None) and checkpoint_paths(
                weights_dir, filename):
            raise ValueError(f"{kind}: given in state_dicts and as "
                             f"{filename} in {weights_dir}; give one")
        # read once: the file carries the tower and its text_projection
        tensors = (None if given is not None else
                   load_checkpoint_tensors(weights_dir, filename, kind))
        tower = convert_tensors(tensors, convert, kind)
        build = partial(self._build, partial(ClipTextEncoder, m.clip_text_2),
                        kind, storage_dtype=param_dtype)
        if tower is None:
            self.clip2 = self._rebuilds.add(partial(build, given))
        else:
            self.clip2 = self._rebuilds.add(partial(build, tower),
                                            refill_from_file(
                                                weights_dir, filename,
                                                convert, kind))
        self.loaded_real_weights = self.loaded_real_weights and (
            tower is not None)
        self.clip2_proj = None
        if proj is not None:
            self.clip2_proj = self._rebuilds.add(
                partial(proj.to, self.device, param_dtype))
        elif tower is not None and "text_projection.weight" in tensors:
            # real SDXL conditions on text_projection(pooled), the text
            # embeds of CLIPTextModelWithProjection

            def refill(live: torch.Tensor) -> None:
                live.copy_(convert_clip_text_projection(
                    reread(weights_dir, filename, convert, kind).src))

            self.clip2_proj = self._rebuilds.add(partial(
                convert_clip_text_projection(tensors).to, self.device,
                param_dtype, copy=True), refill)
        # the time ids depend on the config alone: built once, here (a host
        # to device copy, never inside a step)
        self.time_ids = self._rebuilds.add(partial(self._time_ids, 1))
        # a brownout tier's, by image size, built as its tier engages
        self.tier_time_ids: Dict[int, torch.Tensor] = {}

    @classmethod
    def shape_twin(cls, cfg: FrameworkConfig) -> "SDXLPipeline":
        """:meth:`Text2ImagePipeline.shape_twin`, with bigG's projection
        absent (as with random weights) and the time ids' shape."""
        twin = super().shape_twin(cfg)
        m = cfg.models
        twin.clip2_proj = None
        twin.time_id_dim = (m.unet.addition_embed_dim
                            - m.clip_text_2.hidden_size) // 6
        twin.time_ids = torch.empty((1, 6 * twin.time_id_dim),
                                    device="meta")
        return twin

    def cost_signature(self, variant: Optional[SamplerVariant] = None
                       ) -> str:
        s = (variant or self.full_variant).sampler_cfg
        return costmodel.sdxl_signature(self.cfg, s)

    def _meta_models(self) -> Dict[str, object]:
        """:meth:`Text2ImagePipeline._meta_models` with bigG, its
        projection and the time ids."""
        twins = super()._meta_models()
        twins["clip2"] = costmodel.meta_module(
            partial(ClipTextEncoder, self.cfg.models.clip_text_2))
        twins["clip2_proj"] = (None if self.clip2_proj is None else
                               torch.empty_like(self.clip2_proj,
                                                device="meta"))
        twins["time_ids"] = torch.empty_like(self.time_ids, device="meta")
        return twins

    def _encode(self, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids -> (context (B, S, 768 + 1280), pooled bigG (B, 1280))."""
        out1, out2 = self.clip(ids), self.clip2(ids)
        context = torch.cat([out1["penultimate"], out2["penultimate"]],
                            dim=-1)
        pooled = out2["pooled"]
        if self.clip2_proj is not None:
            pooled = pooled @ self.clip2_proj.to(pooled.dtype)
        return context, pooled

    def _time_ids(self, batch: int,
                  image_size: Optional[int] = None) -> torch.Tensor:
        """SDXL's size/crop conditioning (orig_h, orig_w, crop_top,
        crop_left, target_h, target_w) at ``image_size`` (default: the
        configured size), each embedded sinusoidally: (batch,
        6 * time_id_dim) fp32."""
        s = float(image_size or self.cfg.sampler.image_size)
        ids = torch.tensor([s, s, 0.0, 0.0, s, s], dtype=torch.float32,
                           device=self.device)
        flat = timestep_embedding(ids, self.time_id_dim).reshape(-1)
        return flat.expand(batch, flat.shape[0])

    def generate_img2img(self, images: np.ndarray, prompts: Sequence[str],
                         strength: float = 0.6, seed: int = 0,
                         graphed: Optional[bool] = None) -> np.ndarray:
        raise NotImplementedError(
            "img2img is an SD1.5 pipeline path; the reference's SDXL "
            "pipeline has none")

    def encode_ids(self, ids: torch.Tensor,
                   uncond_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Both towers over the prompts' and the negative prompt's ids:
        the contexts and the micro-conditioning vectors of the CFG batch,
        at the configured size."""
        ctx, pooled = self._encode(ids)
        uncond_ctx, uncond_pooled = self._encode(uncond_ids)
        time_ids = self.time_ids.expand(len(ids), -1)
        return {"context": ctx, "uncond_context": uncond_ctx,
                "addition_embeds": torch.cat([pooled, time_ids], dim=-1),
                "uncond_addition_embeds": torch.cat(
                    [uncond_pooled, time_ids], dim=-1)}

    def denoise(self, latents: torch.Tensor, cond: Dict[str, torch.Tensor],
                graphed: Optional[bool] = None,
                variant: Optional[SamplerVariant] = None) -> torch.Tensor:
        """:meth:`Text2ImagePipeline.denoise`; a brownout tier at another
        image size conditions on its own: the time-id columns of both
        addition vectors swapped for the tier size's, built once a size
        (the reference's tier impl builds its own)."""
        size = (variant.sampler_cfg.image_size if variant is not None
                else self.cfg.sampler.image_size)
        if size != self.cfg.sampler.image_size:
            ids = self.tier_time_ids.get(size)
            if ids is None:
                ids = self._rebuilds.add(partial(self._time_ids, 1, size))
                self.tier_time_ids[size] = ids
            width = ids.shape[-1]
            cond = {**cond, **{
                key: torch.cat([cond[key][:, :-width],
                                ids.expand(len(cond[key]), -1)], dim=-1)
                for key in ("addition_embeds", "uncond_addition_embeds")}}
        return super().denoise(latents, cond, graphed, variant)
