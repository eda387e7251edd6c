"""CLIP-similarity harness: the quality gate.

Port of ``cassmantle_tpu/eval/clip_parity.py``. Images from two samplers
cannot be compared pixel for pixel, so the gate scores each generated
image against its prompt under CLIP:

    sim = <normalize(vision(image)), normalize(text(prompt) @ proj)>

With CLIP-L's full CLIPModel file (``clip_text.safetensors``: text tower,
vision tower, both projections) in ``weights_dir`` this is the real
metric; on seeded weights it checks the plumbing only, and every report
says so (``real_weights``, ``gate_enforced``). ``loaded_real_weights`` is
true only when all three stages loaded from the file.

The pair reports (:func:`consistency_quality_report`,
:func:`w8a8_quality_report`, :func:`encprop_quality_report`) compare
same-seed images of two arms in CLIP-vision space against a floor.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from cassmantle_tpu_torch.config import ClipTextConfig
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.clip_vision import (
    ClipVisionConfig,
    ClipVisionEncoder,
    preprocess_for_clip,
)
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.weights import (
    convert_clip_text,
    convert_clip_text_projection,
    convert_clip_vision,
    convert_tensors,
    fill_,
    load_checkpoint_tensors,
)
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device
from cassmantle_tpu_torch.utils.tokenizers import (
    load_tokenizer,
    tokenize_clip_prompts,
)

# the seeds of the harness's seeded stages (the reference's 11, 12, 13)
TEXT_SEED, VISION_SEED, PROJECTION_SEED = 11, 12, 13


class ClipSimilarityHarness:
    """CLIP text and vision towers and the text projection on ``device``.
    ``state_dicts`` (``clip_text``, ``clip_vision``, ``text_projection``)
    replace the file or the seeded init stage by stage (the parity tests
    pass the reference's weights); those count as not loaded from a
    checkpoint."""

    def __init__(
        self,
        text_cfg: Optional[ClipTextConfig] = None,
        vision_cfg: Optional[ClipVisionConfig] = None,
        weights_dir: Optional[str] = None,
        pad_len: int = 77,
        device: DeviceLike = "cuda",
        state_dicts: Optional[Mapping[str, object]] = None,
    ) -> None:
        self.text_cfg = text_cfg or ClipTextConfig()
        self.vision_cfg = vision_cfg or ClipVisionConfig()
        self.device = resolve_device(device)
        self.pad_len = min(pad_len, self.text_cfg.max_positions)
        self.tokenizer = load_tokenizer("clip", self.text_cfg.vocab_size,
                                        weights_dir)
        sd = dict(state_dicts or {})

        # one read of the full CLIPModel file feeds all three stages
        tensors = load_checkpoint_tensors(
            weights_dir, "clip_text.safetensors", "clip_full")
        loaded_text = convert_tensors(
            tensors, lambda t: convert_clip_text(t, self.text_cfg.num_layers),
            "clip_text")
        loaded_vision = convert_tensors(
            tensors,
            lambda t: convert_clip_vision(t, self.vision_cfg.num_layers),
            "clip_vision")
        proj = None
        if tensors is not None:
            try:
                proj = convert_clip_text_projection(tensors)
            except KeyError:
                proj = None
        # a quality number needs every stage from the file: a partial load
        # (a stage falling back to the seeded init) is plumbing only
        self.loaded_real_weights = (loaded_text is not None
                                    and loaded_vision is not None
                                    and proj is not None
                                    and not sd)

        self.text = self._build("clip_text", sd.get("clip_text", loaded_text),
                                TEXT_SEED)
        self.vision = self._build("clip_vision",
                                  sd.get("clip_vision", loaded_vision),
                                  VISION_SEED)
        if "text_projection" in sd:
            proj = torch.as_tensor(sd["text_projection"])
        elif proj is None:
            gen = torch.Generator("cpu").manual_seed(PROJECTION_SEED)
            proj = torch.randn((self.text_cfg.hidden_size,
                                self.vision_cfg.projection_dim),
                               generator=gen) * 0.02
        self.text_projection = proj.to(self.device, torch.float32)

    def _build(self, kind: str, weights: Optional[Mapping], seed: int):
        """A tower from ``weights`` (a state dict or a file's plan), or
        its seeded init; fp32, no grad."""
        with torch.device(self.device):
            module = (ClipTextEncoder(self.text_cfg) if kind == "clip_text"
                      else ClipVisionEncoder(self.vision_cfg))
        if weights is not None:
            fill_(module, weights)
        else:
            init_weights(module, torch.Generator(self.device).manual_seed(
                seed))
        return module.float().requires_grad_(False).eval()

    def _ids(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = tokenize_clip_prompts(self.tokenizer, prompts, self.pad_len,
                                    self.text_cfg.vocab_size)
        return torch.from_numpy(ids).to(self.device, torch.int64)

    def _images(self, images_u8) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images_u8)).to(self.device)

    def embed_images(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, P) unit CLIP-vision embeddings."""
        pre = preprocess_for_clip(self._images(images_u8),
                                  self.vision_cfg.image_size)
        return self.vision(pre)

    def embed_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        """B prompts -> (B, P) unit text embeddings in the shared space."""
        pooled = self.text(self._ids(prompts))["pooled"]
        temb = pooled.float() @ self.text_projection
        return temb / (torch.linalg.vector_norm(temb, dim=-1, keepdim=True)
                       + 1e-8)

    def similarity(self, images_u8: np.ndarray,
                   prompts: Sequence[str]) -> np.ndarray:
        """(B, H, W, 3) uint8 + B prompts -> (B,) CLIP similarities."""
        with torch.inference_mode():
            sims = torch.sum(self.embed_prompts(prompts)
                             * self.embed_images(images_u8), dim=-1)
            return sims.cpu().numpy()

    def parity_report(self, images_u8, prompts,
                      baseline_mean: Optional[float] = None) -> dict:
        sims = self.similarity(images_u8, prompts)
        report = {
            "clip_sim_mean": float(np.mean(sims)),
            "clip_sim_std": float(np.std(sims)),
            "n": int(len(sims)),
            # False: a plumbing run on seeded weights, not a quality claim
            "real_weights": self.loaded_real_weights,
        }
        if baseline_mean is not None:
            report["baseline_mean"] = float(baseline_mean)
            report["parity_ratio"] = float(np.mean(sims) / baseline_mean)
        return report

    def image_similarity(self, images_a_u8: np.ndarray,
                         images_b_u8: np.ndarray) -> np.ndarray:
        """(B,) cosine similarities of two image batches' CLIP-vision
        embeddings (identical batches embed identically)."""
        with torch.inference_mode():
            sims = torch.sum(self.embed_images(images_a_u8)
                             * self.embed_images(images_b_u8), dim=-1)
            return sims.cpu().numpy()


# The floors of the pair gates (the reference's): mean CLIP-vision
# similarity of an arm's images to the same-seed images of the arm it
# approximates. encprop reuses the full forward's features (exact at
# stride 1); the 4-step consistency student is a learned shortcut of the
# whole trajectory; W8A8 rounds the same trajectory twice per product.
ENCPROP_IMAGE_SIM_FLOOR = 0.95
CONSISTENCY_IMAGE_SIM_FLOOR = 0.90
W8A8_IMAGE_SIM_FLOOR = 0.98


def _pair_report(harness: ClipSimilarityHarness, images: np.ndarray,
                 images_ref: np.ndarray, prompts: Sequence[str],
                 floor: float, arm: str, ref_arm: str) -> dict:
    """The reference's pair-gate report: ``passes_floor`` is the verdict,
    ``gate_enforced`` whether it is a measurement (real weights)."""
    pair = harness.image_similarity(images, images_ref)
    return {
        "image_sim_mean": float(np.mean(pair)),
        "image_sim_min": float(np.min(pair)),
        "floor": float(floor),
        "passes_floor": bool(np.mean(pair) >= floor),
        "exact": bool(np.array_equal(images, images_ref)),
        f"clip_sim_{arm}": float(np.mean(harness.similarity(images,
                                                            prompts))),
        f"clip_sim_{ref_arm}": float(np.mean(harness.similarity(images_ref,
                                                                prompts))),
        "n": int(images_ref.shape[0]),
        "real_weights": harness.loaded_real_weights,
        "gate_enforced": harness.loaded_real_weights,
    }


def consistency_quality_report(
    harness: ClipSimilarityHarness,
    images_student: np.ndarray,
    images_teacher: np.ndarray,
    prompts: Sequence[str],
    floor: float = CONSISTENCY_IMAGE_SIM_FLOOR,
) -> dict:
    """The few-step gate: the student's images against the teacher's
    full-schedule images of the same seeds."""
    return _pair_report(harness, images_student, images_teacher, prompts,
                        floor, "student", "teacher")


def w8a8_quality_report(
    harness: ClipSimilarityHarness,
    images_w8a8: np.ndarray,
    images_fp: np.ndarray,
    prompts: Sequence[str],
    floor: float = W8A8_IMAGE_SIM_FLOOR,
) -> dict:
    """The W8A8 gate: the int8-kernel arm's images against the fp arm's
    images of the same seeds."""
    return _pair_report(harness, images_w8a8, images_fp, prompts, floor,
                        "w8a8", "fp")


def encprop_quality_report(
    harness: ClipSimilarityHarness,
    images_encprop: np.ndarray,
    images_full: np.ndarray,
    prompts: Sequence[str],
    floor: float = ENCPROP_IMAGE_SIM_FLOOR,
) -> dict:
    """The encprop gate: encoder-propagation images against the
    full-forward images of the same seeds."""
    return _pair_report(harness, images_encprop, images_full, prompts,
                        floor, "encprop", "full")
