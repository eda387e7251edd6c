"""Inference service: the game's injection points on the port.

Port of ``cassmantle_tpu/serving/service.py::InferenceService`` without
its serving plumbing (batching queues, supervisor, device-loss recovery,
overload control), which is a later slice: ``embed``, ``similarity``,
``blur`` and ``generate_content`` call the pipelines directly and
synchronously. The image pipeline follows the config: SD1.5 by default,
SDXL under ``sdxl_config()`` (``TorchContentBackend``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.ops.blur import device_blur
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.serving.pipeline import (
    RoundContent,
    TorchContentBackend,
)
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device


class InferenceService:
    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dicts: Optional[Mapping[str, Mapping]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        sd = state_dicts or {}
        self.scorer = EmbeddingScorer(
            cfg.models.minilm, self.device,
            batch_buckets=cfg.serving.score_batch_sizes,
            state_dict=sd.get("minilm"), seed=cfg.seed)
        self.backend = TorchContentBackend(cfg, self.device, state_dicts=sd)

    def embed(self, words: Sequence[str]) -> np.ndarray:
        return self.scorer.embed(list(words))

    def similarity(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """[(guess, answer)] -> cosine similarity per pair."""
        return self.scorer.similarity(list(pairs))

    def blur(self, image: np.ndarray, radius: float) -> np.ndarray:
        return device_blur(image, radius, self.device)

    def generate_content(self, seed: str, is_seed: bool = True
                         ) -> RoundContent:
        """One round: GPT-2 episode text and its uint8 image (512x512 under
        ``FrameworkConfig()``, 1024x1024 under ``sdxl_config()``)."""
        return self.backend.generate_sync(seed, is_seed)
