"""Typed configuration for the PyTorch/CUDA port.

A copy of the part of ``cassmantle_tpu/config.py`` that the port's first
slice reads: the SD1.5 model zoo (CLIP text tower, UNet, VAE), GPT-2 for
the round's prompt text, MiniLM for guess scoring, the DDIM sampler
settings and the few game/serving constants the round uses. Defaults are
the reference's defaults, so ``FrameworkConfig()`` is the serving
configuration: SD1.5 at 512², 50 DDIM steps, CFG 7.5.

The port keeps its own copy (it imports nothing of the JAX package);
fields no port module reads yet are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    """SD1.5's text tower (OpenAI CLIP ViT-L/14 text model) dimensions."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    # ViT-L/14 was trained with quick_gelu; OpenCLIP bigG with exact gelu.
    hidden_act: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Diffusion UNet at SD1.5 geometry."""

    sample_channels: int = 4
    base_channels: int = 320
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    # Per level: whether the level's resnet blocks carry transformer
    # (self + cross attention) blocks, and how many.
    attention_levels: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    blocks_per_level: int = 2
    # None: heads = channels // 64 (the SDXL convention).
    num_heads: Optional[int] = 8
    context_dim: int = 768
    time_embed_dim: int = 1280
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD autoencoder; the decoder is the serving path."""

    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    scaling_factor: float = 0.18215
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2-small for the round's prompt text (greedy decode)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 1024
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    """all-MiniLM-L6-v2-class sentence encoder for guess scoring."""

    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_positions: int = 512
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelZooConfig:
    clip_text: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    gpt2: GPT2Config = dataclasses.field(default_factory=GPT2Config)
    minilm: MiniLMConfig = dataclasses.field(default_factory=MiniLMConfig)
    # Storage dtype of the UNet, CLIP and GPT-2 parameters (the VAE and
    # MiniLM keep fp32 storage, as in the reference). Each layer casts
    # its parameters to its compute dtype where it uses them.
    param_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Image sampler and greedy text decode settings."""

    kind: str = "ddim"
    num_steps: int = 50
    guidance_scale: float = 7.5
    eta: float = 0.0
    image_size: int = 512
    # CFG negative conditioning; "" is the plain unconditional arm.
    negative_prompt: str = "blurry, distorted, fake, abstract, negative"
    min_new_tokens: int = 32
    max_new_tokens: int = 96
    prompt_pad_len: int = 77
    # 0 is greedy decode, the only text decode this slice ports.
    text_temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    # Padded batch buckets of the scorer's device encode.
    score_batch_sizes: Tuple[int, ...] = (8, 64, 256, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class GameConfig:
    # Masked words per round: generated text needs at least this many
    # words plus one, or the round falls back to template text.
    num_masked: int = 2
    min_blur: float = 0.0
    max_blur: float = 15.0


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    models: ModelZooConfig = dataclasses.field(default_factory=ModelZooConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    game: GameConfig = dataclasses.field(default_factory=GameConfig)
    seed: int = 0

    def replace(self, **kw) -> "FrameworkConfig":
        return dataclasses.replace(self, **kw)


def test_config() -> FrameworkConfig:
    """The reference's tiny CPU-test geometry: small models, 64px images."""

    return FrameworkConfig(
        models=ModelZooConfig(
            clip_text=ClipTextConfig(
                vocab_size=1024, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, max_positions=16,
            ),
            unet=UNetConfig(
                base_channels=32, channel_mults=(1, 2), num_heads=4,
                attention_levels=(True, False), transformer_depth=(1, 0),
                blocks_per_level=1, context_dim=64, time_embed_dim=128,
                dtype="float32",
            ),
            vae=VAEConfig(base_channels=32, channel_mults=(1, 2),
                          blocks_per_level=1, dtype="float32"),
            gpt2=GPT2Config(vocab_size=256, hidden_size=64, num_layers=2,
                            num_heads=4, max_positions=64, dtype="float32"),
            minilm=MiniLMConfig(vocab_size=512, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, max_positions=32),
            param_dtype="float32",
        ),
        sampler=SamplerConfig(num_steps=4, image_size=64, max_new_tokens=8,
                              min_new_tokens=2, prompt_pad_len=16,
                              negative_prompt=""),
    )
