"""DDIM sampler (eta = 0) with classifier-free guidance.

Port of the main sampler of ``cassmantle_tpu/ops/ddim.py``. The reference
compiles the 50 steps into one ``lax.scan``; here they are a Python loop
of eager steps. The per-step coefficients are fp32 scalars taken in numpy
float32, as the reference's fp32 schedule arrays give them; the latents
stay fp32 (B, H, W, 4) NHWC. CFG runs the unconditional and conditional
halves as one 2B UNet batch; SDXL's micro-conditioning vector rides the
same batch as the context.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def alpha_bars_full(num_train_steps: int = 1000, beta_start: float = 0.00085,
                    beta_end: float = 0.012) -> np.ndarray:
    """ᾱ_t of SD's scaled-linear beta schedule, fp64 numpy."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_steps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def strided_timesteps(num_steps: int, num_train_steps: int = 1000
                      ) -> np.ndarray:
    """Descending int32 inference timesteps, "leading" spacing."""
    stride = num_train_steps // num_steps
    return (np.arange(num_steps) * stride)[::-1].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-inference-step coefficients (host-side)."""

    timesteps: np.ndarray        # (T,) int32, descending
    alpha_bars: np.ndarray       # (T,) float32 ᾱ_t
    alpha_bars_prev: np.ndarray  # (T,) float32 ᾱ_{t-1}

    @staticmethod
    def create(num_steps: int, num_train_steps: int = 1000,
               beta_start: float = 0.00085,
               beta_end: float = 0.012) -> "DDIMSchedule":
        ab_full = alpha_bars_full(num_train_steps, beta_start, beta_end)
        ts = strided_timesteps(num_steps, num_train_steps)
        ab = ab_full[ts].astype(np.float32)
        ab_prev = np.concatenate([ab_full[ts[1:]], [1.0]]).astype(np.float32)
        return DDIMSchedule(timesteps=ts, alpha_bars=ab,
                            alpha_bars_prev=ab_prev)


def ddim_update(x: torch.Tensor, eps: torch.Tensor, a_t: np.float32,
                a_prev: np.float32) -> torch.Tensor:
    """One deterministic DDIM transition x_t -> x_{t-1}."""
    one = np.float32(1.0)
    c_eps = float(np.sqrt(one - a_t))
    c_x = float(np.sqrt(a_t))
    c_x0 = float(np.sqrt(a_prev))
    c_dir = float(np.sqrt(np.maximum(one - a_prev, np.float32(0.0))))
    x0 = (x - c_eps * eps) / c_x
    return c_x0 * x0 + c_dir * eps


def ddim_sample(denoise: Callable[[torch.Tensor, int], torch.Tensor],
                latents: torch.Tensor, schedule: DDIMSchedule,
                eta: float = 0.0) -> torch.Tensor:
    """Run the DDIM loop: ``denoise(x_t, t)`` predicts the (guided) noise;
    ``latents`` is x_T. Returns the final latents."""
    if eta != 0.0:
        raise NotImplementedError("the port's DDIM is deterministic (eta=0)")
    x = latents
    for t, a_t, a_prev in zip(schedule.timesteps, schedule.alpha_bars,
                              schedule.alpha_bars_prev):
        x = ddim_update(x, denoise(x, int(t)), a_t, a_prev)
    return x


def cfg_context(context: torch.Tensor, uncond_context: torch.Tensor
                ) -> torch.Tensor:
    """The 2B CFG conditioning: unconditional rows first."""
    return torch.cat([uncond_context, context], dim=0)


def cfg_double(x: torch.Tensor, t: int):
    """(x, t) -> the duplicated (x2, t2) the 2B CFG batch consumes."""
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.full((x2.shape[0],), t, dtype=torch.int32, device=x.device)
    return x2, t2


def cfg_guide(eps: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    eps_uncond, eps_cond = eps.chunk(2, dim=0)
    return eps_uncond + guidance_scale * (eps_cond - eps_uncond)


def make_cfg_denoiser(unet: Callable, context: torch.Tensor,
                      uncond_context: torch.Tensor, guidance_scale: float,
                      addition_embeds: Optional[torch.Tensor] = None,
                      uncond_addition_embeds: Optional[torch.Tensor] = None
                      ) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """Classifier-free guidance: one 2B-batch UNet call per step. SDXL's
    ``addition_embeds`` (B, A) stack unconditional-first like the context;
    an absent unconditional addition is zeros."""
    full_context = cfg_context(context, uncond_context)
    extra = ()
    if addition_embeds is not None:
        if uncond_addition_embeds is None:
            uncond_addition_embeds = torch.zeros_like(addition_embeds)
        extra = (torch.cat([uncond_addition_embeds, addition_embeds], dim=0),)

    def denoise(x: torch.Tensor, t: int) -> torch.Tensor:
        x2, t2 = cfg_double(x, t)
        return cfg_guide(unet(x2, t2, full_context, *extra), guidance_scale)

    return denoise


def initial_latents(generator: torch.Generator, batch: int, image_size: int,
                    vae_scale: int = 8, channels: int = 4,
                    device=None) -> torch.Tensor:
    """x_T ~ N(0, I), (B, H/8, W/8, 4) fp32 NHWC."""
    h = w = image_size // vae_scale
    return torch.randn((batch, h, w, channels), generator=generator,
                       device=device, dtype=torch.float32)
