"""DDIM sampler (eta = 0) with classifier-free guidance.

Port of the main sampler of ``cassmantle_tpu/ops/ddim.py``. The reference
compiles the 50 steps into one ``lax.scan``: each step reads its
timestep and coefficients from the schedule arrays by the scan's index,
with no host round trip. The port keeps the same loop state on the
device: :meth:`DDIMSchedule.coefficients` uploads the timesteps and the
per-step coefficients once, and :func:`ddim_step` reads step i's values
by a gather at a step counter held in a device tensor, which it advances
in place. That step runs eagerly in :func:`ddim_sample` (the CPU path,
and the card's reference run) and, on the card, as the replays of one
captured CUDA graph in :class:`DDIMGraph`, the counterpart of the
reference's jitted scan. Both run the same arithmetic.

The coefficients are fp32, taken in numpy float32 as the reference's
fp32 schedule arrays give them (sqrt is correctly rounded); the latents
stay fp32 (B, H, W, 4) NHWC. The update divides by a device tensor, an
IEEE division on every device (CUDA computes a division by a host scalar
as a multiply by its reciprocal). CFG runs the unconditional and
conditional halves as one 2B UNet batch; SDXL's micro-conditioning
vector rides the same batch as the context.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from cassmantle_tpu_torch.ops.graphs import CapturedStep

# denoise(x (B, H, W, 4), t (1,) int32 on x's device) -> guided eps
Denoiser = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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


class DDIMCoefficients(NamedTuple):
    """A schedule on the device: ``timesteps`` (T,) int32 and ``table``
    (T, 4) fp32, per step (c_eps, c_x, c_x0, c_dir) = (sqrt(1 - ᾱ_t),
    sqrt(ᾱ_t), sqrt(ᾱ_{t-1}), sqrt(max(1 - ᾱ_{t-1}, 0)))."""

    timesteps: torch.Tensor
    table: torch.Tensor


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

    def coefficients(self, device) -> DDIMCoefficients:
        """The timesteps and the step coefficients, computed in numpy
        float32 and uploaded to ``device`` once."""
        one, zero = np.float32(1.0), np.float32(0.0)
        a_t, a_prev = self.alpha_bars, self.alpha_bars_prev
        table = np.stack([np.sqrt(one - a_t), np.sqrt(a_t), np.sqrt(a_prev),
                          np.sqrt(np.maximum(one - a_prev, zero))], axis=1)
        return DDIMCoefficients(
            torch.from_numpy(self.timesteps.astype(np.int32)).to(device),
            torch.from_numpy(table.astype(np.float32)).to(device))


def ddim_update(x: torch.Tensor, eps: torch.Tensor, c_eps: torch.Tensor,
                c_x: torch.Tensor, c_x0: torch.Tensor,
                c_dir: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM transition x_t -> x_{t-1}; the coefficients
    are fp32 tensors on x's device (0-dim or (1,))."""
    x0 = (x - c_eps * eps) / c_x
    return c_x0 * x0 + c_dir * eps


def ddim_step(denoise: Denoiser, x: torch.Tensor, coeffs: DDIMCoefficients,
              step: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t-1} at the step that ``step`` ((1,) int64 on x's
    device) names: its timestep and coefficients are gathered on the
    device, and ``step`` advances by one in place."""
    t = coeffs.timesteps.index_select(0, step)
    c = coeffs.table.index_select(0, step).unbind(dim=1)
    x = ddim_update(x, denoise(x, t), *c)
    step.add_(1)
    return x


def ddim_sample(denoise: Denoiser, latents: torch.Tensor,
                schedule: DDIMSchedule, eta: float = 0.0) -> torch.Tensor:
    """Run the DDIM loop eagerly, one :func:`ddim_step` a step:
    ``denoise(x_t, t)`` predicts the (guided) noise; ``latents`` is x_T.
    Returns the final latents."""
    if eta != 0.0:
        raise NotImplementedError("the port's DDIM is deterministic (eta=0)")
    coeffs = schedule.coefficients(latents.device)
    step = torch.zeros((1,), dtype=torch.long, device=latents.device)
    x = latents
    for _ in range(len(schedule.timesteps)):
        x = ddim_step(denoise, x, coeffs, step)
    return x


class DDIMGraph:
    """:func:`ddim_sample` with one captured CUDA graph of
    :func:`ddim_step`, replayed once per step.

    ``make_denoise(**inputs)`` builds the denoiser over the conditioning
    tensors it is given; here it gets static copies of ``inputs`` (the
    example call's), which each call overwrites in place. The latents
    (first the example's x_T, on which the warm-up runs step 0) and the
    step counter are static buffers too. A call copies x_T and the
    inputs into them, resets the counter and replays the graph once per
    step: no host copy and no sync between replays."""

    def __init__(self, make_denoise: Callable[..., Denoiser],
                 schedule: DDIMSchedule, latents: torch.Tensor,
                 **inputs: Optional[torch.Tensor]):
        dev = latents.device
        self.num_steps = len(schedule.timesteps)
        self.coeffs = schedule.coefficients(dev)
        self.inputs: Dict[str, torch.Tensor] = {
            k: v.clone() for k, v in inputs.items() if v is not None}
        self.x = latents.to(torch.float32, copy=True)
        self.step = torch.zeros((1,), dtype=torch.long, device=dev)
        denoise = make_denoise(**self.inputs)

        def step() -> torch.Tensor:
            return self.x.copy_(ddim_step(denoise, self.x, self.coeffs,
                                          self.step))

        self.graph = CapturedStep(step)

    def __call__(self, latents: torch.Tensor,
                 **inputs: Optional[torch.Tensor]) -> torch.Tensor:
        for k, v in inputs.items():
            if v is not None:
                self.inputs[k].copy_(v)
        self.x.copy_(latents)
        self.step.zero_()
        for _ in range(self.num_steps):
            self.graph.replay()
        return self.x.clone()


def cfg_inputs(context: torch.Tensor, uncond_context: torch.Tensor,
               addition_embeds: Optional[torch.Tensor] = None,
               uncond_addition_embeds: Optional[torch.Tensor] = None
               ) -> Dict[str, Optional[torch.Tensor]]:
    """The 2B CFG conditioning, unconditional rows first: ``context`` and
    SDXL's ``additions`` (None without them; an absent unconditional
    addition is zeros)."""
    additions = None
    if addition_embeds is not None:
        if uncond_addition_embeds is None:
            uncond_addition_embeds = torch.zeros_like(addition_embeds)
        additions = torch.cat([uncond_addition_embeds, addition_embeds],
                              dim=0)
    return {"context": torch.cat([uncond_context, context], dim=0),
            "additions": additions}


def cfg_double(x: torch.Tensor, t: torch.Tensor):
    """(x, t (1,)) -> the duplicated (x2, t2 (2B,)) the CFG batch
    consumes; t2 is a view of t."""
    x2 = torch.cat([x, x], dim=0)
    return x2, t.expand(x2.shape[0])


def cfg_guide(eps: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    eps_uncond, eps_cond = eps.chunk(2, dim=0)
    return eps_uncond + guidance_scale * (eps_cond - eps_uncond)


def cfg_denoiser(unet: Callable, context: torch.Tensor,
                 guidance_scale: float,
                 additions: Optional[torch.Tensor] = None) -> Denoiser:
    """Classifier-free guidance over the stacked 2B conditioning of
    :func:`cfg_inputs`: one 2B-batch UNet call per step."""
    extra = () if additions is None else (additions,)

    def denoise(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        x2, t2 = cfg_double(x, t)
        return cfg_guide(unet(x2, t2, context, *extra), guidance_scale)

    return denoise


def make_cfg_denoiser(unet: Callable, context: torch.Tensor,
                      uncond_context: torch.Tensor, guidance_scale: float,
                      addition_embeds: Optional[torch.Tensor] = None,
                      uncond_addition_embeds: Optional[torch.Tensor] = None
                      ) -> Denoiser:
    """:func:`cfg_denoiser` over the conditioning of one call. SDXL's
    ``addition_embeds`` (B, A) stack unconditional-first like the
    context."""
    return cfg_denoiser(unet, guidance_scale=guidance_scale, **cfg_inputs(
        context, uncond_context, addition_embeds, uncond_addition_embeds))


def initial_latents(generator: torch.Generator, batch: int, image_size: int,
                    vae_scale: int = 8, channels: int = 4,
                    device=None) -> torch.Tensor:
    """x_T ~ N(0, I), (B, H/8, W/8, 4) fp32 NHWC."""
    h = w = image_size // vae_scale
    return torch.randn((batch, h, w, channels), generator=generator,
                       device=device, dtype=torch.float32)
