"""Diffusion samplers beyond DDIM: Euler, DPM-Solver++(2M) and few-step
consistency sampling, and img2img's schedule tails.

Port of ``cassmantle_tpu/ops/samplers.py``. Every sampler keeps the DDIM
contract of ``ops/ddim.py``: ``denoise(x_t, t) -> eps`` with x_t in VP
space and t the train timestep, so the CFG denoisers and the UNet serve
every kind unchanged. Each schedule is computed host-side in numpy as the
reference's (its float64 arithmetic and float32 rounding copied
verbatim), and :meth:`spec` uploads it as a solver spec
(``ops/ddim.py``): the timesteps, the per-step coefficient columns that
the step gathers at its device step counter, the carry and the update.
The generic loops run a spec eagerly (:func:`~cassmantle_tpu_torch.ops.
ddim.sample_spec`, the encoder-propagation and DeepCache loops) or as a
captured graph (``SpecGraph``, ``EncpropGraph``, ``SpecDeepCacheGraph``).
Coefficients that the reference computes inside its scan (sqrt(1 + s^2),
sqrt(1 - ab)) are computed in numpy float32, op for op; every division
in a step is by a device tensor.

- Euler (:class:`EulerSchedule`): the k-diffusion sigma ladder, x carried
  in k-space (x_vp sqrt(1 + s^2)); ``prescaled`` for img2img tails;
- DPM-Solver++(2M) (:class:`DPMppSchedule`): data-prediction multistep,
  first order at the first and last steps; the carry is (x, m1);
- consistency (:class:`ConsistencySchedule`): num_steps direct x0
  predictions through the boundary parameterization, trailing timesteps
  on the teacher's grid, each step re-noised with the deterministic
  ladder ``normal(fold_in(PRNGKey(0x1C3), t), (H, W, 4))``, drawn by
  ``utils/jax_random.py`` as the reference's ``jax.random`` draws it (the
  ladder is part of the sampler's result) once a schedule and shape.

:func:`make_slot_sampler` steps the same specs for the staged serving
path, each slot at its own position (:class:`SlotSampler`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from cassmantle_tpu_torch.ops.ddim import (
    DDIMSchedule,
    alpha_bars_full,
    slot_spec_step,
    strided_timesteps,
)
from cassmantle_tpu_torch.utils import jax_random

SAMPLER_KINDS = ("ddim", "euler", "dpmpp_2m")

# Seed of the consistency sampler's re-noise ladder: the step noise is
# normal(fold_in(PRNGKey(seed), t), latent row shape), a function of the
# timestep alone, shared across batch rows.
CONSISTENCY_NOISE_SEED = 0x1C3


def consistency_disabled() -> bool:
    """True when CASSMANTLE_NO_CONSISTENCY is set to a truthy value: a
    consistency-configured pipeline built then serves the teacher path,
    the configured kind at ``consistency_teacher_steps``."""
    return os.environ.get("CASSMANTLE_NO_CONSISTENCY", "").lower() \
        not in ("", "0", "false", "no", "off")


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _column(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(_f32(a)).to(device)


def _timesteps(ts: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(ts.astype(np.int32)).to(device)


def consistency_boundary(sigma, sigma_min, sigma_data: float = 0.5):
    """The boundary parameterization (c_skip, c_out) at k-space noise
    level ``sigma``: f(x, s) = c_skip(s) x + c_out(s) x0_pred, exactly
    (1, 0) at ``sigma_min``."""
    c_skip = sigma_data**2 / ((sigma - sigma_min) ** 2 + sigma_data**2)
    c_out = (sigma_data * (sigma - sigma_min)
             / (sigma**2 + sigma_data**2) ** 0.5)
    return c_skip, c_out


def consistency_renoise(t, shape: Sequence[int],
                        device="cpu") -> torch.Tensor:
    """One latent row of re-noise keyed on timestep ``t`` (float32)."""
    key = jax_random.fold_in(
        jax_random.PRNGKey(CONSISTENCY_NOISE_SEED, device), int(t))
    return jax_random.normal(key, shape)


@dataclasses.dataclass(frozen=True)
class ConsistencySchedule:
    """Few-step consistency schedule: ``num_steps`` timesteps taken
    trailing from the teacher's grid (``strided_timesteps(
    teacher_steps)`` without its final t = 0), so the last evaluation
    sits at a noisy timestep and its output is the final x0."""

    timesteps: np.ndarray        # (T,) int32 descending, last > 0
    alpha_bars: np.ndarray       # (T,) float32 ᾱ at each evaluation
    alpha_bars_next: np.ndarray  # (T,) ᾱ of the re-noise target; last 1
    c_skip: np.ndarray           # (T,) boundary coefficients
    c_out: np.ndarray            # (T,)

    @staticmethod
    def create(num_steps: int, teacher_steps: int = 50,
               num_train_steps: int = 1000,
               sigma_data: float = 0.5) -> "ConsistencySchedule":
        if num_steps < 1:
            raise ValueError(f"consistency needs num_steps >= 1, got "
                             f"{num_steps}")
        ab_full = alpha_bars_full(num_train_steps)
        grid = strided_timesteps(teacher_steps, num_train_steps)[:-1]
        if num_steps > len(grid):
            raise ValueError(
                f"consistency needs num_steps {num_steps} <= "
                f"teacher_steps-1 = {len(grid)} (the student is only "
                f"trained on the teacher discretization's query points)")
        ts = grid[(len(grid) // num_steps)
                  * np.arange(num_steps)].astype(np.int32)
        ab = ab_full[ts]
        ab_next = np.concatenate([ab[1:], [1.0]])
        sigma = np.sqrt((1.0 - ab) / ab)
        sigma_min = float(np.sqrt((1.0 - ab_full[0]) / ab_full[0]))
        c_skip, c_out = consistency_boundary(sigma, sigma_min, sigma_data)
        return ConsistencySchedule(
            timesteps=ts, alpha_bars=_f32(ab), alpha_bars_next=_f32(ab_next),
            c_skip=_f32(c_skip), c_out=_f32(c_out))

    def renoise_ladder(self, shape: Sequence[int],
                       device) -> torch.Tensor:
        """(T, *shape): each step's re-noise row."""
        return torch.stack([consistency_renoise(t, shape, device)
                            for t in self.timesteps])

    def spec(self, latents: torch.Tensor) -> dict:
        """The solver spec on ``latents``' device, with the re-noise
        ladder of its (H, W, 4) rows: x0 = (x - sqrt(1 - ab) eps) /
        sqrt(ab), f = c_skip x + c_out x0, x = sqrt(ab_next) f +
        sqrt(1 - ab_next) noise."""
        dev = latents.device
        one = np.float32(1.0)
        ab, ab_next = self.alpha_bars, self.alpha_bars_next
        cols = tuple(_column(c, dev) for c in (
            np.sqrt(one - ab), np.sqrt(ab), self.c_skip, self.c_out,
            np.sqrt(ab_next), np.sqrt(one - ab_next)))

        def update(carry, eps, c):
            x = carry[0]
            x0 = (x - c[0] * eps) / c[1]
            f = c[2] * x + c[3] * x0
            # c[6]: the step's re-noise row (1, H, W, 4), or one a slot
            return (c[4] * f + c[5] * c[6],)

        return {"timesteps": _timesteps(self.timesteps, dev),
                "coefs": cols + (self.renoise_ladder(latents.shape[1:],
                                                     dev),),
                "init": lambda lat: (lat,),
                "x_for": lambda carry, c: carry[0],
                "update": update}


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    """The k-diffusion sigma ladder; x evolves in k-space
    (x_vp sqrt(1 + s^2))."""

    timesteps: np.ndarray   # (T,) int32 descending
    sigmas: np.ndarray      # (T+1,) float32, sigmas[-1] == 0
    # the loop's x_T is in k-space already (img2img tails): no s_0 scale
    prescaled: bool = False

    @staticmethod
    def create(num_steps: int, start: int = 0,
               prescaled: bool = False) -> "EulerSchedule":
        """``start`` > 0 drops the first steps (img2img tails)."""
        ab = alpha_bars_full()
        ts = strided_timesteps(num_steps)[start:]
        sig = np.sqrt((1.0 - ab[ts]) / ab[ts])
        sig = np.concatenate([sig, [0.0]]).astype(np.float32)
        return EulerSchedule(timesteps=ts, sigmas=sig, prescaled=prescaled)

    def spec(self, latents: torch.Tensor) -> dict:
        """The solver spec on ``latents``' device: the denoiser sees
        x / sqrt(1 + s^2), and x += (s_next - s) eps. The carry enters
        k-space as x_T s_0, or as it is when ``prescaled``."""
        dev = latents.device
        s, s_next = self.sigmas[:-1], self.sigmas[1:]
        cols = (_column(np.sqrt(np.float32(1.0) + s * s), dev),
                _column(s_next - s, dev))
        sigma0 = _column(self.sigmas[0], dev)
        return {"timesteps": _timesteps(self.timesteps, dev),
                "coefs": cols,
                "init": ((lambda lat: (lat,)) if self.prescaled
                         else (lambda lat: (lat * sigma0,))),
                "x_for": lambda carry, c: carry[0] / c[0],
                "update": lambda carry, eps, c: (carry[0] + c[1] * eps,)}


@dataclasses.dataclass(frozen=True)
class DPMppSchedule:
    """DPM-Solver++(2M), every step's coefficients precomputed:
    x <- c_skip x + c_d0 m0 + c_d1 m1, with m0 / m1 this / the previous
    step's predicted x0. The first and last steps are first order
    (c_d1 = 0), which keeps every coefficient finite."""

    timesteps: np.ndarray  # (T,) int32 descending
    alphas: np.ndarray     # (T,) sqrt(ᾱ)
    sigmas: np.ndarray     # (T,) sqrt(1 - ᾱ)
    c_skip: np.ndarray     # (T,)
    c_d0: np.ndarray       # (T,)
    c_d1: np.ndarray       # (T,)

    @staticmethod
    def create(num_steps: int, start: int = 0) -> "DPMppSchedule":
        """``start`` > 0 drops the first steps (img2img tails); the first
        kept step is first order."""
        ab = alpha_bars_full()
        ts = strided_timesteps(num_steps)[start:]
        alpha = np.sqrt(ab[ts])
        sigma = np.sqrt(1.0 - ab[ts])
        # step i maps the state at ts[i] to ts[i+1] (the last to clean)
        alpha_next = np.concatenate([alpha[1:], [1.0]])
        sigma_next = np.concatenate([sigma[1:], [0.0]])
        lam = np.log(alpha) - np.log(sigma)
        with np.errstate(divide="ignore"):
            lam_next = np.log(alpha_next) - np.log(
                np.where(sigma_next > 0, sigma_next, 1e-300))
        h = lam_next - lam
        h_prev = np.concatenate([[np.nan], h[:-1]])
        em1 = np.where(np.isfinite(h), np.expm1(-h), -1.0)
        # the 2M correction weight 1 / (2 r0), r0 = h_prev / h
        with np.errstate(divide="ignore", invalid="ignore"):
            inv2r = h / (2.0 * h_prev)
            inv2r = np.where(np.isfinite(inv2r), inv2r, 0.0)
        first_order = np.zeros(len(ts), dtype=bool)
        first_order[0] = True
        first_order[-1] = True
        inv2r = np.where(first_order, 0.0, inv2r)
        c_skip = np.where(sigma > 0, sigma_next / sigma, 0.0)
        c_d0 = -alpha_next * em1 * (1.0 + inv2r)
        c_d1 = alpha_next * em1 * inv2r
        return DPMppSchedule(
            timesteps=ts, alphas=_f32(alpha), sigmas=_f32(sigma),
            c_skip=_f32(c_skip), c_d0=_f32(c_d0), c_d1=_f32(c_d1))

    def spec(self, latents: torch.Tensor) -> dict:
        """The solver spec on ``latents``' device; the carry is (x, m1),
        m1 entering as zeros."""
        dev = latents.device
        cols = tuple(_column(a, dev) for a in (
            self.alphas, self.sigmas, self.c_skip, self.c_d0, self.c_d1))

        def update(carry, eps, c):
            x, m1 = carry
            alpha, sigma, c_skip, c_d0, c_d1 = c
            m0 = (x - sigma * eps) / alpha
            return (c_skip * x + c_d0 * m0 + c_d1 * m1, m0)

        return {"timesteps": _timesteps(self.timesteps, dev),
                "coefs": cols,
                "init": lambda lat: (lat, torch.zeros_like(lat)),
                "x_for": lambda carry, c: carry[0],
                "update": update}


def img2img_start(kind: str, num_steps: int, start: int):
    """img2img's entry: (``prepare(x0, noise)`` -> the solver-space state
    at step ``start``, the tail's schedule). VP space (sqrt(ᾱ) x0 +
    sqrt(1 - ᾱ) noise) for DDIM and DPM++, k-space (x0 + s noise) for
    Euler (its schedule ``prescaled``), each scale a float32 device
    tensor."""
    ab = alpha_bars_full()
    a0 = float(ab[strided_timesteps(num_steps)[start]])
    if kind == "euler":
        sigma0 = np.float32(np.sqrt((1.0 - a0) / a0))
        return (lambda x0, noise: x0 + _column(sigma0, x0.device) * noise,
                EulerSchedule.create(num_steps, start, prescaled=True))
    if kind not in ("ddim", "dpmpp_2m"):
        raise ValueError(f"unknown sampler kind {kind!r}; "
                         f"choose from {SAMPLER_KINDS}")
    c_x = np.sqrt(np.float32(a0))
    c_noise = np.sqrt(np.float32(1.0 - a0))

    def prepare(x0, noise):
        return (_column(c_x, x0.device) * x0
                + _column(c_noise, x0.device) * noise)

    schedule = (DDIMSchedule.create(num_steps, start=start) if kind == "ddim"
                else DPMppSchedule.create(num_steps, start))
    return prepare, schedule


def make_schedule(kind: str, num_steps: int, consistency: bool = False,
                  teacher_steps: int = 50):
    """The schedule a pipeline serves: the consistency schedule, or the
    kind's (DDIM, Euler, DPM++)."""
    if consistency:
        return ConsistencySchedule.create(num_steps, teacher_steps)
    schedules = {"ddim": DDIMSchedule, "euler": EulerSchedule,
                 "dpmpp_2m": DPMppSchedule}
    if kind not in schedules:
        raise ValueError(f"unknown sampler kind {kind!r}; "
                         f"choose from {SAMPLER_KINDS}")
    return schedules[kind].create(num_steps)


@dataclasses.dataclass(frozen=True)
class SlotSampler:
    """The per-slot sampler of the staged denoise loop
    (serving/stages.py), :func:`make_slot_sampler`'s result.

    - ``prepare(latents) -> (x, aux)``: x_T into the solver's entry state
      (the spec's ``init``: Euler's sigma_0 scale, else x_T itself) and
      the slot's auxiliary state (DPM++'s history m1, entering as zeros;
      zeros where the solver keeps none);
    - ``step(denoise, x, aux, steps) -> (x', aux')``: every slot one step
      from its own position ``steps`` (w,) long, ``denoise(x, t (w,))``
      once (``ops/ddim.py::slot_spec_step``);
    - ``num_steps``; ``spec``, the solver spec stepped; ``has_aux``,
      whether the solver carries aux (DPM++ only)."""

    spec: dict
    num_steps: int
    has_aux: bool

    def prepare(self, latents: torch.Tensor):
        carry = self.spec["init"](latents)
        x = carry[0]
        return x, (carry[1] if self.has_aux else torch.zeros_like(x))

    def step(self, denoise, x: torch.Tensor, aux: torch.Tensor,
             steps: torch.Tensor):
        carry = (x, aux) if self.has_aux else (x,)
        out = slot_spec_step(self.spec, denoise, carry, steps)
        return out[0], (out[1] if self.has_aux else aux)


def make_slot_sampler(kind: str, num_steps: int, latents: torch.Tensor,
                      eta: float = 0.0,
                      teacher_steps: int = 50) -> SlotSampler:
    """Port of the reference's ``make_slot_sampler``: the step-granular
    counterpart of a pipeline's sampler loop for the staged serving
    path, on ``latents``' device (one row of the latent shape is enough:
    the consistency ladder takes its row shape). Kinds ddim, euler,
    dpmpp_2m and consistency; built on the same solver spec the
    monolithic loop steps (:func:`make_schedule`), so a solo slot's
    trajectory is the monolithic ``spec_step``'s value for value. eta > 0
    raises: its per-step noise chain cannot be replayed by a slot
    admitted mid-flight."""
    if eta != 0.0:
        raise ValueError(
            "staged serving needs a deterministic sampler (eta=0); "
            "eta>0 carries a per-step noise key chain that step-level "
            "admission cannot replay")
    if kind == "consistency":
        schedule = ConsistencySchedule.create(num_steps, teacher_steps)
    elif kind in SAMPLER_KINDS:
        schedule = make_schedule(kind, num_steps)
    else:
        raise ValueError(f"unknown sampler kind {kind!r}; choose from "
                         f"{SAMPLER_KINDS} or 'consistency'")
    spec = schedule.spec(latents)
    return SlotSampler(spec=spec, num_steps=int(spec["timesteps"].shape[0]),
                       has_aux=len(spec["init"](latents[:1])) > 1)
