"""Diffusion training and consistency distillation on one device.

Port of ``cassmantle_tpu/parallel/train.py``. The reference's trainers are
functional (params and optimizer state in, new ones out, one jitted step);
these own their modules and optimizer state and update them in place.

- :func:`make_optimizer`: optax's ``chain(clip_by_global_norm(1.0),
  adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01))``, written
  out (:class:`ClipAdamW`): clip by the global norm only when it reaches
  the limit, with no epsilon; eps outside the square root; the decoupled
  decay on every parameter, biases and norms included.
- **Mixed precision.** Parameters, gradients and optimizer state are
  fp32. Compute runs in the config's dtype through each layer's cast at
  use (``models/layers.py``), as Flax's ``promote_dtype`` does; no
  autocast.
- **Attention.** Every forward that is differentiated runs inside
  ``ops/attention.py::plain_only``: the flash kernel has no backward.
  Forwards that are not differentiated (the distillation teacher's and
  the EMA target's) keep the kernel on the card.
- **Remat.** ``torch.utils.checkpoint(..., use_reentrant=False)`` around
  the whole model forward, as ``jax.checkpoint(model.apply)``; the
  checkpointed function enters ``plain_only`` itself, so the recompute,
  which runs in the backward, takes the same route.
- **Draws.** A step draws from the ``torch.Generator`` it is given (t and
  noise; n and noise); ``step_at`` takes the draws themselves, which is
  how the parity tests feed the reference step's draws in.
- **Devices.** One. A mesh of more than one device raises
  ``NotImplementedError``: training over a mesh is ROADMAP Queue 1 item
  16's training half (its serving half, ``parallel/mesh.py`` and
  ``parallel/spatial.py``, serves over dp and sp).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.ops.attention import plain_only
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device

# optax.chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.999,
# eps=1e-8, weight_decay=0.01))
MAX_GRAD_NORM = 1.0
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01
# the pipelines' seed offset of the UNet (serving/pipeline.py::INIT_SEEDS)
UNET_INIT_SEED = 2

Mesh = Union[None, Mapping[str, int], Sequence[int]]


def require_one_device(mesh: Mesh) -> None:
    """Refuse a mesh of more than one device: the port trains on one
    (``mesh`` is None, or axis sizes as a mapping or a sequence)."""
    if mesh is None:
        return
    sizes = list(mesh.values()) if isinstance(mesh, Mapping) else list(mesh)
    if int(np.prod(sizes)) != 1:
        raise NotImplementedError(
            f"mesh {mesh}: the port trains on one device; data, tensor and "
            f"sequence parallel training are ROADMAP Queue 1 item 16's "
            f"training half")


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator, from (seed, step) alone (the
    counterpart of ``jax.random.fold_in(root, step)``): a run resumed at
    step N draws what an uninterrupted run draws there."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def step_generator(seed: int, step: int,
                   device: DeviceLike) -> torch.Generator:
    return torch.Generator(device).manual_seed(step_seed(seed, step))


class ClipAdamW:
    """Global-norm clipping then AdamW over named fp32 parameters, reading
    each one's ``.grad``. ``state_dict`` is flat (``count``, ``mu.<name>``,
    ``nu.<name>``), so a checkpoint writes it as safetensors."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: float) -> None:
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def clipped_grads(self) -> list:
        """optax ``clip_by_global_norm``: g unchanged while the global norm
        is below ``MAX_GRAD_NORM``, else g / norm * MAX_GRAD_NORM (no host
        read)."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise RuntimeError(f"no gradient for {missing[:4]} "
                               f"({len(missing)} parameters)")
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < MAX_GRAD_NORM
        return [torch.where(keep, g, g / norm * MAX_GRAD_NORM)
                for g in grads]

    @torch.no_grad()
    def step(self) -> None:
        grads = self.clipped_grads()
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - B2))
        del grads
        dev = self.params[0].device
        # optax's bias corrections, fp32; divided by a device tensor (CUDA
        # turns a divide by a Python number into a reciprocal multiply)
        bc1, bc2 = (torch.tensor(1.0 - np.float32(b) ** np.float32(
            self.count), dtype=torch.float32, device=dev) for b in (B1, B2))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        del denom
        torch._foreach_add_(update, torch._foreach_mul(
            self.params, WEIGHT_DECAY))
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for n, m, v in zip(self.names, self.mu, self.nu):
            out[f"mu.{n}"], out[f"nu.{n}"] = m, v
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        want = {"count"} | {f"{k}.{n}" for n in self.names for k in ("mu",
                                                                    "nu")}
        if set(state) != want:
            raise ValueError(f"optimizer state keys differ: missing "
                             f"{sorted(want - set(state))[:4]}, unexpected "
                             f"{sorted(set(state) - want)[:4]}")
        self.count = int(state["count"])
        for n, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state[f"mu.{n}"])
            v.copy_(state[f"nu.{n}"])


def make_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   lr: float = 1e-4) -> ClipAdamW:
    return ClipAdamW(named_params, lr)


def _plain_forward(model: torch.nn.Module, *args):
    with plain_only():
        return model(*args)


def differentiated_forward(model: torch.nn.Module, remat: bool, *args):
    """``model(*args)`` inside ``plain_only``; under ``remat`` checkpointed
    (non-reentrant), its recompute entering ``plain_only`` too."""
    if remat:
        return checkpoint(_plain_forward, model, *args, use_reentrant=False)
    return _plain_forward(model, *args)


def build_unet(cfg: FrameworkConfig, device: torch.device, seed: int,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None
               ) -> UNet:
    """An fp32 UNet on ``device``: ``state_dict``, or the pipelines'
    seeded init (the same weights a pipeline at this seed serves)."""
    with torch.device(device):
        unet = UNet(cfg.models.unet)
    if state_dict is not None:
        unet.load_state_dict(state_dict)
    else:
        init_weights(unet, torch.Generator(device).manual_seed(
            seed + UNET_INIT_SEED))
    return unet.float()


def train_alpha_bars(num_train_steps: int, device) -> torch.Tensor:
    """ᾱ as the reference's trainer computes it: fp32 betas
    ``linspace(0.00085**0.5, 0.012**0.5, T) ** 2``, fp32 cumprod."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_train_steps,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def batch_to(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy or tensors) -> fp32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, torch.float32)
        for k, v in batch.items()}


class DiffusionTrainer:
    """The UNet's denoising loss: t ~ U[0, T), x_t = sqrt(ᾱ) x0 +
    sqrt(1 - ᾱ) noise, MSE of the predicted against the true noise."""

    def __init__(self, cfg: FrameworkConfig, mesh: Mesh = None,
                 lr: float = 1e-4, num_train_steps: int = 1000,
                 remat: bool = False, device: DeviceLike = "cuda") -> None:
        require_one_device(mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = lr
        self.remat = remat
        self.num_train_steps = num_train_steps
        self.alpha_bars = train_alpha_bars(num_train_steps, self.device)
        self.unet: Optional[UNet] = None
        self.optimizer: Optional[ClipAdamW] = None

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> None:
        """The UNet (``state_dict`` or the seeded init) and fresh
        optimizer state."""
        self.unet = build_unet(self.cfg, self.device, seed, state_dict)
        self.optimizer = make_optimizer(self.unet.named_parameters(),
                                        self.lr)

    def place_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return batch_to(batch, self.device)

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        lat = batch["latents"]
        t = torch.randint(0, self.num_train_steps, (lat.shape[0],),
                          generator=generator, device=self.device,
                          dtype=torch.int64).to(torch.int32)
        noise = torch.randn(lat.shape, generator=generator,
                            device=self.device, dtype=lat.dtype)
        return t, noise

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor],
                       t: torch.Tensor, noise: torch.Tensor
                       ) -> torch.Tensor:
        """The loss at draws (t, noise), its gradients left in each
        parameter's ``.grad``."""
        lat, ctx = batch["latents"], batch["context"]
        a = self.alpha_bars[t.long()][:, None, None, None]
        noisy = torch.sqrt(a) * lat + torch.sqrt(1.0 - a) * noise
        self.optimizer.zero_grad()
        pred = differentiated_forward(self.unet, self.remat, noisy, t, ctx)
        loss = torch.mean((pred - noise) ** 2)
        loss.backward()
        return loss.detach()

    def step_at(self, batch: Mapping[str, torch.Tensor], t: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        loss = self.loss_and_grads(batch, t, noise)
        self.optimizer.step()
        return loss

    def step(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        """One step; the loss stays on the device."""
        return self.step_at(batch, *self.draws(batch, generator))

    def model_state(self) -> Dict[str, torch.Tensor]:
        return self.unet.state_dict()

    def load_model_state(self, state: Mapping[str, torch.Tensor]) -> None:
        self.unet.load_state_dict(state)


def coverage_error(solver_steps: int, skip: int,
                   max_serve_steps: int) -> Optional[str]:
    """The reference's checks of (skip, solver_steps, max_serve_steps),
    or None. ``ConsistencySchedule`` queries grid indices (L // m) j,
    j < m, over the L = solver_steps - 1 points with t > 0; training
    queries student positions n <= solver_steps - 1 - skip. Every schedule
    of num_steps <= max_serve_steps must stay inside what training
    visits."""
    if not 1 <= skip < solver_steps:
        return f"skip {skip} outside [1, {solver_steps})"
    grid_len = solver_steps - 1
    worst = max((grid_len // m) * (m - 1)
                for m in range(1, min(max_serve_steps, grid_len) + 1))
    if worst > solver_steps - 1 - skip:
        return (f"skip {skip} leaves serving schedules uncovered: a "
                f"num_steps<={max_serve_steps} ConsistencySchedule queries "
                f"grid index {worst} but training only queries up to "
                f"{solver_steps - 1 - skip}; lower skip or max_serve_steps")
    return None


class ConsistencyDistillTrainer:
    """Consistency (LCM) distillation of a frozen teacher UNet into a
    few-step student of the same architecture.

    A step noises the clean latents to schedule position n, runs the
    teacher and one deterministic DDIM transition (``ops/ddim.py::
    ddim_update``) ``skip`` positions down the ``solver_steps`` grid, and
    pulls the student's boundary-parameterized estimate f(x_n, t_n)
    (``ops/samplers.py::consistency_boundary``) toward the EMA target's
    f(x_k, t_k). The EMA is then updated from the *new* student: ema =
    d ema + (1 - d) student. The student and the EMA start as copies of
    the teacher, so the student's ``state_dict`` is a UNet checkpoint the
    pipelines serve as it is.

    The constructor refuses (ValueError) a skip outside [1, solver_steps)
    and one whose trained range misses a schedule of up to
    ``max_serve_steps`` steps (the serving-coverage contract).
    """

    def __init__(self, cfg: FrameworkConfig, mesh: Mesh = None,
                 lr: float = 1e-4, solver_steps: Optional[int] = None,
                 skip: int = 1, ema_decay: float = 0.95,
                 sigma_data: float = 0.5, num_train_steps: int = 1000,
                 remat: bool = False, max_serve_steps: int = 8,
                 device: DeviceLike = "cuda") -> None:
        from cassmantle_tpu_torch.ops.ddim import (
            DDIMSchedule,
            alpha_bars_full,
        )

        require_one_device(mesh)
        solver_steps = (solver_steps if solver_steps is not None
                        else cfg.sampler.consistency_teacher_steps)
        err = coverage_error(solver_steps, skip, max_serve_steps)
        if err is not None:
            raise ValueError(err)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = lr
        self.remat = remat
        self.solver_steps = solver_steps
        self.skip = skip
        self.ema_decay = float(ema_decay)
        self.sigma_data = float(sigma_data)
        sched = DDIMSchedule.create(solver_steps, num_train_steps)
        self.timesteps = torch.from_numpy(
            sched.timesteps.astype(np.int32)).to(self.device)
        self.alpha_bars = torch.from_numpy(sched.alpha_bars).to(self.device)
        ab_full = alpha_bars_full(num_train_steps)
        self.sigma_min = float(np.sqrt((1.0 - ab_full[0]) / ab_full[0]))
        self.teacher: Optional[UNet] = None
        self.student: Optional[UNet] = None
        self.ema: Optional[UNet] = None
        self.optimizer: Optional[ClipAdamW] = None

    def init_state(self, teacher_state: Optional[Mapping[str, torch.Tensor]]
                   = None, seed: int = 0) -> None:
        """The frozen teacher (``teacher_state`` or the seeded init), and
        the student and EMA as copies of it, with fresh optimizer state."""
        teacher = build_unet(self.cfg, self.device, seed, teacher_state)
        self.teacher = teacher.requires_grad_(False).eval()
        self.student = copy.deepcopy(teacher).requires_grad_(True)
        self.ema = copy.deepcopy(teacher)
        self.optimizer = make_optimizer(self.student.named_parameters(),
                                        self.lr)

    def place_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return batch_to(batch, self.device)

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        lat = batch["latents"]
        n = torch.randint(0, self.timesteps.shape[0] - self.skip,
                          (lat.shape[0],), generator=generator,
                          device=self.device)
        noise = torch.randn(lat.shape, generator=generator,
                            device=self.device, dtype=lat.dtype)
        return n, noise

    def consistency_f(self, model: UNet, x: torch.Tensor, t: torch.Tensor,
                      ab: torch.Tensor, context: torch.Tensor,
                      differentiated: bool) -> torch.Tensor:
        """f(x, t) = c_skip x + c_out x0_pred, the form the serving
        sampler evaluates (``ops/samplers.py``)."""
        from cassmantle_tpu_torch.ops.samplers import consistency_boundary

        eps = (differentiated_forward(model, self.remat, x, t, context)
               if differentiated else model(x, t, context))
        x0 = (x - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)
        sigma = torch.sqrt((1.0 - ab) / ab)
        c_skip, c_out = consistency_boundary(sigma, self.sigma_min,
                                             self.sigma_data)
        return c_skip * x + c_out * x0

    def target_at(self, batch: Mapping[str, torch.Tensor], n: torch.Tensor,
                  noise: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(x_n, t_n, ᾱ_n, target): the teacher's strided DDIM step from
        x_n and the EMA's f at its end. Not differentiated: on the card
        both forwards launch the flash kernel."""
        from cassmantle_tpu_torch.ops.ddim import ddim_update

        lat, ctx = batch["latents"], batch["context"]
        k = n + self.skip
        t_n, t_k = self.timesteps[n], self.timesteps[k]
        ab_n = self.alpha_bars[n][:, None, None, None]
        ab_k = self.alpha_bars[k][:, None, None, None]
        x_n = torch.sqrt(ab_n) * lat + torch.sqrt(1.0 - ab_n) * noise
        with torch.no_grad():
            eps_teacher = self.teacher(x_n, t_n, ctx)
            x_k = ddim_update(x_n, eps_teacher, torch.sqrt(1.0 - ab_n),
                              torch.sqrt(ab_n), torch.sqrt(ab_k),
                              torch.sqrt(1.0 - ab_k))
            target = self.consistency_f(self.ema, x_k, t_k, ab_k, ctx,
                                        differentiated=False)
        return x_n, t_n, ab_n, target

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor],
                       n: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        x_n, t_n, ab_n, target = self.target_at(batch, n, noise)
        self.optimizer.zero_grad()
        pred = self.consistency_f(self.student, x_n, t_n, ab_n,
                                  batch["context"], differentiated=True)
        loss = torch.mean((pred - target) ** 2)
        loss.backward()
        return loss.detach()

    @torch.no_grad()
    def update_ema(self) -> None:
        d = self.ema_decay
        for e, s in zip(self.ema.parameters(), self.student.parameters()):
            e.mul_(d).add_(s * (1.0 - d))

    def step_at(self, batch: Mapping[str, torch.Tensor], n: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        loss = self.loss_and_grads(batch, n, noise)
        self.optimizer.step()
        self.update_ema()
        return loss

    def step(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        """One distillation step; the loss stays on the device."""
        return self.step_at(batch, *self.draws(batch, generator))

    def model_state(self) -> Dict[str, torch.Tensor]:
        return {**{f"student.{k}": v
                   for k, v in self.student.state_dict().items()},
                **{f"ema.{k}": v for k, v in self.ema.state_dict().items()}}

    def load_model_state(self, state: Mapping[str, torch.Tensor]) -> None:
        for name, model in (("student", self.student), ("ema", self.ema)):
            prefix = f"{name}."
            model.load_state_dict({k[len(prefix):]: v for k, v in
                                   state.items() if k.startswith(prefix)})
