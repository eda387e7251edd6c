"""DDIM sampler with classifier-free guidance, and the captured loops.

Port of the main sampler of ``cassmantle_tpu/ops/ddim.py``. The reference
compiles the 50 steps into one ``lax.scan``: each step reads its
timestep and coefficients from the schedule arrays by the scan's index,
with no host round trip. The port keeps the same loop state on the
device: :meth:`DDIMSchedule.coefficients` uploads the timesteps and the
per-step coefficients once (:meth:`DDIMSchedule.spec`), and
:func:`spec_step` reads step i's values by a gather at a step counter
held in a device tensor, which it advances in place. That step runs
eagerly in :func:`ddim_sample` (the CPU path, and the card's reference
run) and, on the card, as the replays of one captured CUDA graph in
:class:`SpecGraph`, the counterpart of the reference's jitted scan. Both
run the same arithmetic.

The coefficients are fp32, taken in numpy float32 as the reference's
fp32 schedule arrays give them (sqrt is correctly rounded); the latents
stay fp32 (B, H, W, 4) NHWC. The update divides by a device tensor, an
IEEE division on every device (CUDA computes a division by a host scalar
as a multiply by its reciprocal). CFG runs the unconditional and
conditional halves as one 2B UNet batch; SDXL's micro-conditioning
vector rides the same batch as the context.

The reference's two feature-reuse loops are here too, on the same
device step counter:

- DeepCache (:func:`ddim_sample_deepcache`): steps in full/shallow
  pairs, the shallow pass reusing the full pass's deep activation;
- encoder propagation (:func:`encprop_sample` with :func:`ddim_spec`):
  full forwards at the key steps of :func:`encprop_key_indices` (a dense
  prefix, then one a segment of ``stride`` steps), the rest of each
  segment from ONE decoder-only forward at batch P x 2B against the key
  step's skip stack and up-path entry; optionally the second step of a
  segment as a DeepCache shallow pass.

At eta > 0 (:func:`ddim_sample` with a key) the step adds
sigma_t-scaled noise drawn from the reference's ``split`` chain
(``utils/jax_random.py``), all steps' noise before the loop.

A solver "spec" (:func:`ddim_spec`; Euler's, DPM-Solver++(2M)'s and the
consistency sampler's in ``ops/samplers.py``) is the device form of a
schedule that the generic loops step through: the timesteps, the
per-step coefficient columns, ``init(latents) -> carry`` (a tuple of
latent-shaped tensors: DPM++ carries its multistep history beside x),
``x_for`` and ``update``; a loop's result is the carry's first tensor,
x. :func:`spec_step_outputs` is one step of it.

On the card each loop replays captured bodies (:class:`SamplerGraph`,
whose carry is static buffers that each call resets and each body
writes in place): a spec's one step graph (:class:`SpecGraph`);
DeepCache one pair graph (and an unpaired tail graph for an odd DPM++
count; :class:`SpecDeepCacheGraph`); encprop a key-step graph (the
dense prefix) and a segment graph (key forward, decoder-only forward,
``stride`` updates), plus a tail graph where ``stride`` does not divide
the steps after the prefix, as the reference compiles a dense scan, a
segment scan and an unrolled tail.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.ops.graphs import CapturedStep
from cassmantle_tpu_torch.utils import jax_random

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
               beta_start: float = 0.00085, beta_end: float = 0.012,
               start: int = 0) -> "DDIMSchedule":
        """``start`` > 0 drops the first steps (img2img tails)."""
        ab_full = alpha_bars_full(num_train_steps, beta_start, beta_end)
        ts = strided_timesteps(num_steps, num_train_steps)[start:]
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

    def spec(self, latents: torch.Tensor) -> dict:
        """The eta-0 solver spec on ``latents``' device."""
        return ddim_spec(self.coefficients(latents.device))

    def eta_spec(self, eta: float, noise: torch.Tensor) -> dict:
        """The solver spec at ``eta`` > 0 over the step noise ``noise``
        (T, B, H, W, 4): sigma_t = eta sqrt((1 - ᾱ_prev) / (1 - ᾱ_t))
        sqrt(1 - ᾱ_t / ᾱ_prev) and the direction's sqrt(max(1 - ᾱ_prev -
        sigma_t^2, 0)), in float32 as the reference's scan computes them."""
        one, zero = np.float32(1.0), np.float32(0.0)
        a_t, a_prev = self.alpha_bars, self.alpha_bars_prev
        sigma = (np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t))
                 * np.sqrt(one - a_t / a_prev))
        table = np.stack([np.sqrt(one - a_t), np.sqrt(a_t), np.sqrt(a_prev),
                          np.sqrt(np.maximum(one - a_prev - sigma * sigma,
                                             zero)), sigma], axis=1)
        dev = noise.device
        cols = torch.from_numpy(table.astype(np.float32)).to(dev).unbind(1)

        def update(carry, eps, c):
            x = ddim_update(carry[0], eps, *c[:4])
            return (x + c[4] * c[5][0],)

        return {"timesteps": torch.from_numpy(
                    self.timesteps.astype(np.int32)).to(dev),
                "coefs": cols + (noise,),
                "init": lambda latents: (latents,),
                "x_for": lambda carry, c: carry[0],
                "update": update}


def ddim_update(x: torch.Tensor, eps: torch.Tensor, c_eps: torch.Tensor,
                c_x: torch.Tensor, c_x0: torch.Tensor,
                c_dir: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM transition x_t -> x_{t-1}; the coefficients
    are fp32 tensors on x's device (0-dim or (1,))."""
    x0 = (x - c_eps * eps) / c_x
    return c_x0 * x0 + c_dir * eps


def ddim_step_noise(key: torch.Tensor, num_steps: int,
                    shape: Sequence[int]) -> torch.Tensor:
    """(T, *shape) step noise of the reference's eta > 0 loop, on
    ``key``'s device: each step splits the carried key and draws
    ``normal(sub, shape)``."""
    out = []
    for _ in range(num_steps):
        key, sub = jax_random.split(key)
        out.append(jax_random.normal(sub, shape))
    return torch.stack(out)


def ddim_sample(denoise: Denoiser, latents: torch.Tensor,
                schedule: DDIMSchedule, eta: float = 0.0,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the DDIM loop eagerly, one :func:`spec_step` a step:
    ``denoise(x_t, t)`` predicts the (guided) noise; ``latents`` is x_T.
    Returns the final latents. At ``eta`` > 0 each step adds noise drawn
    from ``key`` (a ``utils/jax_random`` key) as the reference's
    ``split`` chain draws it; eta 0 draws nothing."""
    if eta > 0.0:
        if key is None:
            raise ValueError("eta > 0 requires an rng key")
        noise = ddim_step_noise(key.to(latents.device),
                                len(schedule.timesteps), latents.shape)
        return sample_spec(schedule.eta_spec(eta, noise), denoise, latents)
    return sample_spec(schedule.spec(latents), denoise, latents)


def spec_step_outputs(spec: dict, denoise: Callable, carry: tuple,
                      step: torch.Tensor) -> Tuple[tuple, tuple]:
    """One step of solver ``spec`` at device ``step`` (advanced by one):
    the timestep and coefficients gathered there, one call of
    ``denoise(x, t) -> (eps, *outputs)`` on ``x_for(carry)``, ``update``.
    Returns (carry, outputs): a key step's encoder cache, a full step's
    deep activation."""
    t, coefs = _spec_at(spec, step)
    eps, *outputs = denoise(spec["x_for"](carry, coefs), t)
    carry = spec["update"](carry, eps, coefs)
    step.add_(1)
    return carry, tuple(outputs)


def spec_step(spec: dict, denoise: Denoiser, carry: tuple,
              step: torch.Tensor) -> tuple:
    """:func:`spec_step_outputs` over a denoiser that returns eps alone;
    returns the carry."""
    return spec_step_outputs(spec, lambda x, t: (denoise(x, t),), carry,
                             step)[0]


def sample_spec(spec: dict, denoise: Denoiser,
                latents: torch.Tensor) -> torch.Tensor:
    """Solver ``spec``'s whole loop, eagerly, one :func:`spec_step` a
    step from ``init(latents)``; returns x."""
    step = torch.zeros((1,), dtype=torch.long, device=latents.device)
    carry = spec["init"](latents)
    for _ in range(int(spec["timesteps"].shape[0])):
        carry = spec_step(spec, denoise, carry, step)
    return carry[0]


class SamplerGraph:
    """A sampler loop as replays of captured bodies, the counterpart of
    the reference's jitted scans.

    ``phases`` lists ``(name, count, start, body)`` in loop order:
    ``body(denoisers, carry, step)`` advances the carry (a tuple of
    latent-shaped tensors) from the step that the device counter
    ``step`` names, and the counter with it, and returns the new carry;
    it is captured once (the counter set to ``start``, the phase's first
    step, for the warm-up) and replayed ``count`` times.
    ``make_denoisers(**inputs)`` builds what the bodies call, over
    static copies of ``inputs`` (the example call's), which each call
    overwrites in place. ``init(latents)`` (default: ``(latents,)``)
    makes the carry from x_T; the carry (``carry``, ``x`` its first
    tensor) and the counter are static buffers too, written in place by
    each body. A call copies the inputs in, sets the carry from x_T,
    resets the counter and replays every phase: no host copy and no
    sync between replays; it returns a copy of ``x``. ``phases`` keeps
    ``(name, count, start, graph)`` of each phase that runs, ``graphs``
    each one's :class:`CapturedStep` by name."""

    def __init__(self, make_denoisers: Callable[..., object],
                 phases: Sequence[Tuple[str, int, int, Callable]],
                 latents: torch.Tensor,
                 init: Optional[Callable[[torch.Tensor], tuple]] = None,
                 **inputs: Optional[torch.Tensor]):
        dev = latents.device
        self.init = init or (lambda lat: (lat,))
        self.inputs: Dict[str, torch.Tensor] = {
            k: v.clone() for k, v in inputs.items() if v is not None}
        self.carry = tuple(t.to(torch.float32, copy=True)
                           for t in self.init(latents))
        self.x = self.carry[0]
        self.step = torch.zeros((1,), dtype=torch.long, device=dev)
        denoisers = make_denoisers(**self.inputs)
        self.phases: List[Tuple[str, int, int, CapturedStep]] = []
        self.graphs: Dict[str, CapturedStep] = {}
        for name, count, start, body in phases:
            if count <= 0:
                continue

            def fn(body=body) -> tuple:
                out = body(denoisers, self.carry, self.step)
                for buf, value in zip(self.carry, out):
                    buf.copy_(value)
                return self.carry

            self.step.fill_(start)
            graph = CapturedStep(fn, reset=lambda start=start:
                                 self.step.fill_(start))
            self.phases.append((name, count, start, graph))
            self.graphs[name] = graph

    def reset(self, latents: torch.Tensor, start: int = 0) -> None:
        """Set the carry from x_T ``latents`` and the counter to
        ``start``."""
        for buf, value in zip(self.carry, self.init(latents)):
            buf.copy_(value)
        self.step.fill_(start)

    def __call__(self, latents: torch.Tensor,
                 **inputs: Optional[torch.Tensor]) -> torch.Tensor:
        for k, v in inputs.items():
            if v is not None:
                self.inputs[k].copy_(v)
        self.reset(latents)
        for _, count, _, graph in self.phases:
            for _ in range(count):
                graph.replay()
        return self.x.clone()


class SpecGraph(SamplerGraph):
    """:func:`sample_spec` with one captured graph of :func:`spec_step`
    (``graph``), replayed once a step; the warm-up runs step 0 on the
    example call's x_T. ``schedule.spec(latents)`` gives the solver spec
    (DDIM, Euler, DPM++, consistency, an img2img tail), whose ``init``
    makes the carry; ``make_denoise(**inputs)`` builds the denoiser over
    the conditioning tensors it is given."""

    def __init__(self, make_denoise: Callable[..., Denoiser], schedule,
                 latents: torch.Tensor, **inputs: Optional[torch.Tensor]):
        spec = schedule.spec(latents)
        self.num_steps = int(spec["timesteps"].shape[0])
        super().__init__(
            make_denoise,
            [("step", self.num_steps, 0,
              lambda denoise, carry, step: spec_step(spec, denoise, carry,
                                                     step))],
            latents, init=spec["init"], **inputs)
        self.graph = self.graphs["step"]


# -- DeepCache ----------------------------------------------------------------

# full(x, t) -> (guided eps, deep activation); shallow(x, t, deep) -> eps
DenoiserPair = Tuple[Callable, Callable]


def check_deepcache_steps(num_steps: int) -> None:
    if num_steps % 2:
        raise ValueError(f"deepcache pairing needs an even step count, got "
                         f"{num_steps}")


def ddim_sample_deepcache(denoise_full: Callable, denoise_shallow: Callable,
                          latents: torch.Tensor,
                          schedule: DDIMSchedule) -> torch.Tensor:
    """DDIM (eta 0) in full/shallow pairs, eagerly, one
    :func:`deepcache_spec_pair` a pair; even step count."""
    check_deepcache_steps(len(schedule.timesteps))
    return sample_spec_deepcache(schedule.spec(latents), denoise_full,
                                 denoise_shallow, latents)


def deepcache_spec_pair(spec: dict, pair: DenoiserPair, carry: tuple,
                        step: torch.Tensor) -> tuple:
    """Two :func:`spec_step`s of solver ``spec`` from device ``step``: a
    full forward, then a shallow one reusing its deep activation; the
    carry (DPM++'s multistep history with it) threads through both."""
    full, shallow = pair
    carry, (deep,) = spec_step_outputs(spec, full, carry, step)
    return spec_step(spec, lambda x, t: shallow(x, t, deep), carry, step)


def deepcache_spec_tail(spec: dict, pair: DenoiserPair, carry: tuple,
                        step: torch.Tensor) -> tuple:
    """The unpaired full step that ends an odd count."""
    return spec_step_outputs(spec, pair[0], carry, step)[0]


def sample_spec_deepcache(spec: dict, denoise_full: Callable,
                          denoise_shallow: Callable,
                          latents: torch.Tensor) -> torch.Tensor:
    """Solver ``spec`` in full/shallow pairs, eagerly; an odd count ends
    on an unpaired full step."""
    n = int(spec["timesteps"].shape[0])
    pair = (denoise_full, denoise_shallow)
    step = torch.zeros((1,), dtype=torch.long, device=latents.device)
    carry = spec["init"](latents)
    for _ in range(n // 2):
        carry = deepcache_spec_pair(spec, pair, carry, step)
    if n % 2:
        carry = deepcache_spec_tail(spec, pair, carry, step)
    return carry[0]


class SpecDeepCacheGraph(SamplerGraph):
    """:func:`sample_spec_deepcache` as a captured pair graph (full,
    update, shallow, update) replayed T // 2 times and, for an odd T
    (DPM++), a captured tail graph (one full step) replayed once.
    ``make_pair(**inputs)`` returns (full, shallow)."""

    def __init__(self, make_pair: Callable[..., DenoiserPair], schedule,
                 latents: torch.Tensor, **inputs: Optional[torch.Tensor]):
        spec = schedule.spec(latents)
        n = int(spec["timesteps"].shape[0])
        super().__init__(make_pair, [
            ("pair", n // 2, 0, lambda pair, carry, step:
             deepcache_spec_pair(spec, pair, carry, step)),
            ("tail", n % 2, n - 1, lambda pair, carry, step:
             deepcache_spec_tail(spec, pair, carry, step))],
            latents, init=spec["init"], **inputs)


# -- encoder propagation (Faster Diffusion) -----------------------------------
#
# The UNet's encoder (conv_in, the down levels, the mid block) drifts
# slowly across adjacent steps, and the decoder never reads x_t: a
# propagated step's eps depends only on the key step's encoder cache and
# its own timestep, so a segment's propagated steps batch into one
# decoder forward.


def encprop_disabled() -> bool:
    """True when CASSMANTLE_NO_ENCPROP is set to a truthy value: an
    encprop-configured pipeline built then serves full forwards at every
    step."""
    return os.environ.get("CASSMANTLE_NO_ENCPROP", "").lower() \
        not in ("", "0", "false", "no", "off")


def encprop_key_indices(num_steps: int, stride: int,
                        dense_steps: int = 0) -> np.ndarray:
    """Key-step indices: the first ``dense_steps`` steps, then every
    ``stride``-th step (step 0 always a key)."""
    if stride < 1:
        raise ValueError(f"encprop stride must be >= 1, got {stride}")
    if not 0 <= dense_steps <= num_steps:
        raise ValueError(f"dense_steps {dense_steps} outside "
                         f"[0, {num_steps}]")
    dense = list(range(dense_steps))
    rest = list(range(dense_steps, num_steps, stride))
    return np.asarray(dense + rest, dtype=np.int64)


def _encprop_plan(num_steps: int, stride: int, dense_steps: int):
    """(dense prefix length, full-segment count, tail length)."""
    rest = num_steps - dense_steps
    return dense_steps, rest // stride, rest % stride


def encprop_step_counts(num_steps: int, stride: int, dense_steps: int,
                        deepcache: bool = False):
    """(key, shallow, propagated) forwards of a schedule. Composed with
    DeepCache, the second step of each segment of two or more steps runs
    shallow (it reads x_t) and is not a propagated step."""
    keys = len(encprop_key_indices(num_steps, stride, dense_steps))
    shallow = 0
    if deepcache:
        _, nseg, tail = _encprop_plan(num_steps, stride, dense_steps)
        shallow = (nseg if stride >= 2 else 0) + (1 if tail >= 2 else 0)
    return keys, shallow, num_steps - keys - shallow


def ddim_spec(coeffs: DDIMCoefficients) -> dict:
    """DDIM's solver spec for :func:`encprop_sample`, on the device: the
    timesteps, the coefficient columns (c_eps, c_x, c_x0, c_dir), a
    one-tensor carry and :func:`ddim_update`."""
    return {
        "timesteps": coeffs.timesteps,
        "coefs": coeffs.table.unbind(dim=1),
        "init": lambda latents: (latents,),
        "x_for": lambda carry, coefs_i: carry[0],
        "update": lambda carry, eps, coefs_i: (
            ddim_update(carry[0], eps, *coefs_i),),
    }


def _spec_at(spec: dict, index: torch.Tensor):
    """The timesteps and coefficients at device ``index``."""
    return (spec["timesteps"].index_select(0, index),
            tuple(a.index_select(0, index) for a in spec["coefs"]))


def _per_slot(column: torch.Tensor) -> torch.Tensor:
    """A gathered coefficient column (w,) as (w, 1, 1, 1), to broadcast
    over the slots' latents; a per-step latent row (w, H, W, C), the
    consistency re-noise ladder's, stays as it is."""
    return column.view(-1, 1, 1, 1) if column.dim() == 1 else column


def slot_spec_at(spec: dict, steps: torch.Tensor):
    """:func:`_spec_at` for slots at their own schedule positions: the
    timesteps (w,) and each coefficient column gathered at ``steps`` (w,)
    long, one per slot, shaped for broadcasting (:func:`_per_slot`)."""
    return (spec["timesteps"].index_select(0, steps),
            tuple(_per_slot(a.index_select(0, steps))
                  for a in spec["coefs"]))


def slot_spec_step(spec: dict, denoise: Denoiser, carry: tuple,
                   steps: torch.Tensor) -> tuple:
    """One step of solver ``spec`` for slots that each sit at their own
    step ``steps`` (w,): the spec's own ``x_for`` and ``update`` on the
    coefficients gathered per slot, ``denoise(x, t (w,))`` once. A solo
    slot computes :func:`spec_step`'s arithmetic value for value; the
    caller advances the counters."""
    t, coefs = slot_spec_at(spec, steps)
    eps = denoise(spec["x_for"](carry, coefs), t)
    return spec["update"](carry, eps, coefs)


def encprop_segment(spec: dict, denoise_key: Callable,
                    denoise_prop: Callable,
                    denoise_shallow: Optional[Callable], carry: tuple,
                    step: torch.Tensor, length: int,
                    batch_props: bool = True) -> tuple:
    """One segment of ``length`` steps from device ``step`` (advanced by
    ``length``): its key step, the DeepCache shallow step where
    ``denoise_shallow`` is given, and the rest off one batched decoder
    forward (``batch_props=False``: one decoder forward a step)."""
    carry, (cache, *rest) = spec_step_outputs(spec, denoise_key, carry,
                                              step)
    start = 1
    if denoise_shallow is not None and length > 1:
        carry = spec_step(spec, lambda x, t: denoise_shallow(x, t, rest[0]),
                          carry, step)
        start = 2
    p = length - start
    if p > 0 and batch_props:
        offsets = torch.arange(p, device=step.device)
        eps_all = denoise_prop(cache,
                               spec["timesteps"].index_select(0, step
                                                              + offsets))
    for j in range(p):
        t, coefs = _spec_at(spec, step)
        eps = eps_all[j] if batch_props else denoise_prop(cache, t)[0]
        carry = spec["update"](carry, eps, coefs)
        step.add_(1)
    return carry


def encprop_sample(spec: dict, denoise_key: Callable, denoise_prop: Callable,
                   latents: torch.Tensor, stride: int, dense_steps: int = 0,
                   denoise_shallow: Optional[Callable] = None,
                   batch_props: bool = True) -> torch.Tensor:
    """The encoder-propagation loop, eagerly, on a device step counter:
    ``dense_steps`` key steps, then segments of ``stride`` steps (a key
    step and ``stride - 1`` propagated ones), then a shorter tail.

    ``denoise_key(x, t) -> (eps, cache[, deep])``;
    ``denoise_prop(cache, ts (P,)) -> (P, B, ...)`` eps;
    ``denoise_shallow(x, t, deep)`` composes DeepCache (``denoise_key``
    then returns the deep activation too). At stride 1 every step is a
    key step: the plain sampler's arithmetic."""
    n = int(spec["timesteps"].shape[0])
    dense, nseg, tail = _encprop_plan(n, stride, dense_steps)
    step = torch.zeros((1,), dtype=torch.long, device=latents.device)
    carry = spec["init"](latents)
    for _ in range(dense):
        carry, _ = spec_step_outputs(spec, denoise_key, carry, step)
    for length in [stride] * nseg + ([tail] if tail else []):
        carry = encprop_segment(spec, denoise_key, denoise_prop,
                                denoise_shallow, carry, step, length,
                                batch_props)
    return carry[0]


def ddim_sample_encprop(denoise_key: Callable, denoise_prop: Callable,
                        latents: torch.Tensor, schedule: DDIMSchedule,
                        stride: int, dense_steps: int = 0,
                        denoise_shallow: Optional[Callable] = None,
                        batch_props: bool = True) -> torch.Tensor:
    """DDIM (eta 0) with encoder propagation: :func:`encprop_sample`
    over :func:`ddim_spec`."""
    return encprop_sample(
        ddim_spec(schedule.coefficients(latents.device)), denoise_key,
        denoise_prop, latents, stride, dense_steps,
        denoise_shallow=denoise_shallow, batch_props=batch_props)


class EncpropGraph(SamplerGraph):
    """:func:`encprop_sample` as captured bodies: a key-step graph
    replayed ``dense_steps`` times, a segment graph (key forward at 2B,
    the shallow forward where composed, one decoder-only forward at
    P x 2B, ``stride`` updates; the counter advances by ``stride``)
    replayed once a segment, and a tail graph where ``stride`` does not
    divide the steps after the prefix. ``schedule.spec(latents)`` gives
    the solver (DDIM, Euler or DPM++) and its carry;
    ``make_denoisers(**inputs)`` returns (key, prop, shallow or None)."""

    def __init__(self, make_denoisers: Callable[..., tuple], schedule,
                 latents: torch.Tensor, stride: int, dense_steps: int,
                 **inputs: Optional[torch.Tensor]):
        spec = schedule.spec(latents)
        n = int(spec["timesteps"].shape[0])
        dense, nseg, tail = _encprop_plan(n, stride, dense_steps)

        def key(dn, carry, step):
            return spec_step_outputs(spec, dn[0], carry, step)[0]

        def segment(length):
            return lambda dn, carry, step: encprop_segment(
                spec, dn[0], dn[1], dn[2], carry, step, length)

        super().__init__(make_denoisers, [
            ("key", dense, 0, key),
            ("segment", nseg, dense, segment(stride)),
            ("tail", 1 if tail else 0, n - tail, segment(tail))],
            latents, init=spec["init"], **inputs)


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


def make_slot_denoiser(unet: Callable, guidance_scale: float) -> Callable:
    """The CFG denoiser of the staged step loop (serving/stages.py):
    ``denoise(x (w, ...), t (w,), context, uncond_context,
    addition_embeds=None, uncond_addition_embeds=None)``, the
    conditioning given per call (the slots' rows change between steps)
    and t one timestep a slot. Otherwise :func:`cfg_denoiser`'s 2w-batch
    CFG: the same stacking, unconditional rows first, so a solo slot's
    forward is the monolithic one's."""

    def denoise(x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                uncond_context: torch.Tensor,
                addition_embeds: Optional[torch.Tensor] = None,
                uncond_addition_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        inputs = cfg_inputs(context, uncond_context, addition_embeds,
                            uncond_addition_embeds)
        extra = (() if inputs["additions"] is None
                 else (inputs["additions"],))
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        return cfg_guide(unet(x2, t2, inputs["context"], *extra),
                         guidance_scale)

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


def cfg_denoiser_pair(unet: Callable, context: torch.Tensor,
                      guidance_scale: float,
                      additions: Optional[torch.Tensor] = None
                      ) -> DenoiserPair:
    """DeepCache's CFG pair over the stacked 2B conditioning:
    ``full(x, t)`` -> (guided eps, the 2B batch's deep activation),
    ``shallow(x, t, deep)`` -> guided eps; each guidance half reuses its
    own deep rows."""

    def full(x, t):
        x2, t2 = cfg_double(x, t)
        eps, deep = unet(x2, t2, context, additions, return_deep=True)
        return cfg_guide(eps, guidance_scale), deep

    def shallow(x, t, deep):
        x2, t2 = cfg_double(x, t)
        return cfg_guide(unet(x2, t2, context, additions, deep_cache=deep),
                         guidance_scale)

    return full, shallow


def make_cfg_denoiser_pair(unet: Callable, context: torch.Tensor,
                           uncond_context: torch.Tensor,
                           guidance_scale: float,
                           addition_embeds: Optional[torch.Tensor] = None,
                           uncond_addition_embeds: Optional[torch.Tensor]
                           = None) -> DenoiserPair:
    """:func:`cfg_denoiser_pair` over the conditioning of one call."""
    return cfg_denoiser_pair(unet, guidance_scale=guidance_scale,
                             **cfg_inputs(context, uncond_context,
                                          addition_embeds,
                                          uncond_addition_embeds))


def _tile_rows(t: torch.Tensor, p: int) -> torch.Tensor:
    """(B, ...) -> (P*B, ...), row b of copy p at p*B + b (the
    reference's ``jnp.tile``): a copy, in t's memory format."""
    return torch.cat([t] * p, dim=0)


def cfg_denoiser_encprop(unet: Callable, context: torch.Tensor,
                         guidance_scale: float,
                         additions: Optional[torch.Tensor] = None,
                         deepcache: bool = False):
    """Encoder propagation's CFG denoisers over the stacked 2B
    conditioning: (key, prop, shallow or None).

    - ``key(x, t)`` -> (guided eps, encoder cache[, deep activation]);
    - ``prop(cache, ts (P,))`` -> (P, B, H, W, 4) guided eps: the cache's
      2B rows tiled P times (copy p at timestep ts[p]), ONE decoder-only
      forward at P x 2B; each row is computed as a single step's;
    - ``shallow(x, t, deep)``: DeepCache's shallow pass, with
      ``deepcache``."""
    b2 = context.shape[0]

    def key(x, t):
        x2, t2 = cfg_double(x, t)
        if deepcache:
            eps, deep, cache = unet(x2, t2, context, additions,
                                    return_deep=True, return_skips=True)
            return cfg_guide(eps, guidance_scale), cache, deep
        eps, cache = unet(x2, t2, context, additions, return_skips=True)
        return cfg_guide(eps, guidance_scale), cache

    def prop(cache, ts):
        p = ts.shape[0]
        skips, entry = cache
        tiled = (tuple(_tile_rows(s, p) for s in skips),
                 _tile_rows(entry, p))
        t_all = ts[:, None].expand(p, b2).reshape(-1)
        eps = unet(None, t_all, _tile_rows(context, p),
                   None if additions is None else _tile_rows(additions, p),
                   skips_cache=tiled)
        eps_uncond, eps_cond = eps.reshape((p, b2) + eps.shape[1:]).chunk(
            2, dim=1)
        return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

    shallow = (cfg_denoiser_pair(unet, context, guidance_scale,
                                 additions)[1] if deepcache else None)
    return key, prop, shallow


def make_cfg_denoiser_encprop(unet: Callable, context: torch.Tensor,
                              uncond_context: torch.Tensor,
                              guidance_scale: float,
                              addition_embeds: Optional[torch.Tensor] = None,
                              uncond_addition_embeds: Optional[torch.Tensor]
                              = None, deepcache: bool = False):
    """:func:`cfg_denoiser_encprop` over the conditioning of one call."""
    return cfg_denoiser_encprop(
        unet, guidance_scale=guidance_scale, deepcache=deepcache,
        **cfg_inputs(context, uncond_context, addition_embeds,
                     uncond_addition_embeds))


def initial_latents(generator: torch.Generator, batch: int, image_size: int,
                    vae_scale: int = 8, channels: int = 4,
                    device=None) -> torch.Tensor:
    """x_T ~ N(0, I), (B, H/8, W/8, 4) fp32 NHWC."""
    h = w = image_size // vae_scale
    return torch.randn((batch, h, w, channels), generator=generator,
                       device=device, dtype=torch.float32)
