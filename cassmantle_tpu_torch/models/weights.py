"""Carry a reference (Flax) parameter tree into a port module.

``from_jax(kind, params)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (``jax.device_get`` of the Flax variables)
and returns the port module's ``state_dict``. The port names its
submodules after the Flax modules, so the mapping is mechanical:

- a Dense kernel (in, out) becomes a Linear weight (out, in);
- a Conv kernel in HWIO becomes OIHW;
- a concatenated ``qkv``/``kv`` projection keeps its layout;
- LayerNorm/GroupNorm ``scale`` and Embed ``embedding`` become ``weight``;
  ``bias`` stays ``bias``; other leaves (position tables) keep their name;
- a W8A8 kernel leaf (the reference's ``ActQTensor(data, scale,
  act_scale)``) becomes the quantized module's buffers: ``weight_q`` (the
  int8 data in the port's layout, as a kernel above), ``weight_scale``
  (along the out-channel axis) and, when static, ``act_scale``.

The VAE encoder (``vae_enc``, img2img's) maps by the same rules.
SDXL's kinds (``clip_text_2``, ``unet_xl``, ``vae_xl``) and Mistral's
(``mistral``: bias-free Dense leaves, RMSNorm ``scale``) follow the same
rules, the UNet's micro-conditioning ``add_fc1``/``add_fc2`` as Dense
leaves. bigG's optional ``text_projection`` is a bare square matrix that
the reference applies as ``pooled @ proj``; ``SDXLPipeline`` takes it as
it is, with no transpose.

Loading HF/diffusers checkpoints waits for checkpoints in the repository.

:class:`Rebuilds` keeps the recipe of each served model and runs it
again into the same tensors: the device-loss rebuild's reload.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

KINDS = ("clip_text", "clip_text_2", "unet", "unet_xl", "vae", "vae_xl",
         "vae_enc", "gpt2", "mistral", "minilm")


def _leaf(name: str, value: np.ndarray):
    value = np.asarray(value)
    if name == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {value.ndim}")
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return name, torch.from_numpy(np.array(value, order="C"))


def _is_w8a8_leaf(value) -> bool:
    return getattr(value, "_fields", None) == ("data", "scale", "act_scale")


def _walk(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{key}.", out)
        elif _is_w8a8_leaf(value):
            _, data = _leaf(key, value.data)
            out[f"{prefix}weight_q"] = data
            out[f"{prefix}weight_scale"] = torch.from_numpy(
                np.array(value.scale, dtype=np.float32).reshape(-1))
            if value.act_scale is not None:
                out[f"{prefix}act_scale"] = torch.from_numpy(
                    np.array(value.act_scale, dtype=np.float32))
        else:
            name, tensor = _leaf(key, value)
            out[f"{prefix}{name}"] = tensor


def state_dict_from_tree(params: Mapping) -> Dict[str, torch.Tensor]:
    """Any reference module's parameter tree (the Flax variables dict or
    its ``params`` collection) -> the port module's ``state_dict``."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", out)
    return out


def from_jax(kind: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """Reference parameter tree of model ``kind`` -> port ``state_dict``."""
    if kind not in KINDS:
        raise ValueError(f"unknown model kind {kind!r}; one of {KINDS}")
    return state_dict_from_tree(params)


class Rebuilds:
    """The device-loss rebuild's reload, with no resident copy of the
    weights: each served module (or tensor) is kept beside the recipe
    that built it (:meth:`add`), and :meth:`reload` runs every recipe
    again into a fresh object and copies it into the live tensors in
    place, so anything holding their addresses (the captured CUDA graphs)
    stays valid. A seeded recipe draws the same values again from its
    generator; one that loads a caller's ``state_dict`` keeps a reference
    to it. The peak during a reload is the served models plus the
    largest one built afresh. The port's counterpart of the reference's
    checkpoint re-upload in ``reload_params``."""

    def __init__(self) -> None:
        self._items: List[Tuple[object, Callable[[], object]]] = []

    def add(self, make: Callable[[], object]):
        """Build with ``make`` (a module or a tensor) and keep the recipe."""
        built = make()
        self._items.append((built, make))
        return built

    def tensors(self) -> List[torch.Tensor]:
        """Every parameter and buffer the recipes built."""
        return [t for live, _ in self._items for t in _tensors(live)]

    def reload(self) -> None:
        """Raises when a recipe no longer builds what is served, and on a
        context an error left unusable (a sticky CUDA error)."""
        for live, make in self._items:
            fresh = _tensors(make())
            served = _tensors(live)
            if [(t.shape, t.dtype) for t in fresh] != [
                    (t.shape, t.dtype) for t in served]:
                raise RuntimeError(
                    f"a rebuild made other tensors than the served "
                    f"{type(live).__name__}'s")
            with torch.no_grad():
                for dst, src in zip(served, fresh):
                    dst.copy_(src)
            del fresh


def _tensors(built) -> List[torch.Tensor]:
    return [built] if isinstance(built, torch.Tensor) else \
        module_tensors(built)


def module_tensors(*modules: Optional[torch.nn.Module]
                   ) -> List[torch.Tensor]:
    """Every parameter and buffer of ``modules`` (None skipped)."""
    out: List[torch.Tensor] = []
    for m in modules:
        if m is not None:
            out += list(m.parameters()) + list(m.buffers())
    return out
