"""int8 quantization for serving: weights-only int8 (w8a16), W8A8, fp8
leaves and the calibration recorder.

Port of ``cassmantle_tpu/ops/quant.py``. Symmetric int8 with no zero
point: weights take one fp32 scale per output channel (absmax/127, or 1
where absmax is 0); activations one scale per tensor (the UNet) or per
token (GPT-2), absmax/127 computed on the device, or a static scale given
at build. Rounding is half to even and clips to +-127, as
``jnp.round``/``jnp.clip`` do, so the int8 data are bit-identical to the
reference's. An fp8 (``torch.float8_e4m3fn``) leaf scales by absmax/448
and casts, rounding to the nearest e4m3 value, as the reference's does.

**Weights-only int8** (``unet_int8``, ``lm_int8``). The reference swaps
the large ``kernel`` leaves of a Flax tree for :class:`QTensor`s and
dequantizes the tree inside its jit; here :func:`int8_modules` gives each
selected ``Dense`` or ``Conv`` the buffers ``weight_q8`` (int8, the
module's layout: Dense (out, in), conv OIHW) and ``weight_q8_scale``
(fp32, (out, 1[, 1, 1])) in place of its ``weight``, quantized on the
host; the module's forward dequantizes its own weight,
``(int8 -> fp32) x scale -> storage dtype``, just before its product
(:func:`layer_weight`), so no whole model is ever held dequantized.
:func:`default_predicate` selects the reference's set: the Dense and conv
weights (Flax ``kernel``) of at least 65,536 elements; embeddings and
norm scales, also named ``weight`` in the port, stay in fp.
:func:`save_quantized` / :func:`load_quantized` keep the reference's file
format: flat safetensors over Flax paths joined by ``/``, ``.q8`` and
``.q8_scale`` entries in Flax layouts.

**W8A8.** The reference swaps leaves of a Flax parameter tree for
``ActQTensor``s; here :func:`w8a8_modules` quantizes a built module in
place: each selected ``Dense`` or ``Conv3x3Params`` drops its ``weight``
parameter for the buffers ``weight_q`` (int8, the module's layout: Dense
(out, in), conv OIHW stored channels-last), ``weight_scale`` (fp32
(out,)) and, with a static scale, ``act_scale`` (fp32 scalar). The
module's forward then branches on :func:`quantized_weight`. Quantize
once, at build, after the weights reached their storage dtype and
device: a later ``.to(dtype)`` would cast the fp32 scales.

**The recorder.** The calibration pass (``parallel/calibrate.py``) runs
the fp UNet eagerly inside :func:`collect_act_stats`; each W8A8-capable
site notes its input's absmax under its :func:`site_key` (the reference's
Flax module path). Outside that block a site's check is one attribute
read; inside a CUDA graph capture nothing is recorded.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn

#: int8 symmetric range: 127, not 128, so negation is exact.
ACT_QMAX = 127.0
#: fp8 e4m3's largest finite value: the "127" of the fp8 grid.
FP8_E4M3_MAX = 448.0
#: absmax floor of an activation scale (an all-zero tensor gives no 0).
_ACT_EPS = 1e-8

#: Module names of the W8A8 dense sites: attention q/k/v/qkv/kv/out,
#: transformer MLP fc1/fc2, GEGLU proj/out. Other Dense sites (time
#: embeddings, proj_in/proj_out) never quantize.
W8A8_DENSE_MODULES = frozenset(
    {"q", "k", "v", "qkv", "kv", "out", "proj", "fc1", "fc2"})
#: Module names of the W8A8 conv3x3 sites: the ResBlocks' fused
#: GroupNorm -> SiLU -> conv3x3 (``Conv3x3Params``).
W8A8_CONV_MODULES = frozenset({"conv1", "conv2"})
#: Smallest weight (elements) worth quantizing, W8A8 or weights-only.
W8A8_MIN_SIZE = INT8_MIN_SIZE = 1 << 16


class ActQTensor(NamedTuple):
    """A W8A8 weight: int8 (or fp8 e4m3) data, the fp32 per-output-channel
    weight scale and an optional static fp32 activation scale (None:
    dynamic absmax).
    The ops (``ops/quant_matmul.py``) take ``data`` in the reference's
    layout, dense (in, out) and conv HWIO; the modules hand them views of
    their own buffers."""

    data: torch.Tensor
    scale: torch.Tensor
    act_scale: Optional[torch.Tensor]


def qmax_for(dtype: torch.dtype = torch.int8) -> float:
    """Largest magnitude of the quantized grid: 127 (int8) or 448 (fp8)."""
    return ACT_QMAX if dtype == torch.int8 else FP8_E4M3_MAX


def _qmax(like: torch.Tensor, dtype: torch.dtype = torch.int8
          ) -> torch.Tensor:
    """The grid's max as an fp32 tensor on ``like``'s device, filled there
    (no host copy, no sync). Dividing by it is IEEE division on every
    device; CUDA divides by a Python number as a multiply by its
    reciprocal, which rounds an ulp off at times and then flips int8
    values against the reference."""
    return like.new_full((), qmax_for(dtype), dtype=torch.float32)


class QTensor(NamedTuple):
    """A weights-only int8 weight: int8 data and an fp32 scale that
    broadcasts against it (one per output channel)."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self, dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
        """``(data -> fp32) * scale`` cast to ``dtype``."""
        return (self.data.float() * self.scale).to(dtype)


def _absmax_scale(w32: torch.Tensor, axis: int,
                  dtype: torch.dtype) -> torch.Tensor:
    reduce = tuple(i for i in range(w32.ndim) if i != axis)
    absmax = w32.abs().amax(dim=reduce, keepdim=True)
    return torch.where(absmax > 0, absmax / _qmax(absmax, dtype),
                       torch.ones_like(absmax))


def quantize_tensor(w: torch.Tensor, axis: int = -1) -> QTensor:
    """Symmetric per-channel int8 of ``w`` along ``axis`` (the output
    channels): int8 data and an fp32 scale with the other axes kept as 1.
    Unpacks as ``data, scale``."""
    w32 = w.float()
    axis = axis % w32.ndim
    scale = _absmax_scale(w32, axis, torch.int8)
    # in place on a fresh fp32 copy (the host quantize of a 7B model)
    q = w32.div(scale) if w32 is w else w32.div_(scale)
    data = q.round_().clamp_(-ACT_QMAX, ACT_QMAX).to(torch.int8)
    return QTensor(data, scale)


def act_absmax(x: torch.Tensor, per_token: bool = False) -> torch.Tensor:
    """|x| max in fp32: a 0-dim tensor (per tensor) or (..., 1) over the
    feature axis (per token). Stays on x's device: no host sync."""
    x32 = x.float().abs()
    if per_token:
        return x32.amax(dim=-1, keepdim=True)
    return x32.amax()


def act_scale_from_absmax(absmax, dtype: torch.dtype = torch.int8
                          ) -> torch.Tensor:
    """absmax -> the activation scale max(absmax, 1e-8) / qmax on the
    target grid (int8: 127, fp8: 448)."""
    absmax = torch.as_tensor(absmax, dtype=torch.float32)
    return torch.clamp_min(absmax, _ACT_EPS) / _qmax(absmax, dtype)


def quantize_act(x: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """``x / scale`` in fp32, then int8: rounded and clipped to +-127; or
    fp8: clipped to +-448 and cast (the grid rounds)."""
    x32 = x.float() / scale
    if dtype == torch.int8:
        return torch.clamp(torch.round(x32), -ACT_QMAX,
                           ACT_QMAX).to(torch.int8)
    return torch.clamp(x32, -FP8_E4M3_MAX, FP8_E4M3_MAX).to(dtype)


def quantize_tensor_act(w: torch.Tensor, axis: int = -1,
                        act_scale: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.int8) -> ActQTensor:
    """:func:`quantize_tensor` (or its fp8 twin) as a W8A8 weight (scale
    flattened to (out,)), carrying the site's static activation scale if
    given."""
    if dtype == torch.int8:
        data, scale = quantize_tensor(w, axis)
    else:
        w32 = w.float()
        scale = _absmax_scale(w32, axis % w32.ndim, dtype)
        data = torch.clamp(w32 / scale, -FP8_E4M3_MAX,
                           FP8_E4M3_MAX).to(dtype)
    if act_scale is not None:
        act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                    device=w.device)
    return ActQTensor(data, scale.reshape(-1), act_scale)


def w8a8_default_predicate(path: Tuple[str, ...], weight: torch.Tensor,
                           min_size: int = W8A8_MIN_SIZE) -> bool:
    """True for a weight at a W8A8 site: ``path`` is the owning module's
    path, ``weight`` in the port's layout (dense (out, in), conv OIHW)."""
    if not path or weight.numel() < min_size:
        return False
    parent = path[-1]
    if weight.ndim == 2 and parent in W8A8_DENSE_MODULES:
        return True
    return (weight.ndim == 4 and tuple(weight.shape[2:]) == (3, 3)
            and parent in W8A8_CONV_MODULES)


def site_key(path: Tuple[str, ...]) -> str:
    """The calibration key of a site: its module path, '/'-joined."""
    return "/".join(path)


def quantized_weight(module: nn.Module) -> Optional[ActQTensor]:
    """The module's W8A8 weight in its own layout, or None when the
    module was not quantized."""
    data = getattr(module, "weight_q", None)
    if data is None:
        return None
    return ActQTensor(data, module.weight_scale,
                      getattr(module, "act_scale", None))


def _quantize_module_(module: nn.Module,
                      act_scale: Optional[torch.Tensor]) -> None:
    weight = module.weight.detach()
    q = quantize_tensor_act(weight, axis=0, act_scale=act_scale)
    data = q.data
    if data.ndim == 4:       # OHWI memory: the conv kernel's weight layout
        data = data.contiguous(memory_format=torch.channels_last)
    del module.weight
    module.register_buffer("weight_q", data)
    module.register_buffer("weight_scale", q.scale)
    module.register_buffer("act_scale", q.act_scale)
    # the static scale as computed on the host, for a refill from a file
    # (models/weights.py::fill_), which carries weights only
    module.act_scale_host = None if act_scale is None else act_scale.clone()


def w8a8_modules(model: nn.Module,
                 act_scales: Optional[Dict[str, float]] = None,
                 predicate: Optional[Callable] = None) -> int:
    """Quantize every W8A8 site of ``model`` in place (the port's
    ``w8a8_tree``); returns the number of sites. ``act_scales`` maps
    :func:`site_key` to a calibrated absmax: those sites get a static
    activation scale, the others scale dynamically."""
    from cassmantle_tpu_torch.models.layers import Conv3x3Params, Dense

    if predicate is None:
        predicate = w8a8_default_predicate
    sites = []
    for name, module in model.named_modules():
        weight = getattr(module, "weight", None)
        if not name or not isinstance(weight, torch.Tensor):
            continue
        path = tuple(name.split("."))
        if not predicate(path, weight):
            continue
        if not isinstance(module, (Dense, Conv3x3Params)):
            raise TypeError(f"W8A8 site {name} is a {type(module).__name__}, "
                            f"which has no quantized branch")
        sites.append((path, module))
    for path, module in sites:
        a_scale = None
        if act_scales is not None and site_key(path) in act_scales:
            a_scale = act_scale_from_absmax(act_scales[site_key(path)])
        _quantize_module_(module, a_scale)
    return len(sites)


def w8a8_site_count(model: nn.Module) -> int:
    """Number of quantized sites of ``model``."""
    return sum(quantized_weight(m) is not None for m in model.modules())


def w8a8_calibrated(model: nn.Module) -> bool:
    """True when any quantized site carries a static activation scale."""
    return any(q is not None and q.act_scale is not None
               for q in map(quantized_weight, model.modules()))


# -- weights-only int8 --------------------------------------------------------

def default_predicate(path: Tuple[str, ...], module: nn.Module,
                      min_size: int = INT8_MIN_SIZE) -> bool:
    """True for a weight the weights-only int8 transform quantizes: a
    ``Dense`` or ``Conv`` weight (a Flax ``kernel``) of rank >= 2 and at
    least ``min_size`` elements. Embedding tables (Flax ``embedding``)
    and norm scales (``scale``) are ``weight`` in the port as well, so
    the module's class decides, not the name."""
    from cassmantle_tpu_torch.models.layers import Conv, Dense

    weight = getattr(module, "weight", None)
    return (isinstance(module, (Dense, Conv))
            and isinstance(weight, torch.Tensor) and weight.ndim >= 2
            and weight.numel() >= min_size)


def int8_weight(module: nn.Module) -> Optional[QTensor]:
    """The module's weights-only int8 weight in its own layout, or None."""
    data = getattr(module, "weight_q8", None)
    if data is None:
        return None
    return QTensor(data, module.weight_q8_scale)


def layer_weight(module: nn.Module) -> torch.Tensor:
    """The weight a layer multiplies by: its parameter, or its int8 weight
    dequantized to the storage dtype it was quantized from (the
    reference's ``QTensor.dequantize`` inside its jit), one layer at a
    time."""
    q = int8_weight(module)
    if q is None:
        return module.weight
    return q.dequantize(module.weight_q8_dtype)


def _quantize_module_int8_(module: nn.Module) -> None:
    weight = module.weight.detach()
    # on the host, as quantize_tree_host does: only the int8 data and
    # scales go back to the module's device (a meta twin stays meta)
    q = quantize_tensor(weight if weight.is_meta else weight.to("cpu"),
                        axis=0)
    device = weight.device
    del module.weight
    module.register_buffer("weight_q8", q.data.to(device))
    module.register_buffer("weight_q8_scale", q.scale.to(device))
    module.weight_q8_dtype = weight.dtype


def int8_modules(model: nn.Module,
                 predicate: Optional[Callable] = None) -> int:
    """Quantize every weight :func:`default_predicate` (or ``predicate``)
    selects, in place, on the host (the port's ``quantize_tree_host``);
    returns the number quantized. Quantize after the weights reached
    their storage dtype: they dequantize back to it."""
    if predicate is None:
        predicate = default_predicate
    sites = [m for name, m in model.named_modules()
             if int8_weight(m) is None and quantized_weight(m) is None
             and predicate(tuple(name.split(".")) if name else (), m)]
    for module in sites:
        _quantize_module_int8_(module)
    return len(sites)


def int8_site_count(model: nn.Module) -> int:
    """Number of weights-only int8 weights of ``model``."""
    return sum(int8_weight(m) is not None for m in model.modules())


def tree_nbytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of ``model`` (its footprint on
    the device, int8 weights at one byte)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def quantization_error(w: torch.Tensor, axis: int = -1) -> float:
    """Relative L2 reconstruction error of :func:`quantize_tensor`."""
    w32 = w.float()
    err = torch.linalg.vector_norm(
        quantize_tensor(w, axis).dequantize(torch.float32) - w32)
    return float(err / (torch.linalg.vector_norm(w32) + 1e-9))


_Q8_SUFFIX = ".q8"
_SCALE_SUFFIX = ".q8_scale"


def save_quantized(model: nn.Module, path: str) -> None:
    """Write ``model`` (int8 weights and all) as the reference's quantized
    file: flat safetensors keyed by Flax paths joined by ``/`` under
    ``params``, each int8 weight as ``<path>.q8`` (int8) and
    ``<path>.q8_scale`` (fp32), in Flax layouts (Dense (in, out), conv
    HWIO, scales (1, out) / (1, 1, 1, out))."""
    from cassmantle_tpu_torch.models.weights import flax_flat, save_safetensors

    flat = {}
    for key, value in flax_flat(model).items():
        if isinstance(value, QTensor):
            flat[f"params/{key}{_Q8_SUFFIX}"] = value.data
            flat[f"params/{key}{_SCALE_SUFFIX}"] = value.scale.float()
        else:
            flat[f"params/{key}"] = value
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_safetensors(flat, path)


def load_quantized(path: str) -> Dict[str, object]:
    """Inverse of :func:`save_quantized` (and of the reference's): the
    nested Flax tree with :class:`QTensor` leaves (host tensors, Flax
    layouts); ``models/weights.py::state_dict_from_tree`` maps it onto a
    module's ``state_dict``."""
    from cassmantle_tpu_torch.models.weights import load_safetensors

    flat = load_safetensors(path)
    tree: Dict[str, object] = {}

    def put(key: str, value) -> None:
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value

    for key, value in flat.items():
        if key.endswith(_SCALE_SUFFIX):
            continue
        if key.endswith(_Q8_SUFFIX):
            base = key[:-len(_Q8_SUFFIX)]
            put(base, QTensor(value, flat[base + _SCALE_SUFFIX]))
        else:
            put(key, value)
    return tree


# -- the calibration recorder -------------------------------------------------

_act_tls = threading.local()


def act_stats_active() -> bool:
    """True inside :func:`collect_act_stats` on this thread."""
    return getattr(_act_tls, "sink", None) is not None


@contextmanager
def collect_act_stats(*models: nn.Module) -> Iterator[Dict[str, float]]:
    """Yield a dict that fills with {site key: absmax} as eager fp forwards
    of ``models`` run inside the block (a running max per site). The
    sites are the reference's ``QDense`` and fused-conv ones (the W8A8
    module names), keyed by their path in their model
    (:func:`site_key`)."""
    sink: Dict[str, float] = {}
    names = W8A8_DENSE_MODULES | W8A8_CONV_MODULES
    sites = {id(m): site_key(tuple(name.split(".")))
             for model in models for name, m in model.named_modules()
             if name and name.rsplit(".", 1)[-1] in names}
    prev = (getattr(_act_tls, "sink", None),
            getattr(_act_tls, "sites", None))
    _act_tls.sink, _act_tls.sites = sink, sites
    try:
        yield sink
    finally:
        _act_tls.sink, _act_tls.sites = prev


def act_site(module: nn.Module) -> Optional[str]:
    """``module``'s site key in the active recorder, or None."""
    sites = getattr(_act_tls, "sites", None)
    return None if sites is None else sites.get(id(module))


def note_act_stat(site: Optional[str], value: torch.Tensor) -> None:
    """Record max(|value|) for ``site`` into the active sink. A no-op
    with no sink or site, and while a CUDA graph is being captured (the
    pass is eager by contract: its read of the value is a host sync)."""
    sink = getattr(_act_tls, "sink", None)
    if sink is None or site is None:
        return
    if value.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    absmax = float(value.detach().float().abs().amax())
    sink[site] = max(sink.get(site, 0.0), absmax)


def int8_layout_(model: nn.Module, paths) -> None:
    """Give each module at ``paths`` (dotted, in ``model``) empty int8
    buffers in place of its weight, for a quantized file to fill; they
    dequantize to the weight's dtype."""
    for path in paths:
        module = model.get_submodule(path)
        weight = module.weight
        del module.weight
        module.register_buffer("weight_q8", torch.empty(
            weight.shape, dtype=torch.int8, device=weight.device))
        module.register_buffer("weight_q8_scale", torch.empty(
            (weight.shape[0],) + (1,) * (weight.ndim - 1),
            dtype=torch.float32, device=weight.device))
        module.weight_q8_dtype = weight.dtype
