"""Analytic cost model: the products a serving dispatch runs, by type.

The port's counterpart of ``cassmantle_tpu/obs/costmodel.py``. A count is
shape-only and never runs on the card: the pipeline's own code runs once
on the ``meta`` device (tensors with shapes and dtypes and no data) under
:class:`ProductCounter`, which adds up the multiply-accumulates of every
matrix product and convolution the dispatch would run, whoever runs it:
cuBLAS and cuDNN for the library ops, the flash kernel's q k^T and p v
(4 B H S_q S_k D), the fused conv's 3x3 conv, the int8 kernels' products.
On a meta tensor each kernel wrapper runs a shape-only stand-in of its
kernel's products in the kernel's operand dtype (``ops/*.py``
``*_meta``), so the count sees what the card computes, not what a plain
version computes in fp32.

Products are counted per class of the card's peak (:class:`Products`):
``bf16`` (bf16 and fp16 operands: tensor cores), ``int8`` (int8
operands: kernels 3 and 4 and any int8 product) and ``fp32`` (fp32
operands; the port turns TF32 off, so these run on the CUDA cores). A
W8A8 dispatch thus counts the same products as its bf16 twin, with the
quantized sites' share moved to ``int8``.

The peaks are the NVIDIA H100 SXM data sheet's dense figures at its 700 W
limit: 989 TFLOP/s bf16 and fp16, 1,979 TOP/s int8, 67 TFLOP/s fp32.
``CASSMANTLE_CHIP_TFLOPS`` overrides the bf16 figure and scales the
other two with it (a card held below 700 W). ``pipeline.mxu_utilization``
(``utils/profiling.py::block_timer``) is ``sum(class ops / class peak) /
elapsed s``: the share of the card's peak the dispatch's own work would
take, counted as the same work whatever implements it. A meshed
dispatch counts its padded rows and divides by the peaks of the
distinct cards its mesh covers.

:func:`flops_per_item` caches a count per ``(kind, signature)``, the
signatures digesting what the count depends on (:func:`t2i_signature`,
:func:`sdxl_signature`, :func:`lm_signature`, :func:`scorer_signature`).
There is no committed artifact: a count runs once, at first use, on a
thread of its own (:func:`dispatch_count`); the dispatches before it
lands carry no attribution.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from cassmantle_tpu_torch.utils.logging import get_logger

log = get_logger("costmodel")

#: NVIDIA H100 SXM, dense, at 700 W (data sheet), in TFLOP/s or TOP/s
H100_PEAK_TFLOPS = {"bf16": 989.0, "int8": 1979.0, "fp32": 67.0}


def chip_peak_flops(kind: str = "bf16") -> float:
    """The card's peak rate of ``kind`` products per second.
    CASSMANTLE_CHIP_TFLOPS sets the bf16 figure; int8 and fp32 scale
    with it."""
    scale = 1.0
    raw = os.environ.get("CASSMANTLE_CHIP_TFLOPS", "")
    if raw:
        try:
            scale = float(raw) / H100_PEAK_TFLOPS["bf16"]
        except ValueError:
            log.warning("bad CASSMANTLE_CHIP_TFLOPS=%r; using the H100's "
                        "peaks", raw)
    return H100_PEAK_TFLOPS[kind] * scale * 1e12


class Products(NamedTuple):
    """Operations (2 per multiply-accumulate) by class of peak."""

    bf16: float = 0.0
    int8: float = 0.0
    fp32: float = 0.0

    @property
    def total(self) -> float:
        return self.bf16 + self.int8 + self.fp32

    def __add__(self, other: "Products") -> "Products":
        return Products(*(a + b for a, b in zip(self, other)))

    def scaled(self, k: float) -> "Products":
        return Products(*(a * k for a in self))

    def peak_seconds(self) -> float:
        """Seconds the card needs for these products at its peaks."""
        return sum(ops / chip_peak_flops(kind)
                   for kind, ops in zip(self._fields, self) if ops)

    def as_dict(self) -> Dict[str, float]:
        return {**self._asdict(), "total": self.total}


def utilization(products: Products, elapsed_s: float,
                cards: int = 1) -> float:
    """The share of the peak: sum(class ops / class peak) over the elapsed
    seconds, the peaks those of ``cards`` cards (a meshed dispatch's
    distinct cards; one card's where every position is on one)."""
    return products.peak_seconds() / (elapsed_s * cards)


_ATEN = torch.ops.aten
# product op -> (operand index of a, of b)
_MATMULS = {_ATEN.mm: (0, 1), _ATEN._int_mm: (0, 1), _ATEN.addmm: (1, 2),
            _ATEN.bmm: (0, 1), _ATEN.baddbmm: (1, 2)}


def _kind(dtype: torch.dtype) -> str:
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "fp32"


class ProductCounter(TorchDispatchMode):
    """Adds up the products of the aten ops run under it (matrix
    products and convolutions; everything else is free), by the class of
    its operands' dtype. Run the code under ``torch.no_grad()``, not
    ``inference_mode``, so composite ops reach it decomposed."""

    def __init__(self) -> None:
        super().__init__()
        self.ops = {"bf16": 0.0, "int8": 0.0, "fp32": 0.0}

    def products(self) -> Products:
        return Products(**self.ops)

    def add(self, p: Products) -> None:
        for kind, ops in zip(p._fields, p):
            self.ops[kind] += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _MATMULS:
            i, j = _MATMULS[packet]
            a = args[i]
            self.ops[_kind(a.dtype)] += 2.0 * math.prod(out.shape) \
                * a.shape[-1]
        elif packet is _ATEN.convolution:
            x, w = args[0], args[1]
            self.ops[_kind(x.dtype)] += 2.0 * out.numel() * w.shape[1] \
                * math.prod(w.shape[2:])
        return out


def meta_module(factory: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """``factory()`` made on the meta device: a module of the published
    width with no storage, built in milliseconds."""
    with torch.device("meta"):
        module = factory()
    return module.eval()


def _signature(tree) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec), tuple(
        ("T", tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
        else x for x in leaves))


class _Spec:
    """A recorded output tensor's shape and dtype (a pytree leaf)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, t: torch.Tensor) -> None:
        self.shape, self.dtype = tuple(t.shape), t.dtype


class MemoCall:
    """A meta module whose calls are counted once per signature (the
    shapes and dtypes of the tensors, every other argument's value): a
    repeated call returns new meta tensors of the recorded shapes and
    adds the recorded products to the counter. A sampler loop of 50 UNet
    forwards so costs one forward's walk per kind of forward."""

    def __init__(self, module, counter: ProductCounter) -> None:
        self.module = module
        self.counter = counter
        self._memo: Dict[tuple, tuple] = {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __call__(self, *args, **kwargs):
        key = _signature((args, kwargs))
        hit = self._memo.get(key)
        if hit is not None:
            products, specs = hit
            self.counter.add(products)
            return pytree.tree_map(
                lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta")
                if isinstance(s, _Spec) else s, specs)
        before = self.counter.products()
        out = self.module(*args, **kwargs)
        spent = Products(*(a - b for a, b in zip(self.counter.products(),
                                                 before)))
        self._memo[key] = (spent, pytree.tree_map(
            lambda t: _Spec(t) if isinstance(t, torch.Tensor) else t, out))
        return out


_import_lock = threading.Lock()


def import_dynamo() -> None:
    """Import ``torch._dynamo`` now, one thread at a time. A dispatch mode
    and the profiler each import it lazily at first use, and two threads
    importing it at once can meet it half made (an ImportError): a count
    on its thread beside a ``/debug/trace`` capture."""
    with _import_lock:
        import torch._dynamo  # noqa: F401


def count_products(fn: Callable[[ProductCounter], object]) -> Products:
    """The products of ``fn(counter)`` run on meta tensors."""
    import_dynamo()
    counter = ProductCounter()
    with torch.no_grad(), counter:
        fn(counter)
    return counter.products()


# -- signatures -------------------------------------------------------------

def _digest(*parts) -> str:
    return hashlib.sha256("|".join(repr(p) for p in parts)
                          .encode()).hexdigest()[:16]


def _w8a8_effective(flag: bool) -> bool:
    """The armed W8A8 state: under CASSMANTLE_NO_W8A8 a W8A8 config
    serves the bf16 path, and its count is that path's."""
    if not flag:
        return False
    from cassmantle_tpu_torch.ops.quant_matmul import w8a8_disabled

    return not w8a8_disabled()


def t2i_signature(cfg, sampler_cfg=None) -> str:
    """SD1.5 text -> image: the model architectures, the sampler's
    geometry and the armed W8A8 state (which moves products to int8; the
    fused conv runs the same products, and a weights-only int8 UNet the
    products of bf16, its weights dequantized before each)."""
    s = sampler_cfg if sampler_cfg is not None else cfg.sampler
    m = cfg.models
    return _digest("t2i", m.unet.arch(), m.vae.arch(), m.clip_text,
                   s.image_size, s.num_steps, s.kind, s.deepcache,
                   s.encprop, s.encprop_stride, s.encprop_dense_steps,
                   s.consistency, _w8a8_effective(m.unet_w8a8))


def sdxl_signature(cfg, sampler_cfg=None) -> str:
    s = sampler_cfg if sampler_cfg is not None else cfg.sampler
    m = cfg.models
    return _digest("sdxl", m.unet.arch(), m.vae.arch(), m.clip_text,
                   m.clip_text_2, s.image_size, s.num_steps, s.kind,
                   s.deepcache, s.encprop, s.encprop_stride,
                   s.encprop_dense_steps, s.consistency,
                   _w8a8_effective(m.unet_w8a8))


def lm_signature(mcfg, w8a8: bool = False) -> str:
    """The prompt LM: its config and the armed W8A8 state."""
    return _digest("lm", mcfg, _w8a8_effective(w8a8))


def scorer_signature(mcfg, seq_len: int) -> str:
    return _digest("scorer", mcfg, seq_len)


# -- the cache --------------------------------------------------------------

_lock = threading.Lock()
_cache: Dict[Tuple[str, str], Optional[Products]] = {}
_pending: set = set()


def cached(kind: str, signature: str) -> Tuple[bool, Optional[Products]]:
    """(found, count) for ``(kind, signature)``, without counting."""
    with _lock:
        if (kind, signature) in _cache:
            return True, _cache[(kind, signature)]
    return False, None


def flops_per_item(kind: str, signature: str,
                   counter: Callable[[], Products]) -> Optional[Products]:
    """The products of one item (an image, a token batch row, an encoded
    row) of a dispatch variant: ``counter()`` once per ``(kind,
    signature)`` in this process, then the cached count. A count that
    raises is logged and cached as None: the dispatch then carries no
    attribution, and serving goes on."""
    found, value = cached(kind, signature)
    if found:
        return value
    try:
        value = counter()
    except Exception:
        log.exception("cost count failed for %s; its dispatches carry no "
                      "FLOPs attribution", kind)
        value = None
    with _lock:
        _cache[(kind, signature)] = value
    return value


def count_later(kind: str, signature: str,
                counter: Callable[[], Products]) -> None:
    """:func:`flops_per_item` on a thread of its own, once per ``(kind,
    signature)``: no dispatch waits for its count (a brownout tier
    engages while the system sheds latency; the staged denoise loop never
    stalls). Its dispatches carry no attribution until the count lands."""
    key = (kind, signature)
    with _lock:
        if key in _cache or key in _pending:
            return
        _pending.add(key)

    def run() -> None:
        try:
            flops_per_item(kind, signature, counter)
        finally:
            with _lock:
                _pending.discard(key)

    # "cassmantle-stage*": a helper of the serving stages, allowlisted by
    # the leak sentinels. Not a daemon: the interpreter's exit waits for
    # a count in flight (a daemon stopped inside torch's C++ at exit
    # aborted a served worker on the card)
    threading.Thread(target=run, name=f"cassmantle-stage-cost-{kind}").start()


def dispatch_count(kind: str, signature: str,
                   counter: Callable[[], Products]) -> Optional[Products]:
    """What a dispatch attributes: the cached count, or None while it is
    being made on a thread of its own (:func:`count_later`). A count never
    runs on a dispatch's own path: at full width it walks thousands of
    ops on the host."""
    found, value = cached(kind, signature)
    if not found:
        count_later(kind, signature, counter)
    return value


def reset_cache() -> None:
    """Drop every cached count (tests)."""
    with _lock:
        _cache.clear()
