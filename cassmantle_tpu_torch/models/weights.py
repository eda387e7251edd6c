"""Model weights of the port: HF/diffusers checkpoints from a weights
directory, reference (Flax) parameter trees, and the device-loss reload.

**Checkpoints.** A port of ``cassmantle_tpu/models/weights.py``'s load
path (``:36-665``). :func:`load_safetensors` reads a safetensors file
over a copy-on-write ``mmap``: each tensor is a ``torch.frombuffer`` view
of the mapped bytes, so nothing is copied before conversion.
:func:`load_checkpoint_tensors` verifies the file's fingerprint first
(``utils/checkpoint.py``: a changed file raises ``CheckpointCorrupt``),
merges ``<stem>-*.safetensors`` shards in sorted order, and falls back to
the seeded init (None, with a log line) on a missing, unreadable or
truncated file. Each ``convert_*`` function maps the published names
(transformers for CLIP, GPT-2, MiniLM and Mistral; diffusers for the UNet
and VAE) onto the port's ``state_dict`` as a declarative plan, port key
-> (source key(s), transform), and returns it as :class:`Converted`, a
mapping that converts each tensor when it is read. HF and diffusers store
torch layouts, so most leaves map by name; the transforms are GPT-2's
Conv1D transpose and its fused ``c_attn`` split, the fused-QKV concat,
the 1x1-conv-to-dense squeeze, and MiniLM's token-type fold. A
checkpoint that lacks a tensor the plan needs falls back to the seeded
init (:func:`convert_tensors`), as the reference's does on ``KeyError``;
:class:`Converter` keeps the reference's bookkeeping (``take``, ``has``,
the ignore patterns of ``data/manifests``, the unused-tensors warning).
:func:`maybe_load` is the whole path, with the storage ``cast_to``.
:func:`fill_` copies a mapping into a built module tensor by tensor,
quantizing the W8A8 sites from the weights as they are at build.

**Reference trees.** ``from_jax(kind, params)`` takes the JAX package's
parameter tree as nested dicts of numpy arrays (``jax.device_get`` of the
Flax variables) and returns the port module's ``state_dict``. The port
names its submodules after the Flax modules, so the mapping is
mechanical:

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
it is, with no transpose (from a file: the published weight transposed,
:func:`convert_clip_text_projection`).

**Reload.** :class:`Rebuilds` keeps the recipe of each served model and
runs it again into the same tensors: the device-loss rebuild's reload.
"""

from __future__ import annotations

import fnmatch
import glob
import json
import math
import mmap
import os
import struct
from functools import partial
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from cassmantle_tpu_torch.utils.checkpoint import verify_or_record
from cassmantle_tpu_torch.utils.logging import get_logger

log = get_logger("weights")

KINDS = ("clip_text", "clip_text_2", "unet", "unet_xl", "vae", "vae_xl",
         "vae_enc", "gpt2", "mistral", "minilm")

Tensors = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Reference parameter trees
# ---------------------------------------------------------------------------

def _leaf(name: str, value):
    """A Flax leaf (numpy, or a torch tensor from a quantized file, bf16
    included) -> (port name, tensor in the port's layout)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.array(np.asarray(value), order="C"))
    if name == "kernel":
        if t.ndim == 2:
            t = t.t()
        elif t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {t.ndim}")
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return name, t.contiguous()


def _is_w8a8_leaf(value) -> bool:
    return getattr(value, "_fields", None) == ("data", "scale", "act_scale")


def _is_int8_leaf(value) -> bool:
    return getattr(value, "_fields", None) == ("data", "scale")


def _walk(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{key}.", out)
        elif _is_int8_leaf(value):
            _, data = _leaf(key, value.data)
            _, scale = _leaf(key, value.scale)
            out[f"{prefix}weight_q8"] = data
            out[f"{prefix}weight_q8_scale"] = scale.float()
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


def flax_flat(model: torch.nn.Module) -> Dict[str, object]:
    """The inverse of :func:`state_dict_from_tree` for a port module: its
    tensors under Flax paths joined by ``/`` in Flax layouts (Dense
    kernel (in, out), conv HWIO), a weights-only int8 weight as an
    ``ops/quant.py::QTensor`` of the same layouts (scale (1, out) or
    (1, 1, 1, out)); embedding tables become ``embedding``, other 1-D
    ``weight``s (norms) ``scale``."""
    from cassmantle_tpu_torch.models.layers import Conv, Dense, Embed
    from cassmantle_tpu_torch.ops.quant import (
        QTensor,
        int8_weight,
        quantized_weight,
    )

    def layout(module, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if isinstance(module, Dense):
            return t.t().contiguous()
        return t.permute(2, 3, 1, 0).contiguous()

    out: Dict[str, object] = {}
    for name, module in model.named_modules():
        path = name.split(".") if name else []
        if quantized_weight(module) is not None:
            raise ValueError(f"{name}: a W8A8 site has no weights-only "
                             f"int8 file form")
        q = int8_weight(module)
        if q is not None:
            out["/".join(path + ["kernel"])] = QTensor(
                layout(module, q.data), layout(module, q.scale))
        for leaf, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            if leaf in ("weight_q8", "weight_q8_scale"):
                continue
            if leaf == "weight":
                if isinstance(module, (Dense, Conv)):
                    leaf, t = "kernel", layout(module, t)
                elif isinstance(module, Embed):
                    leaf = "embedding"
                elif t.ndim == 1:
                    leaf = "scale"
            out["/".join(path + [leaf])] = t.detach()
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as a safetensors file (the format
    :func:`load_safetensors` reads): a little-endian header length, the
    JSON header padded to 8 bytes, then each tensor's bytes in order."""
    header: Dict[str, object] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        dtype = next(k for k, v in SAFETENSORS_DTYPES.items()
                     if v == t.dtype)
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


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


# ---------------------------------------------------------------------------
# safetensors, read over mmap
# ---------------------------------------------------------------------------

# The dtypes of the format (the reference's reader takes the same).
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor of a safetensors file: an 8-byte little-endian
    header length, a JSON header of ``dtype``/``shape``/``data_offsets``
    (and ``__metadata__``), then the raw bytes. Each tensor is a view of a
    copy-on-write mapping of the file (nothing is read until used; the
    mapping lives as long as a view does). Raises ValueError on a header
    or an extent the file does not hold (a truncated download)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes is no safetensors file")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: a {n}-byte header past the end of a "
                         f"{size}-byte file")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}")
        dtype = SAFETENSORS_DTYPES[spec["dtype"]]
        shape = [int(d) for d in spec["shape"]]
        start, end = (int(o) for o in spec["data_offsets"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if (start < 0 or end - start != count * itemsize
                or base + end > size):
            raise ValueError(f"{path}: {name} {spec['dtype']}{shape} at "
                             f"[{start}, {end}) does not fit the file")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + start).view(shape)
    return out


def checkpoint_paths(weights_dir: Optional[str], filename: str) -> List[str]:
    """The file ``filename`` in ``weights_dir``, or else its
    ``<stem>-*.safetensors`` shards in sorted order; [] for none."""
    if not weights_dir:
        return []
    path = os.path.join(weights_dir, filename)
    if os.path.exists(path):
        return [path]
    stem = filename.rsplit(".", 1)[0]
    return sorted(glob.glob(os.path.join(weights_dir,
                                         f"{stem}-*.safetensors")))


def load_checkpoint_tensors(weights_dir: Optional[str], filename: str,
                            model_name: str = "weights"
                            ) -> Optional[Dict[str, torch.Tensor]]:
    """A checkpoint's flat tensor dict, or None (the seeded init).

    Handles a missing file, shards (``<stem>-*.safetensors`` merged in
    sorted order) and an unreadable or truncated file (logged, not
    raised). Each file's fingerprint is verified first: a file that
    changed since its first load raises ``CheckpointCorrupt`` instead of
    taking the fallback, so a re-read during device-loss recovery fails
    the rebuild rather than swapping weights. Callers converting several
    models from one file (bigG's tower and its projection) read once here
    and run each converter through :func:`convert_tensors`."""
    paths = checkpoint_paths(weights_dir, filename)
    if not paths:
        if weights_dir:
            log.info("%s: no checkpoint at %s; using the seeded init",
                     model_name, os.path.join(weights_dir, filename))
        return None
    if len(paths) > 1:
        log.info("%s: loading %d shards of %s", model_name, len(paths),
                 filename)
    tensors: Dict[str, torch.Tensor] = {}
    for path in paths:
        log.info("%s: loading %s", model_name, path)
        verify_or_record(path)
        try:
            tensors.update(load_safetensors(path))
        except (OSError, ValueError, KeyError, TypeError):
            log.exception("%s: checkpoint at %s is unreadable; falling "
                          "back to the seeded init", model_name, path)
            return None
    return tensors


# ---------------------------------------------------------------------------
# Conversion plans
# ---------------------------------------------------------------------------

def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _t(x: torch.Tensor) -> torch.Tensor:
    """HF Conv1D (in, out) -> Linear (out, in); and (out, in) -> the
    reference's (in, out) matrix."""
    return x.t()


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    """Published separate projections -> one fused Linear (out axis)."""
    return torch.cat(xs, dim=0)


def _squeeze_1x1(x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv (O, I, 1, 1) -> a dense weight (O, I)."""
    return x[:, :, 0, 0]


def _columns_t(j: int, width: int, x: torch.Tensor) -> torch.Tensor:
    """Column block ``j`` of a Conv1D (in, n * width), as Linear (out, in)."""
    return x[:, j * width:(j + 1) * width].t()


def _block(j: int, width: int, x: torch.Tensor) -> torch.Tensor:
    return x[j * width:(j + 1) * width]


def _add_row0(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """position table + token-type row 0 (the ids are all 0 at serving)."""
    return table + rows[0]


Entry = Tuple[Callable[..., torch.Tensor], Tuple[str, ...]]


class Converted(Mapping):
    """A checkpoint's tensors as the port module's ``state_dict``: port key
    -> (transform, source keys), computed when read, in the source's dtype
    or ``cast_to`` (floating tensors only)."""

    def __init__(self, src: Tensors, entries: Mapping[str, Entry],
                 cast_to: Optional[torch.dtype] = None) -> None:
        self.src = src
        self.entries = dict(entries)
        self.cast_to = cast_to

    def __getitem__(self, key: str) -> torch.Tensor:
        fn, srcs = self.entries[key]
        out = fn(*(self.src[k] for k in srcs))
        if self.cast_to is not None and out.is_floating_point():
            out = out.to(self.cast_to)
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def cast(self, dtype: Optional[torch.dtype]) -> "Converted":
        return Converted(self.src, self.entries, dtype)

    def sources(self, key: str) -> Tuple[str, ...]:
        """The checkpoint keys port tensor ``key`` is made from."""
        return self.entries[key][1]


class Converter:
    """Builds a :class:`Converted` plan over ``tensors`` (the reference's
    ``Converter``, with port keys).

    ``ignore``: fnmatch patterns of source keys expected to go unused: the
    other tower of a full CLIP checkpoint, buffers persisted by older
    library versions (``embeddings.position_ids``, GPT-2's causal mask),
    the encoder half of a VAE file feeding the decoder converter. They
    mirror the manifests' ``optional`` lists (``data/manifests``), and
    keep the unused-tensors warning for tensors nothing expected."""

    def __init__(self, tensors: Tensors, model_name: str,
                 ignore: Tuple[str, ...] = ()) -> None:
        self.src = tensors
        self.model_name = model_name
        self.ignore = ignore
        self.entries: Dict[str, Entry] = {}
        self.used = set()

    def take(self, key: str) -> str:
        """Mark ``key`` consumed; KeyError when the checkpoint lacks it."""
        if key not in self.src:
            raise KeyError(key)
        self.used.add(key)
        return key

    def has(self, key: str) -> bool:
        return key in self.src

    def put(self, dst: str, fn: Callable[..., torch.Tensor],
            *srcs: str) -> None:
        self.entries[dst] = (fn, srcs)

    def dense(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", _same, self.take(f"{src}.weight"))
        if self.has(f"{src}.bias"):
            self.put(f"{dst}.bias", _same, self.take(f"{src}.bias"))

    def dense_fused(self, srcs: Sequence[str], dst: str) -> None:
        """Several published projections as ONE Linear (the fused QKV of
        ``models/layers.py``); checkpoints keep them separate."""
        self.put(f"{dst}.weight", _cat,
                 *(self.take(f"{s}.weight") for s in srcs))
        if self.has(f"{srcs[0]}.bias"):
            self.put(f"{dst}.bias", _cat,
                     *(self.take(f"{s}.bias") for s in srcs))

    conv = dense                       # OIHW on both sides

    def conv1x1_dense(self, src: str, dst: str) -> None:
        w = self.take(f"{src}.weight")
        self.put(f"{dst}.weight",
                 _squeeze_1x1 if self.src[w].ndim == 4 else _same, w)
        if self.has(f"{src}.bias"):
            self.put(f"{dst}.bias", _same, self.take(f"{src}.bias"))

    def norm(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", _same, self.take(f"{src}.weight"))
        self.put(f"{dst}.bias", _same, self.take(f"{src}.bias"))

    def groupnorm(self, src: str, dst: str) -> None:
        # GroupNorm32 nests an nn.GroupNorm called "norm"
        self.norm(src, f"{dst}.norm")

    def embed(self, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", _same, self.take(f"{src}.weight"))

    def ignored(self, key: str) -> bool:
        return any(fnmatch.fnmatchcase(key, p) for p in self.ignore)

    def unused(self) -> List[str]:
        """Source keys neither consumed nor ignored by design."""
        return sorted(k for k in set(self.src) - self.used
                      if not self.ignored(k))

    def plan(self) -> Converted:
        """The plan, with the reference's one-line audit of what the
        checkpoint gave, and a warning naming tensors left unused."""
        unused = self.unused()
        log.info("%s: consumed %d/%d checkpoint tensors "
                 "(%d ignored-by-design) -> %d param arrays",
                 self.model_name, len(self.used), len(self.src),
                 len(self.src) - len(self.used) - len(unused),
                 len(self.entries))
        if unused:
            log.warning("%s: %d source tensors unused (e.g. %s)",
                        self.model_name, len(unused), unused[:3])
        return Converted(self.src, self.entries)


# -- CLIP text encoder (transformers naming, prefix "text_model.") ----------

# A full CLIPModel checkpoint carries both towers and projections; each
# single-tower converter expects the other side's tensors to go unused.
# position_ids: arange buffers persisted by older transformers, "optional"
# in data/manifests/clip_full.json.
_CLIP_FULL_EXTRAS = ("logit_scale", "*.embeddings.position_ids")


def convert_clip_text(tensors: Tensors, num_layers: int) -> Converted:
    c = Converter(tensors, "clip_text", ignore=(
        "vision_model.*", "visual_projection.*", "text_projection.*",
    ) + _CLIP_FULL_EXTRAS)
    p = "text_model."
    c.embed(f"{p}embeddings.token_embedding", "token_embedding")
    c.put("position_embedding", _same,
          c.take(f"{p}embeddings.position_embedding.weight"))
    for i in range(num_layers):
        src, dst = f"{p}encoder.layers.{i}", f"block_{i}"
        c.norm(f"{src}.layer_norm1", f"{dst}.ln1")
        c.dense_fused((f"{src}.self_attn.q_proj", f"{src}.self_attn.k_proj",
                       f"{src}.self_attn.v_proj"), f"{dst}.attn.qkv")
        c.dense(f"{src}.self_attn.out_proj", f"{dst}.attn.out")
        c.norm(f"{src}.layer_norm2", f"{dst}.ln2")
        c.dense(f"{src}.mlp.fc1", f"{dst}.mlp.fc1")
        c.dense(f"{src}.mlp.fc2", f"{dst}.mlp.fc2")
    c.norm(f"{p}final_layer_norm", "ln_final")
    return c.plan()


def convert_clip_text_projection(tensors: Tensors) -> torch.Tensor:
    """bigG's (hidden, projection) matrix, applied as ``pooled @ proj``
    (the file stores the Linear's (out, in)). KeyError when absent."""
    return _t(tensors["text_projection.weight"])


# -- GPT-2 (transformers naming; Conv1D stores (in, out)) --------------------

def convert_gpt2(tensors: Tensors, num_layers: int,
                 hidden: int) -> Converted:
    # the published file persists the causal-mask buffers of its save era
    # (data/manifests/gpt2.json "optional")
    c = Converter(tensors, "gpt2", ignore=(
        "h.*.attn.bias", "h.*.attn.masked_bias"))

    def conv1d(src: str, dst: str) -> None:
        c.put(f"{dst}.weight", _t, c.take(f"{src}.weight"))
        c.put(f"{dst}.bias", _same, c.take(f"{src}.bias"))

    c.embed("wte", "wte")
    c.embed("wpe", "wpe")
    for i in range(num_layers):
        src, dst = f"h.{i}", f"block_{i}"
        c.norm(f"{src}.ln_1", f"{dst}.ln1")
        qkv_w = c.take(f"{src}.attn.c_attn.weight")      # (in, 3 * hidden)
        qkv_b = c.take(f"{src}.attn.c_attn.bias")
        for j, name in enumerate(("q", "k", "v")):
            c.put(f"{dst}.attn.{name}.weight", partial(_columns_t, j, hidden),
                  qkv_w)
            c.put(f"{dst}.attn.{name}.bias", partial(_block, j, hidden),
                  qkv_b)
        conv1d(f"{src}.attn.c_proj", f"{dst}.attn.out")
        c.norm(f"{src}.ln_2", f"{dst}.ln2")
        conv1d(f"{src}.mlp.c_fc", f"{dst}.mlp.fc1")
        conv1d(f"{src}.mlp.c_proj", f"{dst}.mlp.fc2")
    c.norm("ln_f", "ln_f")
    return c.plan()


# -- Mistral (transformers Llama-family naming) ------------------------------

def convert_mistral(tensors: Tensors, num_layers: int) -> Converted:
    """RMSNorm has a scale only; every projection is bias-free."""
    # some save eras persist per-layer RoPE tables (manifest "optional")
    c = Converter(tensors, "mistral", ignore=(
        "model.layers.*.self_attn.rotary_emb.inv_freq",))
    rmsnorm = c.embed                        # weight -> weight, as it is
    c.embed("model.embed_tokens", "embed")
    for i in range(num_layers):
        src, dst = f"model.layers.{i}", f"block_{i}"
        rmsnorm(f"{src}.input_layernorm", f"{dst}.ln1")
        for hf, ours in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                         ("o_proj", "out")):
            c.dense(f"{src}.self_attn.{hf}", f"{dst}.attn.{ours}")
        rmsnorm(f"{src}.post_attention_layernorm", f"{dst}.ln2")
        for hf, ours in (("gate_proj", "gate"), ("up_proj", "up"),
                         ("down_proj", "down")):
            c.dense(f"{src}.mlp.{hf}", f"{dst}.mlp.{ours}")
    rmsnorm("model.norm", "ln_f")
    if c.has("lm_head.weight"):
        c.dense("lm_head", "lm_head")
    else:                                    # tied-embedding checkpoints
        c.embed("model.embed_tokens", "lm_head")
    return c.plan()


# -- MiniLM / BERT (sentence-transformers all-MiniLM-L6-v2 naming) -----------

def convert_minilm(tensors: Tensors, num_layers: int) -> Converted:
    # pooler: BertModel ships one, mean-pooled scoring never runs it;
    # position_ids: a persisted buffer (data/manifests/minilm.json)
    c = Converter(tensors, "minilm", ignore=(
        "pooler.*", "embeddings.position_ids"))
    c.embed("embeddings.word_embeddings", "word_embeddings")
    pos = c.take("embeddings.position_embeddings.weight")
    if c.has("embeddings.token_type_embeddings.weight"):
        # token_type_ids are all 0 at inference: fold the type-0 row into
        # the position table (the same sum before the LayerNorm)
        c.put("position_embeddings", _add_row0, pos,
              c.take("embeddings.token_type_embeddings.weight"))
    else:
        c.put("position_embeddings", _same, pos)
    c.norm("embeddings.LayerNorm", "embed_ln")
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}", f"block_{i}"
        c.dense_fused((f"{src}.attention.self.query",
                       f"{src}.attention.self.key",
                       f"{src}.attention.self.value"), f"{dst}.attn.qkv")
        c.dense(f"{src}.attention.output.dense", f"{dst}.attn.out")
        c.norm(f"{src}.attention.output.LayerNorm", f"{dst}.ln1")
        c.dense(f"{src}.intermediate.dense", f"{dst}.mlp.fc1")
        c.dense(f"{src}.output.dense", f"{dst}.mlp.fc2")
        c.norm(f"{src}.output.LayerNorm", f"{dst}.ln2")
    return c.plan()


# -- SD UNet (diffusers naming; SD1.5 and SDXL through one UNetConfig) -------

def _resblock(c: Converter, src: str, dst: str) -> None:
    c.groupnorm(f"{src}.norm1", f"{dst}.norm1")
    c.conv(f"{src}.conv1", f"{dst}.conv1")
    c.dense(f"{src}.time_emb_proj", f"{dst}.time_proj")
    c.groupnorm(f"{src}.norm2", f"{dst}.norm2")
    c.conv(f"{src}.conv2", f"{dst}.conv2")
    if c.has(f"{src}.conv_shortcut.weight"):
        c.conv(f"{src}.conv_shortcut", f"{dst}.skip")        # a 1x1 conv


def _spatial_transformer(c: Converter, src: str, dst: str,
                         depth: int) -> None:
    c.groupnorm(f"{src}.norm", f"{dst}.norm")
    c.conv1x1_dense(f"{src}.proj_in", f"{dst}.proj_in")
    for k in range(depth):
        ts, td = f"{src}.transformer_blocks.{k}", f"{dst}.block_{k}"
        c.norm(f"{ts}.norm1", f"{td}.ln1")
        c.dense_fused((f"{ts}.attn1.to_q", f"{ts}.attn1.to_k",
                       f"{ts}.attn1.to_v"), f"{td}.self_attn.qkv")
        c.dense(f"{ts}.attn1.to_out.0", f"{td}.self_attn.out")
        c.norm(f"{ts}.norm2", f"{td}.ln2")
        c.dense(f"{ts}.attn2.to_q", f"{td}.cross_attn.q")
        c.dense_fused((f"{ts}.attn2.to_k", f"{ts}.attn2.to_v"),
                      f"{td}.cross_attn.kv")
        c.dense(f"{ts}.attn2.to_out.0", f"{td}.cross_attn.out")
        c.norm(f"{ts}.norm3", f"{td}.ln3")
        c.dense(f"{ts}.ff.net.0.proj", f"{td}.ff.proj")
        c.dense(f"{ts}.ff.net.2", f"{td}.ff.out")
    c.conv1x1_dense(f"{src}.proj_out", f"{dst}.proj_out")


def convert_unet(tensors: Tensors, cfg) -> Converted:
    """diffusers UNet2DConditionModel -> the port's UNet (``cfg``: its
    UNetConfig; SDXL's micro-conditioning MLP when the file has one)."""
    c = Converter(tensors, "unet")
    c.conv("conv_in", "conv_in")
    c.dense("time_embedding.linear_1", "time_fc1")
    c.dense("time_embedding.linear_2", "time_fc2")
    if c.has("add_embedding.linear_1.weight"):
        c.dense("add_embedding.linear_1", "add_fc1")
        c.dense("add_embedding.linear_2", "add_fc2")
    levels = len(cfg.channel_mults)
    for lvl in range(levels):
        attn = cfg.attention_levels[lvl] and cfg.transformer_depth[lvl]
        for blk in range(cfg.blocks_per_level):
            _resblock(c, f"down_blocks.{lvl}.resnets.{blk}",
                      f"down_{lvl}_res_{blk}")
            if attn:
                _spatial_transformer(
                    c, f"down_blocks.{lvl}.attentions.{blk}",
                    f"down_{lvl}_attn_{blk}", cfg.transformer_depth[lvl])
        if lvl != levels - 1:
            c.conv(f"down_blocks.{lvl}.downsamplers.0.conv",
                   f"down_{lvl}_downsample")
    _resblock(c, "mid_block.resnets.0", "mid_res_0")
    mid_depth = max([d for lvl, d in enumerate(cfg.transformer_depth)
                     if cfg.attention_levels[lvl]] or [1])
    _spatial_transformer(c, "mid_block.attentions.0", "mid_attn", mid_depth)
    _resblock(c, "mid_block.resnets.1", "mid_res_1")
    for i in range(levels):
        lvl = levels - 1 - i       # diffusers up_blocks[0]: lowest resolution
        attn = cfg.attention_levels[lvl] and cfg.transformer_depth[lvl]
        for blk in range(cfg.blocks_per_level + 1):
            _resblock(c, f"up_blocks.{i}.resnets.{blk}",
                      f"up_{lvl}_res_{blk}")
            if attn:
                _spatial_transformer(
                    c, f"up_blocks.{i}.attentions.{blk}",
                    f"up_{lvl}_attn_{blk}", cfg.transformer_depth[lvl])
        if lvl != 0:
            c.conv(f"up_blocks.{i}.upsamplers.0.conv", f"up_{lvl}_upsample")
    c.groupnorm("conv_norm_out", "norm_out")
    c.conv("conv_out", "conv_out")
    return c.plan()


# -- VAE (diffusers AutoencoderKL naming) ------------------------------------

def _vae_resblock(c: Converter, src: str, dst: str) -> None:
    c.groupnorm(f"{src}.norm1", f"{dst}.norm1")
    c.conv(f"{src}.conv1", f"{dst}.conv1")
    c.groupnorm(f"{src}.norm2", f"{dst}.norm2")
    c.conv(f"{src}.conv2", f"{dst}.conv2")
    if c.has(f"{src}.conv_shortcut.weight"):
        c.conv(f"{src}.conv_shortcut", f"{dst}.skip")


def _vae_attn(c: Converter, src: str, dst: str) -> None:
    """The mid-block attention under either published naming: the SD1.5
    file's ``query/key/value/proj_attn`` or the SDXL file's
    ``to_q/to_k/to_v/to_out.0`` (both pinned in data/manifests)."""
    c.groupnorm(f"{src}.group_norm", f"{dst}.norm")
    names = (("query", "key", "value", "proj_attn")
             if c.has(f"{src}.query.weight")
             else ("to_q", "to_k", "to_v", "to_out.0"))
    for theirs, ours in zip(names, ("q", "k", "v", "out")):
        c.dense(f"{src}.{theirs}", f"{dst}.attn.{ours}")


def convert_vae_decoder(tensors: Tensors, cfg) -> Converted:
    # the AutoencoderKL file also carries the encoder half and quant_conv
    c = Converter(tensors, "vae_decoder", ignore=(
        "encoder.*", "quant_conv.*"))
    c.conv("post_quant_conv", "post_quant_conv")                # a 1x1 conv
    c.conv("decoder.conv_in", "conv_in")
    _vae_resblock(c, "decoder.mid_block.resnets.0", "mid_res_0")
    _vae_attn(c, "decoder.mid_block.attentions.0", "mid_attn")
    _vae_resblock(c, "decoder.mid_block.resnets.1", "mid_res_1")
    levels = len(cfg.channel_mults)
    for i in range(levels):
        lvl = levels - 1 - i
        for blk in range(cfg.blocks_per_level + 1):
            _vae_resblock(c, f"decoder.up_blocks.{i}.resnets.{blk}",
                          f"up_{lvl}_res_{blk}")
        if lvl != 0:
            c.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                   f"up_{lvl}_upsample")
    c.groupnorm("decoder.conv_norm_out", "norm_out")
    c.conv("decoder.conv_out", "conv_out")
    return c.plan()


def convert_vae_encoder(tensors: Tensors, cfg) -> Converted:
    """The encoder half of the same AutoencoderKL file (img2img)."""
    c = Converter(tensors, "vae_encoder", ignore=(
        "decoder.*", "post_quant_conv.*"))
    c.conv("quant_conv", "quant_conv")
    c.conv("encoder.conv_in", "conv_in")
    levels = len(cfg.channel_mults)
    for lvl in range(levels):
        for blk in range(cfg.blocks_per_level):
            _vae_resblock(c, f"encoder.down_blocks.{lvl}.resnets.{blk}",
                          f"down_{lvl}_res_{blk}")
        if lvl != levels - 1:
            c.conv(f"encoder.down_blocks.{lvl}.downsamplers.0.conv",
                   f"down_{lvl}_downsample")
    _vae_resblock(c, "encoder.mid_block.resnets.0", "mid_res_0")
    _vae_attn(c, "encoder.mid_block.attentions.0", "mid_attn")
    _vae_resblock(c, "encoder.mid_block.resnets.1", "mid_res_1")
    c.groupnorm("encoder.conv_norm_out", "norm_out")
    c.conv("encoder.conv_out", "conv_out")
    return c.plan()


# The file each kind loads from, and its converter over the model config
# (``FrameworkConfig().models``), as the reference's pipelines call them.
CHECKPOINT_FILES = {
    "clip_text": "clip_text.safetensors",
    "clip_text_2": "clip_text_2.safetensors",
    "unet": "unet.safetensors", "unet_xl": "unet_xl.safetensors",
    "vae": "vae.safetensors", "vae_xl": "vae_xl.safetensors",
    "vae_enc": "vae.safetensors",
    "gpt2": "gpt2.safetensors", "mistral": "mistral.safetensors",
    "minilm": "minilm.safetensors",
}


def converter_for(kind: str, models) -> Callable[[Tensors], Converted]:
    """The converter of ``kind`` at the widths and depths of ``models``."""
    table = {
        "clip_text": lambda t: convert_clip_text(
            t, models.clip_text.num_layers),
        "clip_text_2": lambda t: convert_clip_text(
            t, models.clip_text_2.num_layers),
        "unet": lambda t: convert_unet(t, models.unet),
        "unet_xl": lambda t: convert_unet(t, models.unet),
        "vae": lambda t: convert_vae_decoder(t, models.vae),
        "vae_xl": lambda t: convert_vae_decoder(t, models.vae),
        "vae_enc": lambda t: convert_vae_encoder(t, models.vae),
        "gpt2": lambda t: convert_gpt2(t, models.gpt2.num_layers,
                                       models.gpt2.hidden_size),
        "mistral": lambda t: convert_mistral(t, models.mistral.num_layers),
        "minilm": lambda t: convert_minilm(t, models.minilm.num_layers),
    }
    if kind not in table:
        raise ValueError(f"unknown model kind {kind!r}; one of {KINDS}")
    return table[kind]


def _dtype(dtype: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def convert_tensors(tensors: Optional[Tensors],
                    converter: Callable[[Tensors], Converted],
                    model_name: str,
                    cast_to: Union[str, torch.dtype, None] = None
                    ) -> Optional[Converted]:
    """Run a converter over an already-read tensor dict; None on an
    incomplete checkpoint (the seeded init), as :func:`maybe_load`."""
    if tensors is None:
        return None
    try:
        plan = converter(tensors)
    except KeyError as exc:
        # an incomplete checkpoint (an interrupted shard download):
        # degrade to the seeded init instead of failing the boot
        log.error("%s: checkpoint is missing tensors (%s); falling back "
                  "to the seeded init", model_name, exc)
        return None
    return plan.cast(_dtype(cast_to))


def maybe_load(weights_dir: Optional[str], filename: str,
               converter: Callable[[Tensors], Converted], model_name: str,
               cast_to: Union[str, torch.dtype, None] = None
               ) -> Optional[Converted]:
    """Read and convert a checkpoint if present, else None (the seeded
    init). ``cast_to``: the storage dtype of the converted tensors."""
    tensors = load_checkpoint_tensors(weights_dir, filename, model_name)
    return convert_tensors(tensors, converter, model_name, cast_to=cast_to)


# ---------------------------------------------------------------------------
# Filling built modules, and the device-loss reload
# ---------------------------------------------------------------------------

def fill_(module: torch.nn.Module, weights: Mapping[str, torch.Tensor],
          quant_dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """Copy ``weights`` (port key -> tensor) into ``module``'s parameters
    and buffers in place, one tensor at a time, each cast to the served
    tensor's dtype: the peak is one converted tensor beside the module. A
    W8A8 site (``weight_q``/``weight_scale`` buffers, ``ops/quant.py``)
    is quantized from its ``weight`` cast to ``quant_dtype`` (the storage
    dtype it was quantized from at build), with its static activation
    scale as the build computed it, so it holds what the build gave; a
    weights-only int8 site (``weight_q8``/``weight_q8_scale``)
    takes its buffers as given (a quantized file) or quantizes its
    ``weight``, cast to its storage dtype, on the host. Raises when the
    keys or shapes differ from the module's."""
    from cassmantle_tpu_torch.ops.quant import (
        quantize_tensor,
        quantize_tensor_act,
    )

    served = module.state_dict(keep_vars=True)
    w8a8 = {k[:-len("weight_q")] for k in served if k.endswith("weight_q")}
    int8 = {k[:-len("weight_q8")] for k in served
            if k.endswith("weight_q8")}
    site_buffers = {f"{q}{leaf}" for q in w8a8
                    for leaf in ("weight_q", "weight_scale", "act_scale")}
    # an int8 site given as a weight is quantized here; given as its
    # buffers, they are copied
    int8_from_weight = {q for q in int8 if f"{q}weight" in weights}
    site_buffers |= {f"{q}{leaf}" for q in int8_from_weight
                     for leaf in ("weight_q8", "weight_q8_scale")}
    wanted = ((set(served) - site_buffers)
              | {f"{q}weight" for q in w8a8 | int8_from_weight})
    if set(weights) != wanted:
        missing = sorted(wanted - set(weights))
        extra = sorted(set(weights) - wanted)
        raise ValueError(f"{type(module).__name__}: the weights lack "
                         f"{missing[:4]} and hold unexpected {extra[:4]}")
    with torch.no_grad():
        for key in weights:
            prefix = key[:-len("weight")]
            if key.endswith("weight") and prefix in w8a8:
                w = weights[key].to(served[f"{prefix}weight_q"].device)
                if quant_dtype is not None:
                    w = w.to(quant_dtype)
                q = quantize_tensor_act(w, axis=0)
                _copy(served[f"{prefix}weight_q"], q.data, key)
                _copy(served[f"{prefix}weight_scale"], q.scale, key)
                if served.get(f"{prefix}act_scale") is not None:
                    # the build's static scale (calibration, not the file)
                    site = module.get_submodule(prefix[:-1])
                    _copy(served[f"{prefix}act_scale"], site.act_scale_host,
                          key)
            elif key.endswith("weight") and prefix in int8_from_weight:
                site = module.get_submodule(prefix[:-1])
                q = quantize_tensor(
                    weights[key].to("cpu", site.weight_q8_dtype), axis=0)
                _copy(served[f"{prefix}weight_q8"], q.data, key)
                _copy(served[f"{prefix}weight_q8_scale"], q.scale, key)
            else:
                _copy(served[key], weights[key], key)
    return module


def _copy(dst: torch.Tensor, src: torch.Tensor, key: str) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} vs "
                         f"the model's {tuple(dst.shape)}")
    if src.device != dst.device:
        # move the file's bytes as they are and cast or lay them out on
        # the destination's device (a copy across devices would convert
        # on the host and move the wider type)
        src = src.to(dst.device)
    dst.copy_(src)


class Rebuilds:
    """The device-loss rebuild's reload, with no resident copy of the
    weights: each served module (or tensor) is kept beside the recipe
    that restores it (:meth:`add`), and :meth:`reload` runs every recipe
    again into the live tensors in place, so anything holding their
    addresses (the captured CUDA graphs) stays valid.

    Two kinds of recipe. A seeded one (``make`` alone) builds a fresh
    object and copies it over: the same values again from its generator,
    or a caller's ``state_dict`` it keeps a reference to; the peak is the
    served models plus the largest one built afresh. A file-backed one
    (``refill``, for a model loaded from a weights directory) reads the
    files again under their fingerprints, as the reference's
    ``reload_params`` re-reads them, and copies converted tensors into
    the served ones one at a time (:func:`fill_`): no fresh module, so
    the peak is the served models plus one tensor in the file's dtype on
    the card (and its fp32 temporaries at a W8A8 site). A file that changed since boot
    raises ``CheckpointCorrupt``; a file gone or unreadable raises too:
    a rebuild never swaps in other weights."""

    def __init__(self) -> None:
        self._items: List[Tuple[object, Callable[[object], None]]] = []

    def add(self, make: Callable[[], object],
            refill: Optional[Callable[[object], None]] = None):
        """Build with ``make`` (a module or a tensor) and keep the recipe:
        ``refill(live)`` restores the live object in place (default: make
        it again and copy)."""
        built = make()
        self._items.append((built, refill or partial(_remake, make)))
        return built

    def tensors(self) -> List[torch.Tensor]:
        """Every parameter and buffer the recipes built."""
        return [t for live, _ in self._items for t in _tensors(live)]

    def reload(self) -> None:
        """Raises when a recipe no longer builds what is served, and on a
        context an error left unusable (a sticky CUDA error)."""
        for live, refill in self._items:
            refill(live)


def _remake(make: Callable[[], object], live) -> None:
    fresh = _tensors(make())
    served = _tensors(live)
    if [(t.shape, t.dtype) for t in fresh] != [
            (t.shape, t.dtype) for t in served]:
        raise RuntimeError(f"a rebuild made other tensors than the served "
                           f"{type(live).__name__}'s")
    with torch.no_grad():
        for dst, src in zip(served, fresh):
            dst.copy_(src)


def reread(weights_dir: str, filename: str,
           converter: Callable[[Tensors], Converted],
           model_name: str) -> Converted:
    """The file-backed recipe's read: the checkpoint again under its
    fingerprint, converted. Raises where boot would fall back: a rebuild
    never serves the seeded init in place of loaded weights."""
    tensors = load_checkpoint_tensors(weights_dir, filename, model_name)
    plan = convert_tensors(tensors, converter, model_name)
    if plan is None:
        raise RuntimeError(f"{model_name}: {filename} in {weights_dir} is "
                           f"gone, unreadable or incomplete since boot")
    return plan


def refill_from_file(weights_dir: str, filename: str,
                     converter: Callable[[Tensors], Converted],
                     model_name: str,
                     quant_dtype: Optional[torch.dtype] = None
                     ) -> Callable[[torch.nn.Module], None]:
    """A :class:`Rebuilds` refill for a module loaded from ``filename``."""
    def refill(live: torch.nn.Module) -> None:
        fill_(live, reread(weights_dir, filename, converter, model_name),
              quant_dtype)
    return refill


def add_model(rebuilds: Rebuilds, build: Callable[[Optional[Mapping]],
                                                 torch.nn.Module],
              name: str, weights_dir: Optional[str], filename: str,
              convert: Callable[[Tensors], Converted],
              state_dict: Optional[Mapping] = None,
              quant_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.nn.Module, bool]:
    """Build a served model into ``rebuilds``: ``build(weights)`` from the
    checkpoint ``filename`` in ``weights_dir`` when it is there and
    complete (its recipe then reads the file again,
    :func:`refill_from_file`), else ``build(state_dict)``
    (None: the seeded init). Returns (module, loaded from a file). A model
    given in ``state_dict`` and as a file raises."""
    if state_dict is not None and checkpoint_paths(weights_dir, filename):
        raise ValueError(f"{name}: given in state_dicts and as {filename} "
                         f"in {weights_dir}; give one")
    loaded = (None if state_dict is not None else
              maybe_load(weights_dir, filename, convert, name))
    if loaded is None:
        return rebuilds.add(partial(build, state_dict)), False
    refill = refill_from_file(weights_dir, filename, convert, name,
                              quant_dtype)
    return rebuilds.add(partial(build, loaded), refill), True


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
