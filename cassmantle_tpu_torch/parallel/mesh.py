"""Device mesh: named axes over the positions of one process's devices.

Port of ``cassmantle_tpu/parallel/mesh.py``. The reference is a
single-controller program: one process holds a ``jax.sharding.Mesh``
over its local devices, and GSPMD inserts the collectives its shardings
need. The port's :class:`Mesh` is the same thing for one process and its
``torch.device``\\ s: the axis sizes by name (``dp, pp, tp, sp, ep``, the
order of ``MeshConfig.axis_names``) and a grid of positions, each a
device. What moves between positions is ``parallel/collectives.py``; the
serving layouts that use it are ``serving/pipeline.py`` (dp) and
``parallel/spatial.py`` (sp).

- :func:`resolve_axis_sizes` is the reference's, with its asserts: -1
  axes take the devices the fixed axes leave, row-major.
- :func:`make_mesh` defaults to every visible card
  (``cuda:0 .. cuda:n-1``). An explicit device list may repeat a device:
  the counterpart of the reference's virtual host devices, which share
  one CPU. Positions on one device then share its memory and its stream,
  so a mesh of n positions on one card really splits, pads, exchanges
  and gathers, and the same code on an n-card host spans n cards.
- :func:`batch_sharding` and :func:`replicated` say what each position
  holds of a tensor (:class:`Sharding`): its rows of the batch over
  ``dp``, or the whole tensor. A device holds one copy of what several of
  its positions hold alike.

``maybe_init_distributed`` (the multi-host join) is not ported yet: it
comes with the multi-host dryrun (ROADMAP Queue 1 item 16, its training
half).
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.config import MeshConfig
from cassmantle_tpu_torch.parallel.collectives import move
from cassmantle_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> List[int]:
    """Fill -1 axes with the remaining device count (row-major).

    Order matches ``cfg.axis_names``: (dp, pp, tp, sp, ep)."""
    sizes = [cfg.dp, cfg.pp, cfg.tp, cfg.sp, cfg.ep]
    fixed = 1
    for s in sizes:
        if s > 0:
            fixed *= s
    if n_devices % fixed != 0:
        raise AssertionError(
            f"{n_devices} devices not divisible by fixed axes {fixed}")
    remaining = n_devices // fixed
    out = []
    for s in sizes:
        if s > 0:
            out.append(s)
        else:
            out.append(remaining)
            remaining = 1
    if int(np.prod(out)) != n_devices:
        raise AssertionError((out, n_devices))
    return out


def indexed_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Axis sizes by name and a grid of positions over devices.

    ``devices`` is an object array of ``torch.device`` shaped by the axis
    sizes in ``axis_names`` order; ``shape`` maps each name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        """Each device the mesh covers once, in position order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def home(self) -> torch.device:
        """The first position's device: where a meshed pipeline builds
        its models and gathers its outputs."""
        return self.devices.flat[0]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``cfg`` (default ``MeshConfig()``: dp over all) over
    ``devices`` (default: every visible card; raises on a host without
    CUDA). A device may repeat."""
    cfg = cfg or MeshConfig()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [indexed_device(d) for d in devices]
    sizes = resolve_axis_sizes(cfg, len(devices))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    mesh = Mesh(grid.reshape(sizes), cfg.axis_names)
    log.info("mesh: %s over %d distinct devices", mesh.shape,
             len(mesh.distinct_devices()))
    return mesh


class Sharding:
    """What each position of ``mesh`` holds of a tensor: ``spec`` names
    the mesh axis each leading dimension is split over (None: whole), as
    a ``PartitionSpec``."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...]):
        for axis in spec:
            if axis is not None and axis not in mesh.shape:
                raise ValueError(f"no mesh axis {axis!r} in {mesh.shape}")
        self.mesh = mesh
        self.spec = tuple(spec)

    def _index(self, position: Tuple[int, ...], shape) -> tuple:
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not split over {axis}={n}")
            rows = shape[dim] // n
            i = position[self.mesh.axis_names.index(axis)]
            index.append(slice(i * rows, (i + 1) * rows))
        return tuple(index)

    def place(self, x: torch.Tensor) -> np.ndarray:
        """Each position's piece of ``x`` on its device (an object array
        shaped like the mesh). Pieces equal on one device are one tensor
        there; a piece on ``x``'s own device is a view of it."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        made: Dict[tuple, torch.Tensor] = {}
        for position in itertools.product(*map(range, out.shape)):
            dev = self.mesh.devices[position]
            index = self._index(position, x.shape)
            key = (dev, tuple((s.start, s.stop) for s in index))
            if key not in made:
                made[key] = move(x[index], dev)
            out[position] = made[key]
        return out


def batch_sharding(mesh: Mesh) -> Sharding:
    """Activations: batch over dp, replicated elsewhere."""
    return Sharding(mesh, ("dp",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
