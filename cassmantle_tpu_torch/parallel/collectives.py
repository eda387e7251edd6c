"""The collectives of the port's two serving layouts, over mesh positions.

The reference states a layout (``P("dp")`` for the batch,
``P("dp", "sp")`` for the spatially partitioned latents) and GSPMD
inserts what moves between devices. The port runs the positions itself,
from one thread, so it writes those moves out. Each function here acts
on per-position tensors along one mesh axis: a list, one tensor per
position, in axis order, each on its position's device.

- :func:`split` / :func:`gather`: a tensor's rows (batch or latent rows)
  out to the positions, and back to one device;
- :func:`ppermute`: each position's tensor to another position (the
  conv halos: a shard's boundary rows to its neighbours);
- :func:`psum`: partial sums added up, every position getting the same
  total (GroupNorm's statistics over a row-split image);
- :func:`all_gather`: every position gets all the pieces in order
  (self attention's K and V over the image's tokens);
- :func:`pmax`: the largest value over the positions (a per-tensor
  amax, as a W8A8 activation scale over shards would need).

A copy between two cards is device to device (a peer copy), ordered by
an event: the consumer's stream waits for the producer's work on the
source card before the copy runs there. Between positions on one card
nothing moves: a position reads the other's tensor where it lies (the
pieces of one card share its memory and its stream, so the order is the
launch order). Nothing goes through host memory. The reductions add in
position order, so every position holds the same bits.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

Shards = List[torch.Tensor]


@contextlib.contextmanager
def device_scope(device: torch.device) -> Iterator[None]:
    """Launch on ``device``'s current stream inside the block (CUDA);
    nothing on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there already; a card to
    card copy on the destination's stream after an event recorded on the
    source's (the copy waits for the work that made ``t``). The source's
    memory is kept until the copy has read it (``record_stream``)."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        dest = torch.cuda.current_stream(device)
        dest.wait_event(done)
        with torch.cuda.device(device), torch.cuda.stream(dest):
            out = t.to(device, non_blocking=True)
        t.record_stream(dest)
        return out
    return t.to(device)


def split(x: torch.Tensor, devices: Sequence[torch.device],
          dim: int) -> Shards:
    """``x`` cut into ``len(devices)`` equal pieces along ``dim``, piece i
    on device i (a view of ``x`` where the device is its own)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    return [move(piece, dev)
            for piece, dev in zip(x.chunk(n, dim=dim), devices)]


def gather(shards: Sequence[torch.Tensor], device: torch.device,
           dim: int) -> torch.Tensor:
    """The pieces joined along ``dim`` on ``device`` (in order)."""
    return torch.cat([move(s, device) for s in shards], dim=dim)


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> Shards:
    """``jax.lax.ppermute``: position ``dst`` receives ``xs[src]`` for
    each (src, dst) pair, on its own device; a position that receives
    nothing gets zeros shaped like its own tensor."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = move(xs[src], xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def halo_rows(xs: Sequence[torch.Tensor], dim: int, above: int = 1,
              below: int = 1) -> Tuple[Shards, Shards]:
    """The conv halos of a row split: for each position the ``above``
    rows that end its upper neighbour's piece and the ``below`` rows
    that start its lower neighbour's, zeros at the image's edges (a
    conv's zero padding). Two :func:`ppermute` shifts."""
    n = len(xs)
    tops = ppermute([x.narrow(dim, x.shape[dim] - above, above) for x in xs],
                    [(i, i + 1) for i in range(n - 1)]) if above else None
    bottoms = ppermute([x.narrow(dim, 0, below) for x in xs],
                       [(i + 1, i) for i in range(n - 1)]) if below else None
    return tops, bottoms


def _reduce(parts: Sequence[torch.Tensor], op) -> Shards:
    """``op`` over every part in position order, once per device; each
    position gets its device's result."""
    results = {}
    for p in parts:
        if p.device not in results:
            acc = move(parts[0], p.device)
            for q in parts[1:]:
                acc = op(acc, move(q, p.device))
            results[p.device] = acc
    return [results[p.device] for p in parts]


def psum(parts: Sequence[torch.Tensor]) -> Shards:
    """Every position gets the sum of all parts, added in position order."""
    return _reduce(parts, torch.add)


def pmax(parts: Sequence[torch.Tensor]) -> Shards:
    """Every position gets the elementwise largest of all parts."""
    return _reduce(parts, torch.maximum)


def all_gather(shards: Sequence[torch.Tensor], dim: int) -> Shards:
    """Every position gets all the pieces joined along ``dim`` (one copy
    per device)."""
    results = {}
    for s in shards:
        if s.device not in results:
            results[s.device] = gather(shards, s.device, dim)
    return [results[s.device] for s in shards]
