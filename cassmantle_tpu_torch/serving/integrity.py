"""Output-integrity sentinels: no invalid output reaches a player.

A port of ``cassmantle_tpu/serving/integrity.py`` (``:48-199``). Every
serving dispatch gets a per-batch-member validity verdict:

- the scorer's encode runs :func:`finite_verdict` on the device, a torch
  reduction over the embeddings beside the encode, read back with them:
  one host read per dispatch, as the reference's in-jit verdict;
- the image paths judge the uint8 batch they already copied to the host
  (:func:`degenerate_frames`: constant frames are what a dead VAE or a
  zeroed buffer gives), and the prompt decode judges its token range on
  the host. Nothing is added to the captured CUDA graphs, which stay bit
  for bit the eager steps (the reference keeps its verdict out of the
  sample jit for the same parity).

An invalid member fails its own request with :class:`OutputInvalid`
(retriable), counted as ``pipeline.output_invalid{pipeline=,stage=}`` and
flight-recorded; the other members of the batch still serve.

Kill switch: ``CASSMANTLE_NO_INTEGRITY_CHECKS`` (read per call) makes
every enforcement a no-op.

Chaos: :func:`poison` is the ``device.poison`` fault point: it corrupts
one batch member of a dispatch result (NaN for floats, -1 for signed
ints, 0 for unsigned) at the caller's representation, so the detectors
downstream must catch the bad data themselves.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from cassmantle_tpu_torch.chaos import ChaosInjected, fault_point
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("serving.integrity")


class OutputInvalid(RuntimeError):
    """A dispatch produced output the integrity sentinel rejected.
    Retriable: callers treat it like a dispatch timeout."""

    retriable = True

    def __init__(self, pipeline: str, stage: str,
                 members: Sequence[int] = ()):
        self.pipeline = pipeline
        self.stage = stage
        self.members = tuple(int(m) for m in members)
        detail = f" members={list(self.members)}" if self.members else ""
        super().__init__(f"invalid output from {pipeline}/{stage}{detail}")


def integrity_disabled() -> bool:
    """Kill switch, read per call."""
    return os.environ.get("CASSMANTLE_NO_INTEGRITY_CHECKS", "").lower() \
        not in ("", "0", "false", "no", "off")


def finite_verdict(x: torch.Tensor) -> torch.Tensor:
    """Per-batch-member all-finite verdict on ``x``'s device:
    ``(B, ...) -> (B,)`` bool. Integer outputs are finite by construction
    (constant True; range checks are the caller's)."""
    if not (x.is_floating_point() or x.is_complex()):
        return torch.ones(x.shape[:1] or (1,), dtype=torch.bool,
                          device=x.device)
    if x.dim() <= 1:
        return torch.isfinite(x)
    return torch.isfinite(x).flatten(1).all(dim=1)


def degenerate_frames(u8: np.ndarray) -> np.ndarray:
    """Constant-frame detector on a uint8 batch ``(B, H, W, C)`` ->
    ``(B,)`` bool, True where every pixel of a member has one value."""
    arr = np.asarray(u8)
    if arr.ndim <= 1 or arr.shape[0] == 0:
        return np.zeros(arr.shape[:1], dtype=bool)
    flat = arr.reshape(arr.shape[0], -1)
    return flat.max(axis=1) == flat.min(axis=1)


def invalid_members(verdict, *, images: Optional[np.ndarray] = None,
                    n: Optional[int] = None) -> np.ndarray:
    """Indices of invalid members: ``verdict`` rows that are False, with
    degenerate ``images`` frames when given; ``n`` trims padding rows.
    Empty under the kill switch."""
    if integrity_disabled():
        return np.empty(0, dtype=np.int64)
    if isinstance(verdict, torch.Tensor):
        verdict = verdict.cpu().numpy()
    ok = np.asarray(verdict).astype(bool).reshape(-1)
    if n is not None:
        ok = ok[:n]
    bad = ~ok
    if images is not None:
        deg = degenerate_frames(images if n is None
                                else np.asarray(images)[:n])
        m = min(len(bad), len(deg))
        bad = bad[:m] | deg[:m]
    return np.nonzero(bad)[0]


def note_invalid(pipeline: str, stage: str,
                 members: Sequence[int]) -> None:
    """Count and flight-record invalid members (for callers that fail
    them one by one instead of raising)."""
    members = [int(m) for m in members]
    metrics.inc("pipeline.output_invalid", float(len(members)),
                labels={"pipeline": pipeline, "stage": stage})
    flight_recorder.record("integrity.invalid", pipeline=pipeline,
                           stage=stage, members=members)
    log.warning("integrity: invalid output from %s/%s members=%s",
                pipeline, stage, members)


def enforce(verdict, *, pipeline: str, stage: str,
            images: Optional[np.ndarray] = None,
            n: Optional[int] = None) -> None:
    """Raise :class:`OutputInvalid` (after counting) when any member is
    invalid; a no-op under the kill switch."""
    members = invalid_members(verdict, images=images, n=n)
    if members.size == 0:
        return
    note_invalid(pipeline, stage, members.tolist())
    raise OutputInvalid(pipeline, stage, members.tolist())


def _fill(dtype) -> object:
    if dtype.is_floating_point:
        return float("nan")
    return -1 if dtype.is_signed else 0


def poison(arr, peer: str, member: int = 0):
    """The ``device.poison`` fault point: when the plan fires, corrupt
    one member of ``arr`` (NaN for floats, -1 for signed ints, 0 for
    unsigned) and return the corrupted copy; otherwise ``arr`` as it is.
    A host batch (numpy) or a device tensor with a batch axis gets row
    ``member`` corrupted; a 0-dim tensor is corrupted whole."""
    try:
        fault_point("device.poison", peer=peer)
    except ChaosInjected:
        if isinstance(arr, np.ndarray):
            if arr.ndim == 0 or arr.shape[0] == 0:
                return arr
            arr = np.array(arr, copy=True)
            if np.issubdtype(arr.dtype, np.floating):
                arr[member % arr.shape[0]] = np.nan
            elif np.issubdtype(arr.dtype, np.signedinteger):
                arr[member % arr.shape[0]] = -1
            else:
                arr[member % arr.shape[0]] = 0
        elif arr.dim() == 0 or arr.shape[0] == 0:
            arr = torch.full_like(arr, _fill(arr.dtype))
        else:
            arr = arr.clone()
            arr[member % arr.shape[0]] = _fill(arr.dtype)
        log.warning("chaos: device.poison corrupted %s output (member %d)",
                    peer, member)
    return arr
