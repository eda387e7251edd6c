"""Training checkpoints and load-time checkpoint fingerprints.

Port of ``cassmantle_tpu/utils/checkpoint.py``.

**Training state.** :class:`TrainCheckpointer` keeps a trainer's model and
optimizer ``state_dict``s by step, in the place of the reference's orbax
manager (``save``, ``latest_step``, ``restore``, ``close``,
``max_to_keep``): each step is a directory ``step_<N>`` of two safetensors
files (the port's own writer and mmap reader, ``models/weights.py``) and
``extra.json``, written under a temporary name and renamed into place, so
a run killed mid-save leaves the previous steps whole.

**Fingerprints.** Two loads read
the same multi-GB safetensors files: boot (``models/weights.py``
``maybe_load``) and the device-loss rebuild, which reads them again while
an incident is in progress. A file that changed between those two reads
would swap weights under a live game. The first load records a sidecar
(``<file>.fingerprint``); every later load verifies against it and raises
:class:`CheckpointCorrupt` naming the path. An absent file stays the
seeded-init fallback: a missing checkpoint is a configuration, a changed
one an incident. The sidecar's format is the reference's, so a sidecar
that either package recorded verifies in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("checkpoint")

_STEP_DIR = re.compile(r"^step_(\d+)$")


class TrainCheckpointer:
    """Versioned training checkpoints in ``directory``, the newest
    ``max_to_keep`` kept."""

    MODEL, OPTIMIZER, EXTRA = ("model.safetensors", "optimizer.safetensors",
                               "extra.json")

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep} < 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, ascending."""
        found = (_STEP_DIR.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, model_state: Mapping[str, Any],
             optimizer_state: Mapping[str, Any],
             extra: Optional[dict] = None) -> None:
        """Write both state dicts (flat name -> tensor) and ``extra`` as
        step ``step``, replacing a save of the same step, then drop the
        oldest steps beyond ``max_to_keep``."""
        from cassmantle_tpu_torch.models.weights import save_safetensors

        final = self._path(step)
        tmp = os.path.join(self.directory, f".tmp-step_{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_safetensors(model_state, os.path.join(tmp, self.MODEL))
        save_safetensors(optimizer_state, os.path.join(tmp, self.OPTIMIZER))
        with open(os.path.join(tmp, self.EXTRA), "w", encoding="utf-8") as f:
            json.dump({"step": step, **(extra or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
        log.info("saved checkpoint step=%d to %s", step, self.directory)

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """``{"step", "model", "optimizer", "extra"}`` of ``step`` (the
        latest by default) as CPU tensors, or None when nothing is saved.
        Load them with the trainer's ``load_model_state`` and its
        optimizer's ``load_state_dict``."""
        from cassmantle_tpu_torch.models.weights import load_safetensors

        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = self._path(step)
        with open(os.path.join(path, self.EXTRA), encoding="utf-8") as f:
            extra = json.load(f)
        extra.pop("step", None)
        out = {"step": step,
               "model": load_safetensors(os.path.join(path, self.MODEL)),
               "optimizer": load_safetensors(os.path.join(path,
                                                          self.OPTIMIZER)),
               "extra": extra}
        log.info("restored checkpoint step=%d", step)
        return out

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's
        interface."""

SIDECAR_SUFFIX = ".fingerprint"
# The digest covers the file size and its first and last MiB: the
# safetensors header (every tensor's name, dtype and offsets) sits at the
# head, so truncation, re-serialization and tensor edits move it, and a
# boot does not re-read every byte of a multi-GB file to verify it.
_CHUNK = 1 << 20


class CheckpointCorrupt(RuntimeError):
    """A checkpoint's bytes no longer match its recorded fingerprint.

    Raised by the load path and so by a device-loss rebuild; callers must
    not turn it into the seeded-init fallback."""

    def __init__(self, path: str, expected: str, actual: str) -> None:
        super().__init__(
            f"checkpoint fingerprint mismatch at {path}: "
            f"expected {expected[:16]}..., got {actual[:16]}... — the "
            f"file changed since it was first loaded (re-fetch it, or "
            f"delete {path + SIDECAR_SUFFIX} to accept the new content)")
        self.path = path
        self.expected = expected
        self.actual = actual


def fingerprint_file(path: str) -> str:
    """sha256 over (size, head MiB, tail MiB) of ``path``."""
    size = os.path.getsize(path)
    h = hashlib.sha256()
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(_CHUNK))
        if size > _CHUNK:
            f.seek(max(_CHUNK, size - _CHUNK))
            h.update(f.read(_CHUNK))
    return h.hexdigest()


def read_fingerprint(path: str) -> Optional[str]:
    """The recorded digest of checkpoint ``path``, or None."""
    sidecar = path + SIDECAR_SUFFIX
    try:
        with open(sidecar, "r", encoding="utf-8") as f:
            return json.load(f).get("sha256") or None
    except FileNotFoundError:
        return None
    except (OSError, ValueError, AttributeError):
        # an unreadable sidecar vouches for nothing: the caller records
        # a new one
        log.warning("unreadable fingerprint sidecar %s; re-recording",
                    sidecar)
        return None


def record_fingerprint(path: str, digest: Optional[str] = None) -> None:
    """Write the sidecar. A read-only weights mount skips recording (loads
    of that file stay unverified) rather than failing the boot."""
    sidecar = path + SIDECAR_SUFFIX
    body = {"sha256": digest or fingerprint_file(path),
            "size": os.path.getsize(path)}
    try:
        with open(sidecar, "w", encoding="utf-8") as f:
            json.dump(body, f)
    except OSError as exc:
        log.info("cannot record fingerprint %s (%s); loads of this "
                 "file stay unverified", sidecar, exc)


def verify_or_record(path: str) -> None:
    """Verify ``path`` against its sidecar, recording one if absent.
    Raises :class:`CheckpointCorrupt` on a mismatch
    (``checkpoint.fingerprint_mismatch`` counts it)."""
    actual = fingerprint_file(path)
    expected = read_fingerprint(path)
    if expected is None:
        record_fingerprint(path, actual)
        return
    if actual != expected:
        metrics.inc("checkpoint.fingerprint_mismatch")
        log.error("checkpoint %s failed fingerprint verification", path)
        raise CheckpointCorrupt(path, expected, actual)
