"""Load-time checkpoint fingerprints.

A copy of the fingerprint half of ``cassmantle_tpu/utils/checkpoint.py``
(``:90-171``; the training checkpointer is not ported). Two loads read
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
from typing import Optional

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("checkpoint")

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
