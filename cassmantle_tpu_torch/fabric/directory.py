"""Room directory: session -> room -> worker placement.

A copy of ``cassmantle_tpu/fabric/directory.py``. A session hashes onto
the fixed room list (the same room on every request, from any worker);
a room maps onto a consistent-hash ring of workers (``vnodes`` virtual
nodes each, md5 positions), so a worker joining or leaving moves only
the rooms of its arcs. The hashes are md5-based, not ``hash()``:
placement agrees across processes. The ``fabric.directory`` lock guards
only the in-process ring and room list, never across an await.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from cassmantle_tpu_torch.utils.locks import OrderedLock


def stable_hash(key: str) -> int:
    """64-bit process-independent hash."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class RoomDirectory:
    def __init__(self, rooms: Sequence[str], workers: Sequence[str] = (),
                 vnodes: int = 64) -> None:
        assert rooms, "a directory needs at least one room"
        self.vnodes = vnodes
        self._lock = OrderedLock("fabric.directory", rank=4)
        self._rooms: List[str] = list(rooms)
        self._workers: List[str] = []
        self._ring: List[Tuple[int, str]] = []
        if workers:
            self.set_workers(workers)

    # -- ring maintenance --------------------------------------------------
    def _build_ring(self, workers: Sequence[str]) -> List[Tuple[int, str]]:
        ring = [
            (stable_hash(f"worker:{worker}#{v}"), worker)
            for worker in workers
            for v in range(self.vnodes)
        ]
        ring.sort()
        return ring

    def set_workers(self, workers: Sequence[str]) -> Dict[str, Tuple[Optional[str], str]]:
        """Replace the live worker set; returns ``{room: (old_owner,
        new_owner)}`` for every room whose placement moved (old_owner is
        None on the first build)."""
        new_workers = sorted(set(workers))
        new_ring = self._build_ring(new_workers)
        with self._lock:
            if new_workers == self._workers:
                return {}
            old_ring = self._ring
            old_empty = not old_ring
            self._workers = new_workers
            self._ring = new_ring
        moves: Dict[str, Tuple[Optional[str], str]] = {}
        for room in self.rooms():
            old = None if old_empty else self._owner(old_ring, room)
            new = self._owner(new_ring, room)
            if old != new:
                moves[room] = (old, new)
        return moves

    @staticmethod
    def _owner(ring: List[Tuple[int, str]], room: str) -> Optional[str]:
        if not ring:
            return None
        point = stable_hash(f"room:{room}")
        idx = bisect.bisect_right(ring, (point, "￿")) % len(ring)
        return ring[idx][1]

    # -- lookups -----------------------------------------------------------
    def rooms(self) -> List[str]:
        with self._lock:
            return list(self._rooms)

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def has_room(self, room: str) -> bool:
        with self._lock:
            return room in self._rooms

    def room_for_session(self, session: str) -> str:
        """The room a session belongs to — stable across requests and
        across workers (acceptance-pinned, tests/test_fabric.py)."""
        with self._lock:
            rooms = self._rooms
        return rooms[stable_hash(f"session:{session}") % len(rooms)]

    def worker_for_room(self, room: str) -> Optional[str]:
        """The owning worker, or None when no workers registered."""
        with self._lock:
            ring = self._ring
        return self._owner(ring, room)

    def rooms_owned_by(self, worker: str) -> List[str]:
        return [room for room in self.rooms()
                if self.worker_for_room(room) == worker]

    def placement(self) -> Dict[str, Optional[str]]:
        """room -> owner snapshot (the `/readyz` fabric block)."""
        return {room: self.worker_for_room(room) for room in self.rooms()}
