"""Cluster membership: store-backed worker heartbeats.

A copy of ``cassmantle_tpu/fabric/membership.py``. Each worker writes one
field of the ``fabric:workers`` hash, ``{addr, rooms, t}`` with a wall
clock stamp; a field older than the TTL is a dead worker. Workers join
and leave one another through the shared store: the live view feeds the
placement ring (``fabric/directory.py``) and ``/readyz``. The heartbeat
is behind the ``fabric.heartbeat`` fault point. The ``fabric.membership``
lock guards only the cached view; store I/O happens outside it.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

from cassmantle_tpu_torch.chaos import afault_point
from cassmantle_tpu_torch.engine.store import StateStore
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("fabric.membership")

WORKERS_KEY = "fabric:workers"


class ClusterMembership:
    def __init__(self, store: StateStore, worker_id: str, *,
                 addr: str = "", ttl_s: float = 6.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.store = store
        self.worker_id = worker_id
        self.addr = addr
        self.ttl_s = ttl_s
        # wall clock: stamps are compared ACROSS processes, so monotonic
        # (per-process epoch) would read every peer as dead
        self._clock = clock or time.time
        self._lock = OrderedLock("fabric.membership", rank=6)
        self._live: Dict[str, dict] = {}

    async def heartbeat(self, room_count: int = 0,
                        extra: Optional[Dict[str, object]] = None
                        ) -> Dict[str, dict]:
        """Announce this worker and refresh the live view. ``extra``
        merges additional advertisement fields into the payload — the
        fabric passes the worker's overload state (``shed``/``btier``,
        serving/overload.py peer_advert) so peers stop hedging scorer
        work into an already-shedding worker."""
        # a flake here ages this worker toward the staleness TTL: peers
        # see it leave and adopt its rooms (the membership-churn drill)
        await afault_point("fabric.heartbeat")
        info: Dict[str, object] = {
            "addr": self.addr,
            "rooms": int(room_count),
        }
        if extra:
            info.update(extra)
        info["t"] = self._clock()
        payload = json.dumps(info)
        await self.store.hset(WORKERS_KEY, self.worker_id, payload)
        return await self.refresh()

    async def refresh(self) -> Dict[str, dict]:
        """Re-read the membership table; caches and returns live
        workers only (one parser — :meth:`table` — decides liveness)."""
        table = await self.table()
        live = {worker: row["info"] for worker, row in table.items()
                if not row["stale"]}
        with self._lock:
            self._live = live
        metrics.gauge("fabric.workers_live", float(len(live)))
        return live

    async def table(self) -> Dict[str, dict]:
        """The FULL membership table with staleness marked per entry:
        ``{worker: {"info", "stale", "age_s"}}`` — the ONE place the
        hash is parsed and liveness judged (``refresh`` derives from
        it). The cluster observability fan-outs
        (`/metrics?scope=cluster`, `/debugz?trace=&scope=cluster`)
        read this instead of the live view so a dead/stale peer is
        *marked* in the merged output rather than silently vanishing
        from it."""
        raw = await self.store.hgetall(WORKERS_KEY)
        now = self._clock()
        table: Dict[str, dict] = {}
        for field, value in raw.items():
            worker = field if isinstance(field, str) else field.decode()
            try:
                info = json.loads(value.decode())
            # lint: ignore[swallowed-error] — torn/foreign row skip is the documented merge rule; the row simply isn't membership data
            except Exception:
                continue  # torn/foreign field, same rule as refresh()
            age = now - float(info.get("t", 0.0))
            table[worker] = {
                "info": info,
                "stale": age > self.ttl_s,
                "age_s": round(age, 3),
            }
        return table

    async def leave(self) -> None:
        """Graceful departure: peers re-place our rooms on their next
        refresh instead of waiting a full staleness TTL."""
        await self.store.hdel(WORKERS_KEY, self.worker_id)

    # -- sync snapshot (status reporting) ----------------------------------
    def live_workers(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._live)

    def addr_of(self, worker: str) -> Optional[str]:
        info = self.live_workers().get(worker)
        return (info or {}).get("addr") or None
