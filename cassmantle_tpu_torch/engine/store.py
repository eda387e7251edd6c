"""Async game-state store: the game's coordination plane.

A copy of ``cassmantle_tpu/engine/store.py``: the :class:`StateStore`
contract (the redis subset the game uses: keys, hashes, sets, TTLs and
distributed locks), :class:`LockTimeout`, the lock-TTL hazard report, and
three stores:

- :class:`MemoryStore`: an in-process asyncio store with real TTL
  semantics and lock timeouts, with snapshot/restore to disk for
  resume-on-restart; one worker's default;
- ``native/client.py``'s ``MantleStore``: one shared native node
  (``native/mantlestore.cc``), what many workers of one host share;
- :class:`ReplicatedStore`: a leader and followers of the native node,
  with log shipping and lease failover.

``polled_store_lock`` is the one LOCK/UNLOCK polling protocol both
native clients speak.

TTLs follow redis semantics: ``ttl`` returns -2 for missing keys, -1 for
keys without expiry. All times come from an injectable monotonic clock so
round-lifecycle tests run at 2 s/round.
"""

from __future__ import annotations

import asyncio
import contextlib
import pickle
import time
import uuid
from typing import AsyncIterator, Callable, Dict, Optional, Set, Union

Value = Union[str, bytes, int, float]


class LockTimeout(Exception):
    """Raised when a distributed lock cannot be acquired in time."""


class StateStore:
    """Abstract async KV/hash/set store with TTLs and distributed locks."""

    # -- plain keys -------------------------------------------------------
    async def set(self, key: str, value: Value) -> None: raise NotImplementedError
    async def get(self, key: str) -> Optional[bytes]: raise NotImplementedError
    async def setex(self, key: str, ttl: float, value: Value) -> None: raise NotImplementedError
    async def delete(self, *keys: str) -> None: raise NotImplementedError
    async def exists(self, key: str) -> bool: raise NotImplementedError
    async def expire(self, key: str, ttl: float) -> None: raise NotImplementedError
    async def ttl(self, key: str) -> float: raise NotImplementedError

    # -- hashes -----------------------------------------------------------
    async def hset(self, key: str, field: Optional[str] = None,
                   value: Optional[Value] = None,
                   mapping: Optional[Dict[str, Value]] = None) -> None:
        raise NotImplementedError

    async def hget(self, key: str, field: str) -> Optional[bytes]: raise NotImplementedError
    async def hgetall(self, key: str) -> Dict[str, bytes]: raise NotImplementedError
    async def hdel(self, key: str, *fields: str) -> None: raise NotImplementedError
    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        raise NotImplementedError

    # -- sets -------------------------------------------------------------
    async def sadd(self, key: str, *members: str) -> None: raise NotImplementedError
    async def srem(self, key: str, *members: str) -> None: raise NotImplementedError
    async def smembers(self, key: str) -> Set[str]: raise NotImplementedError
    async def sismember(self, key: str, member: str) -> bool: raise NotImplementedError

    # -- locks ------------------------------------------------------------
    def lock(self, name: str, timeout: float = 120.0,
             blocking_timeout: float = 2.0):
        """Async context manager; raises LockTimeout if not acquired."""
        raise NotImplementedError

    async def close(self) -> None:  # pragma: no cover - trivial
        pass


def _to_bytes(v: Value) -> bytes:
    if isinstance(v, bytes):
        return v
    return str(v).encode()


def _strtoll(raw: bytes) -> int:
    """C ``strtoll`` semantics: parse an optional-signed leading integer,
    0 when none, as the reference's native store reads counters."""
    import re

    m = re.match(rb"\s*[+-]?\d+", raw)
    return int(m.group()) if m else 0


def _report_lock_hazard(kind: str, name: str) -> None:
    """Lock-TTL hazard telemetry: a hold that outlived its timeout means
    mutual exclusion was NOT guaranteed (another worker may have entered
    the critical section). Counted at ``store.lock_{kind}`` and logged —
    turning the reference's silent failure window into a signal."""
    from cassmantle_tpu_torch.utils.logging import get_logger, metrics

    metrics.inc(f"store.lock_{kind}")
    get_logger("store").warning(
        "lock %r %s: hold exceeded its TTL — mutual exclusion was not "
        "guaranteed; raise the lock timeout above the slowest critical "
        "section", name, kind.replace("_", " "))


@contextlib.asynccontextmanager
async def polled_store_lock(send, name: str, timeout: float,
                            blocking_timeout: float) -> AsyncIterator[None]:
    """The client side of the native store's LOCK/UNLOCK: poll every
    50 ms until ``blocking_timeout``, then :class:`LockTimeout`; UNLOCK's
    ``:2`` (held past the TTL) and ``:0`` (expired in the hold) report
    the hazard. Shared by ``MantleStore`` and :class:`ReplicatedStore`, so
    the two transports cannot drift. ``send(*args: bytes)`` is one
    command round trip."""
    token = uuid.uuid4().hex.encode()
    deadline = time.monotonic() + blocking_timeout
    ttl_ms = str(int(timeout * 1000)).encode()
    acquired = False
    while True:
        reply = await send(b"LOCK", name.encode(), token, ttl_ms)
        if reply == b"OK":
            acquired = True
            break
        if time.monotonic() >= deadline:
            break
        await asyncio.sleep(0.05)
    if not acquired:
        raise LockTimeout(name)
    try:
        yield
    finally:
        with contextlib.suppress(Exception):
            released = await send(b"UNLOCK", name.encode(), token)
            if released == 2:
                _report_lock_hazard("overrun", name)
            elif released == 0:
                _report_lock_hazard("expired_in_hold", name)


class MemoryStore(StateStore):
    """In-process store with redis-like TTL + lock semantics."""

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._data: Dict[str, object] = {}
        self._deadlines: Dict[str, float] = {}
        self._clock = clock or time.monotonic
        # Lock table: name -> (owner token, expiry deadline).
        self._locks: Dict[str, tuple] = {}
        self._lock_cond = asyncio.Condition()

    # -- expiry helpers ---------------------------------------------------
    def _alive(self, key: str) -> bool:
        if key not in self._data:
            return False
        deadline = self._deadlines.get(key)
        if deadline is not None and self._clock() >= deadline:
            del self._data[key]
            del self._deadlines[key]
            return False
        return True

    # -- plain keys -------------------------------------------------------
    async def set(self, key: str, value: Value) -> None:
        self._data[key] = _to_bytes(value)
        self._deadlines.pop(key, None)

    async def get(self, key: str) -> Optional[bytes]:
        if not self._alive(key):
            return None
        v = self._data[key]
        return v if isinstance(v, bytes) else None

    async def setex(self, key: str, ttl: float, value: Value) -> None:
        self._data[key] = _to_bytes(value)
        self._deadlines[key] = self._clock() + ttl

    async def delete(self, *keys: str) -> None:
        for key in keys:
            self._data.pop(key, None)
            self._deadlines.pop(key, None)

    async def exists(self, key: str) -> bool:
        return self._alive(key)

    async def expire(self, key: str, ttl: float) -> None:
        if self._alive(key):
            self._deadlines[key] = self._clock() + ttl

    async def ttl(self, key: str) -> float:
        if not self._alive(key):
            return -2.0
        deadline = self._deadlines.get(key)
        if deadline is None:
            return -1.0
        return max(0.0, deadline - self._clock())

    # -- hashes -----------------------------------------------------------
    def _hash(self, key: str, create: bool = False) -> Optional[Dict[str, bytes]]:
        """Wrong-type discipline (pinned by tests/test_store_parity.py so
        replication replay can rely on identical semantics across
        backends): reads of a live key of another kind behave like a
        missing key; writes REPLACE the entry with a fresh one of the
        new kind (TTL cleared — a fresh entry has no expiry)."""
        if not self._alive(key) or not isinstance(self._data[key], dict):
            if not create:
                return None
            self._data[key] = {}
            self._deadlines.pop(key, None)
        return self._data[key]

    async def hset(self, key: str, field: Optional[str] = None,
                   value: Optional[Value] = None,
                   mapping: Optional[Dict[str, Value]] = None) -> None:
        h = self._hash(key, create=True)
        if field is not None:
            h[field] = _to_bytes(value)
        if mapping:
            for k, v in mapping.items():
                h[k] = _to_bytes(v)

    async def hget(self, key: str, field: str) -> Optional[bytes]:
        h = self._hash(key)
        return None if h is None else h.get(field)

    async def hgetall(self, key: str) -> Dict[str, bytes]:
        h = self._hash(key)
        return {} if h is None else dict(h)

    async def hdel(self, key: str, *fields: str) -> None:
        h = self._hash(key)
        if h is not None:
            for f in fields:
                h.pop(f, None)

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        h = self._hash(key, create=True)
        new = _strtoll(h.get(field, b"0")) + amount
        h[field] = str(new).encode()
        return new

    # -- sets -------------------------------------------------------------
    def _set(self, key: str, create: bool = False) -> Optional[Set[str]]:
        # same wrong-type discipline as _hash (tests/test_store_parity.py)
        if not self._alive(key) or not isinstance(self._data[key], set):
            if not create:
                return None
            self._data[key] = set()
            self._deadlines.pop(key, None)
        return self._data[key]

    async def sadd(self, key: str, *members: str) -> None:
        self._set(key, create=True).update(members)

    async def srem(self, key: str, *members: str) -> None:
        s = self._set(key)
        if s is not None:
            s.difference_update(members)

    async def smembers(self, key: str) -> Set[str]:
        s = self._set(key)
        return set() if s is None else set(s)

    async def sismember(self, key: str, member: str) -> bool:
        s = self._set(key)
        return s is not None and member in s

    # -- locks ------------------------------------------------------------
    @contextlib.asynccontextmanager
    async def lock(self, name: str, timeout: float = 120.0,
                   blocking_timeout: float = 2.0) -> AsyncIterator[None]:
        """Mutual exclusion with hold-timeout (a crashed holder's lock
        self-expires after ``timeout``, like a redis lock's TTL)."""
        token = uuid.uuid4().hex
        deadline = self._clock() + blocking_timeout
        acquired = False
        while True:
            async with self._lock_cond:
                held = self._locks.get(name)
                if held is None or self._clock() >= held[1]:
                    self._locks[name] = (token, self._clock() + timeout)
                    acquired = True
                    break
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._lock_cond.wait(), timeout=min(remaining, 0.05)
                    )
        if not acquired:
            raise LockTimeout(name)
        try:
            yield
        finally:
            async with self._lock_cond:
                held = self._locks.get(name)
                now = self._clock()
                if held is not None and held[0] == token:
                    if now >= held[1]:
                        # race DETECTION (the reference only
                        # avoids): we held past the TTL,
                        # so exclusion was not guaranteed for the tail
                        # of this critical section. Size lock timeouts
                        # to the slowest holder, or this becomes the
                        # double-generation bug the locks exist to stop.
                        _report_lock_hazard("overrun", name)
                    del self._locks[name]
                else:
                    # expired mid-hold and (possibly) reacquired by
                    # another worker — two holders may have overlapped
                    _report_lock_hazard("expired_in_hold", name)
                self._lock_cond.notify_all()

    # -- durability (the reference gets this from redis persistence) ------
    def snapshot(self, path: str) -> None:
        """Persist non-expired state so a restart resumes the round.
        Expired keys are dropped first: the reference's comprehension
        drops them while iterating the dict and raises when one expired
        untouched."""
        now = self._clock()
        for key in list(self._data):
            self._alive(key)
        state = {
            "data": dict(self._data),
            "ttl_remaining": {
                k: self._deadlines[k] - now
                for k in self._deadlines
                if k in self._data
            },
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        now = self._clock()
        self._data = state["data"]
        self._deadlines = {
            k: now + rem
            for k, rem in state["ttl_remaining"].items()
            if rem > 0
        }
        for k, rem in state["ttl_remaining"].items():
            if rem <= 0:
                self._data.pop(k, None)


class ReplicatedStore(StateStore):
    """Replicated mantlestore client: leader writes + log-shipping pump.

    The cluster is a static set of mantlestore endpoints (one leader,
    N followers — ``--repl`` / ``--follower`` roles, native/mantlestore.cc).
    Every operation routes to the current leader; a background pump tails
    the leader's mutation log (``REPL TAIL``) and applies it to each
    follower (``REPL APPLY``) with acked offsets, so follower state is a
    deterministic replay of the leader's command stream (exactly-once:
    APPLY is conditional on the follower's applied offset, so racing
    pumps from several workers are safe).

    Failover: when the leader stops answering (connection refused, a
    timed-out round trip, or a ``READONLY`` rejection after a promotion
    elsewhere), the store probes the endpoint set, prefers any live
    node already in the leader role, and otherwise promotes the
    most-caught-up follower with ``REPL PROMOTE`` — which the follower
    accepts only once the replicated leader lease (a ``LOCK`` entry the
    leader heartbeats through its own log) has expired in its local
    lock table. Reads and writes block through the failover and resume
    against the new leader; round state survives because it was already
    shipped (tests/test_torch_port_replicated.py kills the leader
    mid-round).

    Concurrency contract: all I/O runs on the
    event loop; the ``fabric.replication`` OrderedLock (rank 5) guards
    only the in-process status snapshot (leader index, lag, counters)
    read by sync ``/readyz`` reporting — never held across an await or
    a store round trip.
    """

    def __init__(self, endpoints, *, poll_interval_s: float = 0.05,
                 op_timeout_s: float = 2.0, lease_timeout_s: float = 3.0,
                 failover_grace_s: Optional[float] = None,
                 pump: bool = True) -> None:
        from cassmantle_tpu_torch.utils.locks import OrderedLock

        assert endpoints, "ReplicatedStore needs at least one endpoint"
        self.endpoints = [self._parse_endpoint(e) for e in endpoints]
        self.poll_interval_s = poll_interval_s
        self.op_timeout_s = op_timeout_s
        self.lease_timeout_s = lease_timeout_s
        # how long ops keep retrying for a promotable leader: the lease
        # must lapse on a follower before PROMOTE succeeds, so the grace
        # covers one full lease plus probe slack
        self.failover_grace_s = (
            failover_grace_s if failover_grace_s is not None
            else 2.0 * lease_timeout_s + 3.0)
        self._pump_enabled = pump
        self._clients: Dict[int, object] = {}
        # the pump gets its OWN connections: a pump timeout can cancel a
        # round trip mid-reply, and a desynchronized connection must
        # never be the one game reads ride on (the next reader would
        # receive the stale replication reply as its value)
        self._pump_clients: Dict[int, object] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._state_lock = OrderedLock("fabric.replication", rank=5)
        self._leader: Optional[int] = None
        self._lag: int = 0
        self._failovers: int = 0
        self._shipped: int = 0
        # last applied offset seen per follower: a DOWN follower must
        # pin the reported lag to its last-known position (or the full
        # log), not silently drop out of the worst-lag calculation
        self._follower_applied: Dict[int, int] = {}

    @staticmethod
    def _parse_endpoint(ep) -> tuple:
        if isinstance(ep, tuple):
            return ep
        if isinstance(ep, int):
            return ("127.0.0.1", ep)
        host, _, port = str(ep).rpartition(":")
        return (host or "127.0.0.1", int(port))

    # -- client plumbing ---------------------------------------------------
    def _client(self, idx: int, pump: bool = False):
        table = self._pump_clients if pump else self._clients
        client = table.get(idx)
        if client is None:
            from cassmantle_tpu_torch.native.client import MantleStore

            host, port = self.endpoints[idx]
            client = table[idx] = MantleStore(host=host, port=port)
        return client

    async def _drop(self, idx: int, pump: bool = False) -> None:
        """Forget a (possibly dead or desynchronized) connection so the
        next use redials on a clean stream."""
        table = self._pump_clients if pump else self._clients
        client = table.pop(idx, None)
        if client is not None:
            with contextlib.suppress(Exception):
                await client.close()

    def _leader_idx(self) -> Optional[int]:
        with self._state_lock:
            return self._leader

    def _set_leader(self, idx: Optional[int]) -> None:
        with self._state_lock:
            self._leader = idx

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "ReplicatedStore":
        await self._ensure_leader()
        if self._pump_enabled and len(self.endpoints) > 1 \
                and self._pump_task is None:
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump_loop())
        return self

    async def close(self) -> None:
        task, self._pump_task = self._pump_task, None
        if task is not None:
            # re-deliver the cancel until it lands: py3.10's wait_for
            # can SWALLOW a cancellation that races the inner future's
            # completion (gh-86296), leaving the pump loop alive after
            # a single cancel() — close() would then await it forever
            # (reproduced under CPU contention; pinned by
            # tests/test_torch_port_replicated.py with a pump that
            # swallows one cancel)
            deadline = time.monotonic() + 5.0
            while not task.done() and time.monotonic() < deadline:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await asyncio.wait_for(asyncio.shield(task),
                                           timeout=0.05)
            if task.done():
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task
            else:  # pragma: no cover - defensive
                from cassmantle_tpu_torch.utils.logging import get_logger

                get_logger("store").error(
                    "replication pump refused cancellation; abandoning")
        for idx in list(self._clients):
            await self._drop(idx)
        for idx in list(self._pump_clients):
            await self._drop(idx, pump=True)

    # -- leader election ---------------------------------------------------
    async def _probe(self, idx: int) -> Optional[tuple]:
        """(role, applied) of one endpoint, None when unreachable."""
        client = self._client(idx)
        try:
            role = await asyncio.wait_for(
                client.repl_role(), timeout=self.op_timeout_s)
            _, _, applied = await asyncio.wait_for(
                client.repl_offset(), timeout=self.op_timeout_s)
            return role, applied
        except (Exception, asyncio.TimeoutError):
            await self._drop(idx)
            return None

    async def _ensure_leader(self, grace_s: Optional[float] = None) -> int:
        """Index of the current leader, electing one if needed. Prefers a
        live node already in the leader role; otherwise promotes the
        most-caught-up reachable follower (max applied offset — promoting
        a lagged one would discard shipped-but-unapplied suffix)."""
        idx = self._leader_idx()
        if idx is not None:
            return idx
        deadline = time.monotonic() + (
            self.failover_grace_s if grace_s is None else grace_s)
        while True:
            # probe concurrently: one election pass costs one probe
            # timeout, not one per dead node — serial probing could eat
            # the whole failover grace before reaching the live follower
            probes = await asyncio.gather(
                *(self._probe(i) for i in range(len(self.endpoints))))
            states = {i: p for i, p in enumerate(probes) if p is not None}
            leaders = [i for i, (role, _) in states.items()
                       if role == "leader"]
            if leaders:
                # two live leaders = a stalled ex-leader resumed after
                # its lease lapsed and a follower was promoted. Prefer
                # the most-caught-up one (the promoted node holds the
                # old leader's history PLUS post-failover writes);
                # operators must still retire the stale node — it keeps
                # calling itself leader
                best = max(leaders, key=lambda i: states[i][1])
                self._set_leader(best)
                return best
            if states:
                best = max(states, key=lambda i: states[i][1])
                try:
                    promoted = await asyncio.wait_for(
                        self._client(best).repl_promote(),
                        timeout=self.op_timeout_s)
                except (Exception, asyncio.TimeoutError):
                    from cassmantle_tpu_torch.utils.logging import metrics

                    # a failed promotion is an election that found a
                    # winner and could not seat it — the cluster stays
                    # leaderless another round; that must be countable,
                    # not just a longer outage
                    metrics.inc("repl.promote_failures")
                    promoted = False
                    await self._drop(best)
                if promoted:
                    with self._state_lock:
                        self._failovers += 1
                    self._set_leader(best)
                    from cassmantle_tpu_torch.obs.recorder import flight_recorder
                    from cassmantle_tpu_torch.utils.logging import metrics

                    metrics.inc("repl.failovers")
                    flight_recorder.record(
                        "fabric.failover",
                        leader="%s:%d" % self.endpoints[best])
                    return best
            if time.monotonic() >= deadline:
                raise ConnectionError(
                    "replicated store: no promotable leader among "
                    f"{self.endpoints}")
            await asyncio.sleep(min(0.05, self.poll_interval_s))

    async def _call(self, invoke):
        """Run one client operation against the leader, failing over on
        connection loss / timeout / READONLY rejection."""
        from cassmantle_tpu_torch.chaos import afault_point

        deadline = time.monotonic() + self.failover_grace_s
        while True:
            idx = await self._ensure_leader(
                grace_s=max(0.0, deadline - time.monotonic()))
            client = self._client(idx)
            try:
                # leader-boundary fault point: a peer-scoped partition
                # (host:port) raises ConnectionError and drives the SAME
                # drop + re-elect path a real leader cut does
                await afault_point("repl.leader_call",
                                   peer="%s:%d" % self.endpoints[idx])
                return await asyncio.wait_for(
                    invoke(client), timeout=self.op_timeout_s)
            except RuntimeError as exc:
                # -READONLY: the node lost leadership (promoted elsewhere)
                if "READONLY" not in str(exc):
                    raise
                self._set_leader(None)
            except (ConnectionError, OSError, EOFError,
                    asyncio.TimeoutError, asyncio.IncompleteReadError):
                await self._drop(idx)
                self._set_leader(None)
            if time.monotonic() >= deadline:
                raise ConnectionError(
                    "replicated store: leader unreachable past the "
                    f"failover grace ({self.failover_grace_s:.1f}s)")

    # -- log-shipping pump -------------------------------------------------
    async def _pump_loop(self) -> None:
        from cassmantle_tpu_torch.utils.logging import metrics

        while True:
            try:
                await self._pump_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                metrics.inc("repl.pump_errors")
            await asyncio.sleep(self.poll_interval_s)

    async def _pump_once(self) -> None:
        from cassmantle_tpu_torch.chaos import afault_point
        from cassmantle_tpu_torch.utils.logging import metrics

        # pump fault point: a raise lands in the loop's except (counted
        # repl.pump_errors, next tick retries); latency models a slow
        # shipping pass (repl.lag growth the drills can watch)
        await afault_point("repl.pump")
        leader_idx = self._leader_idx()
        if leader_idx is None:
            return
        leader = self._client(leader_idx, pump=True)
        # bounded like everything else in the pump: a black-holed leader
        # (no RST, no reply) must wedge THIS tick, not the coroutine —
        # the loop's except path counts it and the next tick retries
        # against whatever leader _call-level failover elected meanwhile
        try:
            _, log_end, _ = await asyncio.wait_for(
                leader.repl_offset(), timeout=self.op_timeout_s)
        except (Exception, asyncio.TimeoutError):
            await self._drop(leader_idx, pump=True)
            raise
        max_lag = 0
        for i in range(len(self.endpoints)):
            if i == leader_idx:
                continue
            follower = self._client(i, pump=True)
            try:
                # bounded per pass: a black-holed follower must not
                # stall shipping to the healthy ones; progress persists
                # across passes, so a far-behind follower just resumes
                # next tick
                applied = await asyncio.wait_for(
                    self._ship_to(leader, follower),
                    timeout=max(5.0, 4.0 * self.op_timeout_s))
                self._follower_applied[i] = applied
            except (Exception, asyncio.TimeoutError):
                # the timeout may have cancelled a round trip mid-reply
                # on EITHER side: drop both pump connections so the next
                # tick starts on clean streams (the game-op clients are
                # a separate table and stay untouched). The dead
                # follower still counts toward lag at its last-known
                # offset — an outage must read as lag GROWTH, not as a
                # healthy caught-up cluster. Counted too: lag growth
                # says "behind", the counter says "the pump is failing"
                metrics.inc("repl.ship_failures")
                await self._drop(i, pump=True)
                await self._drop(leader_idx, pump=True)
                applied = self._follower_applied.get(i, 0)
            max_lag = max(max_lag, log_end - applied)
        with self._state_lock:
            self._lag = max_lag
        metrics.gauge("repl.lag", float(max_lag))

    async def _ship_to(self, leader, follower, batch: int = 256) -> int:
        """Tail the leader's log into one follower until caught up;
        returns the follower's applied offset."""
        from cassmantle_tpu_torch.utils.logging import metrics

        _, _, applied = await follower.repl_offset()
        while True:
            _, log_end, _ = await leader.repl_offset()
            if applied >= log_end:
                return applied
            tailed = await leader.repl_tail(applied, batch)
            if tailed is None:
                # the leader trimmed past this follower: full resync
                end, dump = await leader.repl_dump()
                applied = await follower.repl_reset(end, dump)
                metrics.inc("repl.resyncs")
                continue
            next_offset, stream = tailed
            if next_offset <= applied:
                return applied
            new_applied = await follower.repl_apply(applied, stream)
            if new_applied >= next_offset:
                shipped = next_offset - applied
                with self._state_lock:
                    self._shipped += shipped
                metrics.inc("repl.shipped", shipped)
            # a racing pump (another worker) may have advanced it; either
            # way re-read and continue from the follower's truth
            applied = new_applied

    # -- status ------------------------------------------------------------
    def status(self) -> Dict[str, object]:
        """Sync snapshot for `/readyz` fabric reporting: leader identity,
        worst follower lag (commands), failover + shipped counters."""
        with self._state_lock:
            leader = self._leader
            lag = self._lag
            failovers = self._failovers
            shipped = self._shipped
        return {
            "endpoints": ["%s:%d" % ep for ep in self.endpoints],
            "leader": ("%s:%d" % self.endpoints[leader]
                       if leader is not None else None),
            "lag": lag,
            "failovers": failovers,
            "shipped": shipped,
        }

    # -- StateStore delegation --------------------------------------------
    async def set(self, key, value):
        return await self._call(lambda c: c.set(key, value))

    async def get(self, key):
        return await self._call(lambda c: c.get(key))

    async def setex(self, key, ttl, value):
        return await self._call(lambda c: c.setex(key, ttl, value))

    async def delete(self, *keys):
        return await self._call(lambda c: c.delete(*keys))

    async def exists(self, key):
        return await self._call(lambda c: c.exists(key))

    async def expire(self, key, ttl):
        return await self._call(lambda c: c.expire(key, ttl))

    async def ttl(self, key):
        return await self._call(lambda c: c.ttl(key))

    async def hset(self, key, field=None, value=None, mapping=None):
        return await self._call(
            lambda c: c.hset(key, field=field, value=value, mapping=mapping))

    async def hget(self, key, field):
        return await self._call(lambda c: c.hget(key, field))

    async def hgetall(self, key):
        return await self._call(lambda c: c.hgetall(key))

    async def hdel(self, key, *fields):
        return await self._call(lambda c: c.hdel(key, *fields))

    async def hincrby(self, key, field, amount: int = 1):
        return await self._call(lambda c: c.hincrby(key, field, amount))

    async def sadd(self, key, *members):
        return await self._call(lambda c: c.sadd(key, *members))

    async def srem(self, key, *members):
        return await self._call(lambda c: c.srem(key, *members))

    async def smembers(self, key):
        return await self._call(lambda c: c.smembers(key))

    async def sismember(self, key, member):
        return await self._call(lambda c: c.sismember(key, member))

    # -- locks ------------------------------------------------------------
    def lock(self, name: str, timeout: float = 120.0,
             blocking_timeout: float = 2.0):
        """The shared polled lock protocol with each round trip routed
        through leader failover. A failover mid-hold keeps exclusion:
        the lease-replicated lock table means the new leader already
        knows the holder's token."""

        async def send(*args: bytes):
            return await self._call(lambda c: c.raw_command(*args))

        return polled_store_lock(send, name, timeout, blocking_timeout)
