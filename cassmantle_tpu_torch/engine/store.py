"""Async game-state store: the game's coordination plane.

A copy of ``cassmantle_tpu/engine/store.py``'s :class:`StateStore`
contract (the redis subset the game uses: keys, hashes, sets, TTLs and
distributed locks), :class:`LockTimeout`, the lock-TTL hazard report, and
:class:`MemoryStore`: an in-process asyncio store with real TTL semantics
and lock timeouts, with snapshot/restore to disk for resume-on-restart.
The replicated store over the native server is not ported.

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
