"""Per-principal token-bucket rate limiting.

A copy of ``cassmantle_tpu/server/ratelimit.py``: the reference's policy
(3 requests a second by default, 2 on the API routes) as a small token
bucket. Buckets are keyed by ``((client IP, room), route class)``: a
noisy room drains only its own quota, and the identity half stays the
IP (session ids are client-minted). A full table evicts idle buckets
first, then the longest-idle tenth, never all at once: active clients
keep their spent tokens.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

# (client-ip, room) — the unit that owns a quota
Principal = Tuple[str, str]


class TokenBucket:
    def __init__(self, rate: float, burst: float = None) -> None:
        self.rate = rate
        self.burst = burst if burst is not None else max(1.0, rate)
        self.tokens = self.burst
        self.updated = time.monotonic()

    def allow(self) -> bool:
        now = time.monotonic()
        self.tokens = min(
            self.burst, self.tokens + (now - self.updated) * self.rate
        )
        self.updated = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until this bucket refills one whole token: the
        computed Retry-After a 429 carries (tokens were already refreshed
        by the failing allow())."""
        if self.tokens >= 1.0 or self.rate <= 0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


class RateLimiter:
    """Buckets keyed by (principal, class); stale buckets evicted on
    overflow.

    Eviction is targeted, never a flush: clearing the whole table when
    full would reset EVERY active client's bucket to a full burst at
    once — a synchronized admission spike exactly when the table is
    busiest. Instead, overflow drops buckets idle longer than
    ``stale_s``, then (if still full) the longest-idle tail, so active
    clients keep their spent tokens.
    """

    def __init__(self, max_entries: int = 10000,
                 stale_s: float = 60.0) -> None:
        self._buckets: Dict[Tuple[Principal, str], TokenBucket] = {}
        self.max_entries = max_entries
        self.stale_s = stale_s

    def _evict(self) -> None:
        now = time.monotonic()
        stale = [k for k, b in self._buckets.items()
                 if now - b.updated > self.stale_s]
        for k in stale:
            del self._buckets[k]
        if len(self._buckets) >= self.max_entries:
            # still full of active clients: shed the longest-idle tenth
            by_idle = sorted(self._buckets, key=lambda k: self._buckets[k].updated)
            for k in by_idle[:max(1, self.max_entries // 10)]:
                del self._buckets[k]

    def allow(self, principal: Principal, route_class: str,
              rate: float) -> bool:
        key = (principal, route_class)
        bucket = self._buckets.get(key)
        if bucket is None:
            if len(self._buckets) >= self.max_entries:
                self._evict()
            bucket = self._buckets[key] = TokenBucket(rate)
        return bucket.allow()

    def retry_after_s(self, principal: Principal,
                      route_class: str) -> float:
        """The rejecting bucket's actual refill time (0 when absent —
        a race with eviction; the caller floors the header at 1)."""
        bucket = self._buckets.get((principal, route_class))
        return bucket.retry_after_s() if bucket is not None else 0.0
