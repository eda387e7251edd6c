"""Serving flight recorder: a bounded ring of structured events.

A copy of ``cassmantle_tpu/obs/recorder.py``. Breaker
transitions, watchdog fires, deadline expiries, chaos injections,
integrity verdicts and device-loss states land here in order, each with
a sequence number and a wall timestamp, so the story before a degraded
verdict can be replayed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from cassmantle_tpu_torch.utils.logging import metrics


class FlightRecorder:
    def __init__(self, capacity: int = 512) -> None:
        assert capacity > 0, "recorder capacity must be positive"
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0

    def set_capacity(self, capacity: int) -> None:
        """Resize in place, keeping the newest events on a shrink."""
        capacity = max(1, int(capacity))
        with self._lock:
            if capacity == self._events.maxlen:
                return
            kept = list(self._events)[-capacity:]
            self._dropped += len(self._events) - len(kept)
            self._events = deque(kept, maxlen=capacity)

    def record(self, kind: str, **fields) -> None:
        """Append one event (``fields`` JSON-serializable)."""
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append({"seq": self._seq, "ts": time.time(),
                                 "kind": kind, **fields})
        metrics.inc("obs.events")

    def tail(self, n: Optional[int] = None,
             kind: Optional[str] = None) -> List[dict]:
        """The newest events, oldest first; ``kind`` filters by exact kind
        or by a ``prefix.`` (trailing dot)."""
        with self._lock:
            events = list(self._events)
        if kind is not None:
            if kind.endswith("."):
                events = [e for e in events if e["kind"].startswith(kind)]
            else:
                events = [e for e in events if e["kind"] == kind]
        if n is not None:
            events = events[-int(n):] if int(n) > 0 else []
        return events

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"events": len(self._events),
                    "capacity": self._events.maxlen or 0,
                    "total_recorded": self._seq, "dropped": self._dropped}


flight_recorder = FlightRecorder()
