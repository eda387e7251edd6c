"""Request-scoped tracing: contextvar propagation and a bounded span sink.

A copy of ``cassmantle_tpu/obs/trace.py``. Every HTTP request gets a
trace id (returned as ``X-Trace-Id``) and a root span (the server's
tracing middleware); the ambient :class:`SpanContext` rides a
:mod:`contextvars` variable across ``await`` chains and crosses the
dispatch thread explicitly (:func:`run_with_ctx`); the batching queue
records per-member queue-wait and batch-service spans linked to the
shared batch span, and writes ``queue_wait_s`` and ``service_s`` into
the request's ``marks`` blackboard (the ``X-Queue-Wait`` and
``X-Service-Time`` headers).

Sampling is by tail with a head floor: the root's coin decides whether a
trace is durable from its start (``head``); every other trace buffers its
spans in a bounded pending ring until its root ends, and is kept only
when the root ended errored, slower than its route's threshold, or
marked (:meth:`Tracer.mark_retain`: shed, degraded, chaos); traces whose
root never ends age out (``obs.traces_abandoned``).
``CASSMANTLE_NO_TAIL_SAMPLING=1`` makes the coin the whole decision.

A trace crosses a worker boundary as a W3C ``traceparent`` token
(:func:`format_traceparent`, :func:`parse_traceparent`):
``tracer.span(..., parent=remote_ctx)`` continues it.
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

from cassmantle_tpu_torch.utils.logging import metrics


def _no_tail_sampling() -> bool:
    """Kill switch, read per use (flipping the env mid-flight takes
    effect on the next root context / observation, no restart)."""
    return os.environ.get(
        "CASSMANTLE_NO_TAIL_SAMPLING", "").lower() in \
        ("1", "true", "yes", "on")


class SpanContext:
    """Immutable-by-convention propagation record: who the ambient span
    is. ``marks`` is the one deliberately shared mutable field — the
    per-request blackboard (see module docstring). ``head`` says whether
    the trace is already durably retained (head-sampled, or continued
    from a remote hop): head spans record directly; non-head spans
    buffer pending the root's retention verdict."""

    __slots__ = ("trace_id", "span_id", "sampled", "marks", "head")

    def __init__(self, trace_id: str, span_id: str, sampled: bool,
                 marks: Optional[dict] = None, head: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.marks = marks if marks is not None else {}
        self.head = head


_current: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("cassmantle_span", default=None)


def current_ctx() -> Optional[SpanContext]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


def current_marks() -> Optional[dict]:
    ctx = _current.get()
    return ctx.marks if ctx is not None else None


def run_with_ctx(ctx: Optional[SpanContext], fn, *args):
    """Run ``fn(*args)`` with ``ctx`` as the ambient span — the explicit
    cross-thread hop (dispatch thread, executors): contextvars don't
    follow plain threads."""
    token = _current.set(ctx)
    try:
        return fn(*args)
    finally:
        _current.reset(token)


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[: 2 * nbytes]


# W3C trace-context shape, version 00: 16-byte trace id, 8-byte span id
# (exactly the widths this tracer already mints), 1 flag byte whose low
# bit is "sampled".
_TRACEPARENT = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def format_traceparent(ctx: SpanContext) -> str:
    """The outbound wire form of a context — what the fabric pins onto
    a cross-worker 307 ``Location`` (query param) and what a peer
    fan-out sends as a header."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-" \
           f"{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """A :class:`SpanContext` from an inbound ``traceparent`` token, or
    None for anything malformed (malformed input is DROPPED, never a
    fresh trace — the caller decides what an absent context means). The
    marks blackboard is fresh: it is per-request local state, never
    shared across the worker boundary."""
    if not value:
        return None
    m = _TRACEPARENT.match(value.strip().lower())
    if not m:
        return None
    return SpanContext(m.group(1), m.group(2), m.group(3) != "00",
                       marks={})


class _SpanHandle:
    """What ``tracer.span`` yields: the live ids plus mutable attrs."""

    __slots__ = ("ctx", "attrs")

    def __init__(self, ctx: SpanContext, attrs: dict) -> None:
        self.ctx = ctx
        self.attrs = attrs

    @property
    def trace_id(self) -> str:
        return self.ctx.trace_id

    @property
    def span_id(self) -> str:
        return self.ctx.span_id


class Tracer:
    """Span factory + bounded per-trace sink. One global per process
    (``tracer``); instantiable standalone for tests."""

    def __init__(self, capacity: int = 256, sample_rate: float = 1.0,
                 max_spans_per_trace: int = 512,
                 rng: Optional[random.Random] = None) -> None:
        self._lock = threading.Lock()
        # trace_id -> list of finished span dicts, LRU-ordered (a new
        # span refreshes its trace's position, so long-running traces
        # survive bursts of short ones); eviction drops a whole trace
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        # ids of evicted traces (bounded memory): a late span from an
        # evicted trace must be DROPPED, not resurrect a torn partial
        # trace that /debugz would serve with no hint its head is gone
        self._evicted: "OrderedDict[str, None]" = OrderedDict()
        # trace_id -> {"spans": [...], "t": creation wall time} for
        # non-head traces awaiting their root's retention verdict;
        # insertion-ordered so the TTL sweep walks oldest-first
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        self.capacity = capacity
        self.sample_rate = sample_rate
        self.max_spans_per_trace = max_spans_per_trace
        self.pending_capacity = 512
        self.pending_ttl_s = 120.0
        self.tail_slow_default_s = 1.0
        # root-span name ("http.post /compute_score") -> seconds
        self.tail_slow_routes: Dict[str, float] = {}
        self._rng = rng or random.Random()

    def configure(self, *, capacity: Optional[int] = None,
                  sample_rate: Optional[float] = None,
                  max_spans_per_trace: Optional[int] = None,
                  pending_capacity: Optional[int] = None,
                  pending_ttl_s: Optional[float] = None,
                  tail_slow_default_s: Optional[float] = None,
                  tail_slow_routes: Optional[dict] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
                while len(self._traces) > self.capacity:
                    evicted_id, _ = self._traces.popitem(last=False)
                    self._remember_evicted(evicted_id)
            if sample_rate is not None:
                self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
            if max_spans_per_trace is not None:
                self.max_spans_per_trace = max(1, int(max_spans_per_trace))
            if pending_capacity is not None:
                self.pending_capacity = max(1, int(pending_capacity))
                while len(self._pending) > self.pending_capacity:
                    tid, _ = self._pending.popitem(last=False)
                    self._remember_evicted(tid)
                    metrics.inc("obs.traces_abandoned")
            if pending_ttl_s is not None:
                self.pending_ttl_s = max(0.0, float(pending_ttl_s))
            if tail_slow_default_s is not None:
                self.tail_slow_default_s = max(0.0,
                                               float(tail_slow_default_s))
            if tail_slow_routes is not None:
                self.tail_slow_routes = {
                    str(k): float(v) for k, v in
                    (tail_slow_routes.items()
                     if isinstance(tail_slow_routes, dict)
                     else tail_slow_routes)}

    # -- context derivation ----------------------------------------------
    def new_root_ctx(self) -> SpanContext:
        """Fresh trace. The sampling coin is drawn here; under tail
        sampling it decides head-certainty (the healthy-baseline floor)
        and every trace starts sampled pending its retention verdict.
        With ``CASSMANTLE_NO_TAIL_SAMPLING`` set the coin IS the
        sampling decision — the exact pre-tail behavior."""
        coin = (self.sample_rate >= 1.0
                or self._rng.random() < self.sample_rate)
        if _no_tail_sampling():
            return SpanContext(_new_id(16), _new_id(8), coin, marks={})
        return SpanContext(_new_id(16), _new_id(8), True, marks={},
                           head=coin)

    def child_ctx(self, parent: Optional[SpanContext]) -> SpanContext:
        """A child of ``parent`` (same trace, same marks blackboard);
        a new root when there is no parent."""
        if parent is None:
            return self.new_root_ctx()
        return SpanContext(parent.trace_id, _new_id(8), parent.sampled,
                           marks=parent.marks, head=parent.head)

    def detached_ctx(self) -> SpanContext:
        """An always-unsampled context: lets shared infrastructure (a
        batch with no traced members) run span-producing code paths
        without recording anything or minting ring-occupying traces."""
        return SpanContext(_new_id(16), _new_id(8), False, marks={})

    # -- recording --------------------------------------------------------
    def record_span(self, name: str, ctx: SpanContext, *,
                    parent_id: Optional[str] = None,
                    start_wall: float, duration_s: float,
                    status: str = "ok",
                    attrs: Optional[dict] = None) -> None:
        """Sink an already-timed span (the queue's wait/service spans are
        measured outside any ``with`` block). No-op when unsampled."""
        if not ctx.sampled:
            return
        span = {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_id": parent_id,
            "name": name,
            "start_ts": start_wall,
            "duration_s": duration_s,
            "status": status,
        }
        if attrs:
            span["attrs"] = dict(attrs)
        with self._lock:
            spans = self._traces.get(ctx.trace_id)
            if spans is None:
                if ctx.trace_id in self._evicted:
                    metrics.inc("obs.spans_dropped")
                    return
                if not ctx.head:
                    # tail-pending: buffer until the root's retention
                    # verdict (_finish_root). obs.spans counts only on
                    # promotion — a dropped pending trace recorded
                    # nothing, exactly like a pre-tail unsampled one.
                    self._record_pending_locked(span, ctx.trace_id)
                    return
                while len(self._traces) >= self.capacity:
                    evicted_id, _ = self._traces.popitem(last=False)
                    self._remember_evicted(evicted_id)
                    metrics.inc("obs.trace_evictions")
                spans = []
                self._traces[ctx.trace_id] = spans
            else:
                self._traces.move_to_end(ctx.trace_id)
            if len(spans) >= self.max_spans_per_trace:
                # cap hit: drop honestly — count it and mark the last
                # resident span so /debugz shows the trace is truncated
                metrics.inc("obs.spans_dropped")
                spans[-1].setdefault("attrs", {})["truncated"] = True
                return
            spans.append(span)
        metrics.inc("obs.spans")

    def _record_pending_locked(self, span: dict, trace_id: str) -> None:
        pend = self._pending.get(trace_id)
        if pend is None:
            self._sweep_pending_locked(time.time())
            while len(self._pending) >= self.pending_capacity:
                # capacity pressure evicts the oldest pending trace —
                # its root will find nothing to promote, same as a TTL
                # abandonment, and late spans drop via _evicted
                tid, _ = self._pending.popitem(last=False)
                self._remember_evicted(tid)
                metrics.inc("obs.traces_abandoned")
            pend = {"spans": [], "t": time.time()}
            self._pending[trace_id] = pend
        spans = pend["spans"]
        if len(spans) >= self.max_spans_per_trace:
            metrics.inc("obs.spans_dropped")
            spans[-1].setdefault("attrs", {})["truncated"] = True
            return
        spans.append(span)

    def _sweep_pending_locked(self, now: float) -> None:
        """Age out pending traces whose root never completed (client
        disconnect, watchdog kill): oldest-first, stopping at the first
        young entry — bounded work per sweep by construction."""
        while self._pending:
            tid, pend = next(iter(self._pending.items()))
            if now - pend["t"] <= self.pending_ttl_s:
                break
            del self._pending[tid]
            self._remember_evicted(tid)
            metrics.inc("obs.traces_abandoned")

    def mark_retain(self, reason: str,
                    ctx: Optional[SpanContext] = None) -> None:
        """Flag the (ambient) trace for tail retention regardless of its
        latency — the hook the HTTP layer uses for shed/degraded
        responses, chaos for injections, and the prober for its probes.
        First reason wins (the earliest cause is the interesting one).
        Harmless on head traces (they are already durable)."""
        c = ctx if ctx is not None else _current.get()
        if c is not None:
            c.marks.setdefault("tail.retain", str(reason))

    def _finish_root(self, ctx: SpanContext, name: str,
                     duration_s: float, status: str) -> None:
        """The tail-retention verdict, at root-span completion of a
        non-head trace: promote (error / marked / slow) or drop —
        either way the pending occupancy is reclaimed."""
        slow = duration_s >= self.tail_slow_routes.get(
            name, self.tail_slow_default_s)
        mark = ctx.marks.get("tail.retain")
        reason = None
        if mark == "baseline":
            # explicit demotion (the HTTP layer's routine-non-2xx
            # verdict: 307 ownership hops, 4xx): slow still retains,
            # the error status alone does not
            reason = "slow" if slow else None
        elif mark:
            reason = mark
        elif status != "ok":
            reason = "error"
        elif slow:
            reason = "slow"
        promoted = 0
        with self._lock:
            pend = self._pending.pop(ctx.trace_id, None)
            if reason is not None and pend is not None:
                while len(self._traces) >= self.capacity:
                    evicted_id, _ = self._traces.popitem(last=False)
                    self._remember_evicted(evicted_id)
                    metrics.inc("obs.trace_evictions")
                self._traces[ctx.trace_id] = pend["spans"]
                promoted = len(pend["spans"])
            else:
                # completed-but-unretained (or already swept): the id
                # must never re-enter pending via a straggler span
                self._remember_evicted(ctx.trace_id)
        if promoted:
            metrics.inc("obs.spans", promoted)
            metrics.inc("obs.tail_retained")
            metrics.retain_exemplars(ctx.trace_id)
            from cassmantle_tpu_torch.obs.recorder import flight_recorder
            flight_recorder.record(
                "trace.tail_retained", trace=ctx.trace_id, route=name,
                reason=reason, duration_s=round(duration_s, 6))
        else:
            metrics.discard_exemplars(ctx.trace_id)

    def _remember_evicted(self, trace_id: str) -> None:
        """Bounded (4x capacity) eviction memory; oldest ids age out —
        by then their in-flight spans have long since finished."""
        self._evicted[trace_id] = None
        while len(self._evicted) > 4 * self.capacity:
            self._evicted.popitem(last=False)

    @contextmanager
    def span(self, name: str, *, root: bool = False,
             parent: Optional[SpanContext] = None,
             attrs: Optional[dict] = None):
        """Open a span as the new ambient context, child of the ambient
        parent. ``root=True`` forces a fresh trace; ``parent=`` CONTINUES
        an explicit (typically remote, traceparent-parsed) context
        instead — same trace id, that span as parent — which is how a
        cross-worker hop stays one trace. The body may mutate
        ``handle.attrs``; exceptions mark status=error and propagate.
        (Spans with an explicit non-ambient parent — the queue's batch
        split — go through :meth:`record_span` directly.)"""
        if parent is not None:
            ctx = self.child_ctx(parent)
            parent_id = parent.span_id
        elif root:
            ctx = self.new_root_ctx()
            parent_id = None
        else:
            pctx = _current.get()
            ctx = self.child_ctx(pctx)
            parent_id = pctx.span_id if pctx is not None else None
        handle = _SpanHandle(ctx, dict(attrs) if attrs else {})
        token = _current.set(ctx)
        start_wall = time.time()
        start = time.perf_counter()
        status = "ok"
        try:
            yield handle
        except BaseException:
            status = "error"
            raise
        finally:
            _current.reset(token)
            duration_s = time.perf_counter() - start
            self.record_span(
                name, ctx, parent_id=parent_id, start_wall=start_wall,
                duration_s=duration_s, status=status,
                attrs=handle.attrs)
            if root and ctx.sampled and not ctx.head:
                # the trace's root just completed: issue the tail
                # retention verdict (promote or reclaim). Spans with an
                # explicit parent= continue someone else's trace — the
                # verdict belongs to THAT root, never the hop.
                self._finish_root(ctx, name, duration_s, status)

    # -- query ------------------------------------------------------------
    def get_trace(self, trace_id: str) -> Optional[List[dict]]:
        """Durable ring first; a still-pending trace answers too (an
        operator chasing a live request must not see a 404 that flips
        to data one second later)."""
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                pend = self._pending.get(trace_id)
                if pend is not None:
                    spans = pend["spans"]
            return [dict(s) for s in spans] if spans is not None else None

    def trace_ids(self) -> List[str]:
        """Oldest-first resident trace ids (the ``/debugz`` listing) —
        durable (retained) traces only; pending ones are in flight."""
        with self._lock:
            return list(self._traces.keys())

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "traces": len(self._traces),
                "capacity": self.capacity,
                "sample_rate": self.sample_rate,
                "pending": len(self._pending),
                "pending_capacity": self.pending_capacity,
            }


tracer = Tracer()


def _exemplar_probe():
    """Metrics→trace linkage (utils.logging exemplars): every histogram
    observation asks which trace it belongs to. Head traces are already
    durable (certain → bucket exemplar written immediately); pending
    tail traces park as candidates until their retention verdict. The
    tail-sampling kill switch disables the linkage entirely — the
    pre-tail exposition had no exemplars."""
    if _no_tail_sampling():
        return None
    ctx = _current.get()
    if ctx is None or not ctx.sampled:
        return None
    return ctx.trace_id, ctx.head


metrics.set_exemplar_source(_exemplar_probe)
