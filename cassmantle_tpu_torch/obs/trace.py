"""Request-scoped tracing: contextvar propagation and a bounded span sink.

A copy of ``cassmantle_tpu/obs/trace.py`` trimmed to what the batching
queue uses (``:82-128``, ``:182-325``, ``:358-366``, ``:422-497``): the
ambient :class:`SpanContext` rides a :mod:`contextvars` variable, crosses
the dispatch thread explicitly (:func:`run_with_ctx`), and the queue
records per-member queue-wait and batch-service spans linked to the
shared batch span. Each root context carries a ``marks`` dict shared by
the whole request (the queue writes ``queue_wait_s`` and ``service_s``
into it). Sampling is by head only here: the reference's tail-retention
ring and W3C ``traceparent`` propagation serve the HTTP server, a later
slice; :meth:`Tracer.mark_retain` keeps the reference's mark.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import List, Optional

from cassmantle_tpu_torch.utils.logging import metrics


class SpanContext:
    """Who the ambient span is; ``marks`` is the per-request blackboard."""

    __slots__ = ("trace_id", "span_id", "sampled", "marks")

    def __init__(self, trace_id: str, span_id: str, sampled: bool,
                 marks: Optional[dict] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.marks = marks if marks is not None else {}


_current: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("cassmantle_span", default=None)


def current_ctx() -> Optional[SpanContext]:
    return _current.get()


def run_with_ctx(ctx: Optional[SpanContext], fn, *args):
    """Run ``fn(*args)`` with ``ctx`` as the ambient span: the explicit
    hop onto another thread (contextvars do not follow plain threads)."""
    token = _current.set(ctx)
    try:
        return fn(*args)
    finally:
        _current.reset(token)


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[: 2 * nbytes]


class Tracer:
    """Span factory and bounded per-trace sink (LRU over traces)."""

    def __init__(self, capacity: int = 256, sample_rate: float = 1.0,
                 max_spans_per_trace: int = 512,
                 rng: Optional[random.Random] = None) -> None:
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.capacity = capacity
        self.sample_rate = sample_rate
        self.max_spans_per_trace = max_spans_per_trace
        self._rng = rng or random.Random()

    def new_root_ctx(self) -> SpanContext:
        sampled = (self.sample_rate >= 1.0
                   or self._rng.random() < self.sample_rate)
        return SpanContext(_new_id(16), _new_id(8), sampled, marks={})

    def child_ctx(self, parent: Optional[SpanContext]) -> SpanContext:
        """A child of ``parent`` (same trace and marks); a new root when
        there is no parent."""
        if parent is None:
            return self.new_root_ctx()
        return SpanContext(parent.trace_id, _new_id(8), parent.sampled,
                           marks=parent.marks)

    def detached_ctx(self) -> SpanContext:
        """An always-unsampled context (a batch with no traced member)."""
        return SpanContext(_new_id(16), _new_id(8), False, marks={})

    def record_span(self, name: str, ctx: SpanContext, *,
                    parent_id: Optional[str] = None,
                    start_wall: float, duration_s: float,
                    status: str = "ok",
                    attrs: Optional[dict] = None) -> None:
        """Sink an already-timed span; a no-op when unsampled."""
        if not ctx.sampled:
            return
        span = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
                "parent_id": parent_id, "name": name,
                "start_ts": start_wall, "duration_s": duration_s,
                "status": status}
        if attrs:
            span["attrs"] = dict(attrs)
        with self._lock:
            spans = self._traces.get(ctx.trace_id)
            if spans is None:
                while len(self._traces) >= self.capacity:
                    self._traces.popitem(last=False)
                    metrics.inc("obs.trace_evictions")
                spans = self._traces[ctx.trace_id] = []
            else:
                self._traces.move_to_end(ctx.trace_id)
            if len(spans) >= self.max_spans_per_trace:
                metrics.inc("obs.spans_dropped")
                return
            spans.append(span)
        metrics.inc("obs.spans")

    def mark_retain(self, reason: str,
                    ctx: Optional[SpanContext] = None) -> None:
        """Flag the (ambient) trace as worth keeping; first reason wins."""
        c = ctx if ctx is not None else _current.get()
        if c is not None:
            c.marks.setdefault("tail.retain", str(reason))

    @contextmanager
    def span(self, name: str, *, root: bool = False,
             attrs: Optional[dict] = None):
        """Open a span as the new ambient context (``root=True``: a fresh
        trace); exceptions mark it ``error`` and propagate."""
        pctx = None if root else _current.get()
        ctx = self.child_ctx(pctx)
        token = _current.set(ctx)
        start_wall = time.time()
        start = time.perf_counter()
        status = "ok"
        try:
            yield ctx
        except BaseException:
            status = "error"
            raise
        finally:
            _current.reset(token)
            self.record_span(
                name, ctx, parent_id=pctx.span_id if pctx else None,
                start_wall=start_wall,
                duration_s=time.perf_counter() - start, status=status,
                attrs=attrs)

    def get_trace(self, trace_id: str) -> Optional[List[dict]]:
        with self._lock:
            spans = self._traces.get(trace_id)
            return [dict(s) for s in spans] if spans is not None else None


tracer = Tracer()
