"""Stage timers, profiler ranges and trace capture.

Port of ``cassmantle_tpu/utils/profiling.py`` on ``torch.profiler``.

:func:`block_timer` times a serving stage into a histogram and, when a
trace is ambient, a stage span. A stage ends when its result is on the
host: every timed site copies its result back inside the block, which
waits for its own stream's work and no other thread's. The timer adds no
wait of its own (a device-wide synchronize would wait for the other
threads' work and bill it to this span).

With ``flops_est`` (the dispatch's :class:`~cassmantle_tpu_torch.obs.
costmodel.Products`, a number of bf16 operations, or a callable returning
either at exit) and a ``pipeline`` label, a dispatch that completed adds
its operations to ``request.device_flops{pipeline}``, sets
``pipeline.mxu_utilization{pipeline}`` to its share of the card's peak
(``obs/costmodel.py::utilization``) and puts both on its span. A body
that raised attributes nothing. ``pipeline`` alone also reports the
dispatch to the device telemetry's high-water mark
(``obs/device.py::note_dispatch``).

:func:`annotate` names a host range in a ``torch.profiler`` trace
(``record_function``); :func:`trace` captures one to a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Capture host and CUDA activity with torch's profiler into a Chrome
    trace in ``log_dir``; yields the trace file's path, written at exit.
    A no-op yielding None without a directory.

    Started and stopped on the calling thread (the profiler is
    process-global). Only the switch of the tracing, on and off, holds
    off CUDA graph launches (``ops/graphs.py::no_graph_running``): the
    synchronize before the stop, and the trace's writing by the profiler's
    own C++ (no Python object per event), leave graph launches free."""
    if not log_dir:
        yield None
        return
    from torch.autograd import _disable_profiler
    from torch.autograd import profiler as autograd_profiler

    from cassmantle_tpu_torch.obs.costmodel import import_dynamo
    from cassmantle_tpu_torch.ops.graphs import no_graph_running

    import_dynamo()           # not at once with a cost count's thread
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    cuda = torch.cuda.is_available()
    prof = autograd_profiler.profile(use_device="cuda" if cuda else None,
                                     use_kineto=True)
    with no_graph_running():
        prof._prepare_trace()
        prof._start_trace()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        with no_graph_running():
            result = _disable_profiler()
        stopped = getattr(autograd_profiler, "_run_on_profiler_stop", None)
        if stopped is not None:
            stopped()
        result.save(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a range in the profiler's trace."""
    with torch.profiler.record_function(name):
        yield


def _products(flops_est):
    from cassmantle_tpu_torch.obs.costmodel import Products

    value = flops_est() if callable(flops_est) else flops_est
    if value is None:
        return None
    if not isinstance(value, Products):
        value = Products(bf16=float(value))
    return value if value.total > 0 else None


@contextlib.contextmanager
def block_timer(name: str, *, flops_est=None,
                pipeline: Optional[str] = None) -> Iterator[None]:
    """Time a stage into histogram ``name`` and a stage span, up to the
    block's end (its result on the host)."""
    from cassmantle_tpu_torch.obs.trace import current_ctx, tracer

    start_wall = time.time()
    start = time.perf_counter()
    ok = False
    try:
        yield
        ok = True
    finally:
        elapsed = time.perf_counter() - start
        metrics.observe(name, elapsed)
        attrs = {"device_synced": True}
        products = None
        # attribution only for a dispatch that completed: one that raised
        # did not do its work, and its short elapsed would read as a spike
        if ok and flops_est is not None:
            try:
                products = _products(flops_est)
            except Exception:  # attribution never fails a dispatch
                log.exception("flops estimate for %s failed", name)
        if products is not None:
            from cassmantle_tpu_torch.obs.costmodel import utilization

            labels = {"pipeline": pipeline} if pipeline else None
            metrics.inc("request.device_flops", products.total,
                        labels=labels)
            attrs["flops_est"] = products.total
            if products.int8:
                attrs["flops_int8"] = products.int8
            if elapsed > 0:
                share = utilization(products, elapsed)
                attrs["mxu_utilization"] = round(share, 6)
                metrics.gauge("pipeline.mxu_utilization", share,
                              labels=labels)
        if pipeline:
            from cassmantle_tpu_torch.obs.device import note_dispatch

            note_dispatch(pipeline)
        ctx = current_ctx()
        if ctx is not None and ctx.sampled:
            tracer.record_span(
                name, tracer.child_ctx(ctx), parent_id=ctx.span_id,
                start_wall=start_wall, duration_s=elapsed, attrs=attrs)
