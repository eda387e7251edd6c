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
(``obs/costmodel.py::utilization``; of the ``cards`` distinct cards'
peaks for a meshed dispatch) and puts both on its span. A body
that raised attributes nothing. ``pipeline`` alone also reports the
dispatch to the device telemetry's high-water mark
(``obs/device.py::note_dispatch``).

:func:`annotate` names a host range in a ``torch.profiler`` trace
(``record_function``); :func:`trace` captures one to a directory.

:func:`capture` (``POST /debug/trace``) records N seconds as consecutive
short windows, each a :func:`trace` of its own written into the one
directory. Stopping a window collects its events while holding the
interpreter and, under ``ops/graphs.py::no_graph_running``, every CUDA
graph launch; writing it holds the interpreter again. Both grow with the
window's events (on an H100 about 40 us of stop a kernel event), and
these come in two kinds: eager launches, at most as many as the host
issues in the window's seconds, and graph launches, each thousands of
kernels however short the window (a UNet step's graph is about 2,800;
a denoise enqueues its 50 steps in a few ms, and one 0.1 s window
holding them stopped in 1.1-1.4 s on an H100). So a window is bounded
twice: in seconds (:data:`WINDOW_BOUNDS_S`) and in graph launches
(:data:`LAUNCH_BOUNDS`, enforced by ``ops/graphs.py::launch_gate``: a
launch past the window's limit waits for its stop). Each window is
sized from the dearest rates seen so far, stop and write a second
traced and a graph launch, to keep its stop and write within
:data:`STOP_BUDGET_S`: a capture over busy serving freezes the worker
for a bounded time per window, never for the whole capture. After each
window the capture rests, untraced, as long as that window's stop and
write took, so the serving threads hold the interpreter at least half
the capture's wall time (without the rest, back-to-back windows held it
about 70% of a 12.7 s capture on an H100, and a probe's guess waited
5.5 s). The profiler
records the capturing thread's host ops and every thread's CUDA runtime
calls and kernels; the serving threads' ranges (:func:`annotate`) are
kept by the capture itself in one more Chrome trace file in the
directory (``host_ranges_*.json``, timestamps in us since the epoch):
torch's experimental all-threads recording crashed the worker (a fatal
signal in the stop) in one of seven whole runs on an H100.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional

import torch

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("profiling")


#: the seconds one window's stop plus its write should take (the freeze a
#: window causes; the canary's probe timeout is 5 s)
STOP_BUDGET_S = 0.5
#: the first window (no rate measured yet) and the bounds of the others:
#: at the dearest rate measured on an H100 without graph launches in the
#: window (7 s of stop a second traced, 12.6 with the write) a 0.1 s
#: window stops in 0.7 s
FIRST_WINDOW_S = 0.02
WINDOW_BOUNDS_S = (0.01, 0.1)
#: the graph launches a window admits: the first window (no launch's
#: cost measured yet) and every window until one is, the lower bound;
#: the others as many as the budget buys at the dearest cost a launch
#: seen so far, within the bounds
LAUNCH_BOUNDS = (1, 32)

# the ranges :func:`annotate` closes while a :func:`capture` runs (None
# otherwise), as Chrome trace events
_capture_ranges: Optional[List[dict]] = None


@contextlib.contextmanager
def trace(log_dir: Optional[str], timings: Optional[dict] = None,
          launches: Optional[int] = None) -> Iterator[Optional[str]]:
    """Capture host and CUDA activity with torch's profiler into a Chrome
    trace in ``log_dir``; yields the trace file's path, written at exit.
    A no-op yielding None without a directory.

    Started and stopped on the calling thread (the profiler is
    process-global). Only the switch of the tracing, on and off, holds
    off CUDA graph launches (``ops/graphs.py::no_graph_running``): the
    trace's writing by the profiler's own C++ (no Python object per
    event) leaves graph launches free. With ``launches``, the trace
    admits that many graph launches of other threads
    (``ops/graphs.py::launch_gate``); a launch past them waits for the
    stop. ``timings``, when given, receives the seconds the start
    (``start_s``) and the stop (``stop_s``, the events' collection) held
    the graph lock, the seconds they waited for it (``lock_wait_s``,
    behind another thread's graph capture or launch: graph launches are
    not held by the trace then, and the interpreter is free), and the
    seconds of the write (``write_s``); with ``launches`` also the
    launches admitted (``launches``) and the seconds the first launch
    past them waited (``launch_wait_s``)."""
    if not log_dir:
        yield None
        return
    from torch.autograd import _disable_profiler
    from torch.autograd import profiler as autograd_profiler

    from cassmantle_tpu_torch.obs.costmodel import import_dynamo
    from cassmantle_tpu_torch.ops.graphs import launch_gate, no_graph_running

    import_dynamo()           # not at once with a cost count's thread
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    cuda = torch.cuda.is_available()
    prof = autograd_profiler.profile(use_device="cuda" if cuda else None,
                                     use_kineto=True)
    t0 = time.perf_counter()
    with no_graph_running():
        t1 = time.perf_counter()
        prof._prepare_trace()
        prof._start_trace()
        if launches is not None:
            launch_gate.open(launches)
        start_s = time.perf_counter() - t1
    try:
        yield path
    finally:
        # no device synchronize: another thread may be capturing a CUDA
        # graph, which a device-wide synchronize invalidates; device work
        # still in flight at the stop is left to the next window
        t2 = time.perf_counter()
        with no_graph_running():
            t3 = time.perf_counter()
            try:
                result = _disable_profiler()
            finally:
                if launches is not None:
                    admitted, waited = launch_gate.close()
            t4 = time.perf_counter()
        stopped = getattr(autograd_profiler, "_run_on_profiler_stop", None)
        if stopped is not None:
            stopped()
        result.save(path)
        if timings is not None:
            timings.update(start_s=start_s, stop_s=t4 - t3,
                           write_s=time.perf_counter() - t4,
                           lock_wait_s=(t1 - t0) + (t3 - t2))
            if launches is not None:
                timings.update(launches=admitted, launch_wait_s=waited)
    log.info("profiler trace written to %s", path)


def next_window_s(rate: float, budget_s: float = STOP_BUDGET_S) -> float:
    """The next window's seconds: those whose stop and write would take
    ``budget_s`` at ``rate`` (seconds of stop and write a second traced,
    the dearest seen so far), within :data:`WINDOW_BOUNDS_S`."""
    lo, hi = WINDOW_BOUNDS_S
    if rate <= 0:
        return hi
    return min(hi, max(lo, budget_s / rate))


def next_launches(cost_s: float, budget_s: float = STOP_BUDGET_S) -> int:
    """The graph launches the next window admits: as many as
    ``budget_s`` buys at ``cost_s`` (seconds of stop and write a launch,
    the dearest seen so far), within :data:`LAUNCH_BOUNDS`; the lower
    bound until a launch's cost is measured."""
    lo, hi = LAUNCH_BOUNDS
    if cost_s <= 0:
        return lo
    return min(hi, max(lo, int(budget_s / cost_s)))


def capture(log_dir: str, seconds: float,
            budget_s: float = STOP_BUDGET_S) -> dict:
    """Record ``seconds`` of wall time of host and CUDA activity into
    ``log_dir`` as consecutive windows (one :func:`trace` file each, at
    least one), each sized by :func:`next_window_s` and
    :func:`next_launches` from the dearest rates of the windows before
    it, with an untraced rest after each as long as its stop and write.
    The seconds count from the first window's start (the profiler's
    first start in a process sets it up for seconds); no window starts
    after them, nor when what is left of them is no longer than the
    rest. Then every thread's :func:`annotate` ranges of the capture in
    ``host_ranges_*.json``. Returns the windows:
    ``paths``, ``window_s``, ``start_s``, ``stop_s``, ``write_s``,
    ``lock_wait_s``, ``launches`` (each one's limit), ``launched`` (the
    launches each admitted), ``launch_wait_s``, and ``ranges_path``."""
    global _capture_ranges
    out = {"paths": [], "window_s": [], "start_s": [], "stop_s": [],
           "write_s": [], "lock_wait_s": [], "launches": [],
           "launched": [], "launch_wait_s": []}
    _capture_ranges = ranges = []
    try:
        _capture_windows(log_dir, seconds, budget_s, out)
    finally:
        _capture_ranges = None
    out["ranges_path"] = os.path.join(
        log_dir, f"host_ranges_{time.time_ns()}.json")
    with open(out["ranges_path"], "w") as f:
        json.dump({"traceEvents": ranges}, f)
    return out


def _capture_windows(log_dir: str, seconds: float, budget_s: float,
                     out: dict) -> None:
    end = None                   # from the first window's start
    rate, cost = 0.0, 0.0
    window, launches = FIRST_WINDOW_S, LAUNCH_BOUNDS[0]
    while True:
        timings: dict = {}
        with trace(log_dir, timings, launches=launches) as path:
            t0 = time.perf_counter()
            end = t0 + seconds if end is None else end
            span = max(0.0, min(window, end - t0))
            time.sleep(span)
        out["paths"].append(path)
        out["window_s"].append(span)
        out["launches"].append(launches)
        out["launched"].append(timings["launches"])
        for key in ("start_s", "stop_s", "write_s", "lock_wait_s",
                    "launch_wait_s"):
            out[key].append(timings[key])
        metrics.inc("obs.profiler_windows")
        spent = timings["stop_s"] + timings["write_s"]
        rate = max(rate, spent / max(span, WINDOW_BOUNDS_S[0]))
        if timings["launches"]:
            cost = max(cost, spent / timings["launches"])
        window = next_window_s(rate, budget_s)
        launches = next_launches(cost, budget_s)
        if end - time.perf_counter() <= spent:
            return
        time.sleep(spent)            # the serving threads' turn


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a range in the profiler's trace (on a thread the profiler
    records), and in a running :func:`capture`'s host ranges (any
    thread)."""
    with torch.profiler.record_function(name):
        sink = _capture_ranges
        if sink is None:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            sink.append({"name": name, "cat": "user_annotation", "ph": "X",
                         "ts": start / 1e3, "dur": (end - start) / 1e3,
                         "pid": os.getpid(), "tid": threading.get_ident()})


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
                pipeline: Optional[str] = None,
                cards: int = 1) -> Iterator[None]:
    """Time a stage into histogram ``name`` and a stage span, up to the
    block's end (its result on the host). ``cards``: the distinct cards
    the dispatch ran on."""
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
                share = utilization(products, elapsed, cards)
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
