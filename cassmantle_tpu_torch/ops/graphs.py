"""One step function captured into a CUDA graph and replayed.

The reference compiles its hot loops whole: ``jax.jit`` over the
sampler's ``lax.scan`` (``cassmantle_tpu/serving/pipeline.py``
``dp_sharded_sampler``) and over the greedy decode's. The port's
counterpart captures ONE step of such a loop (a CFG DDIM step, a GPT-2
decode step) into a ``torch.cuda.CUDAGraph`` over static buffers and
replays it once per step: the host issues one graph launch a step
instead of thousands of eager ones. The step itself keeps its loop
state on the device (a step counter in a device tensor, advanced inside
the graph), so nothing is copied between host and device between
replays.

:class:`CapturedStep` does the capture:

- a warm-up run of the step on a side stream, so every kernel library is
  built (``ops/_build.py``), every launch plan computed and every
  cuBLAS/cuDNN handle made before capture;
- the capture, over the buffers the step reads and writes (the caller
  owns them; they must stay put);
- :meth:`CapturedStep.replay`.

Captures run while other threads use the card (the serving seam scores
guesses on its dispatch thread while a round's first call captures its
denoise graph in an executor thread). So a capture is made in
``capture_error_mode="thread_local"`` on a side stream its thread owns:
another thread's synchronizing or allocating CUDA calls neither fail
nor invalidate it. And nothing here synchronizes the whole device or
empties the allocator's cache (``torch.cuda.graph`` does both on entry,
so its context manager is not used): the warm-up waits on its thread's
own stream (:func:`thread_stream`), and ``pool_bytes`` is read from the graph's own private pool.
Device-wide ``torch.cuda.synchronize`` would wait on a capturing stream
of another thread and break that capture; the port's serving paths wait
on their own stream (``utils/device.py::synchronize``).

:func:`no_new_captures` is the capture sentinel, the counterpart of the
reference's ``utils/jit_sentinel.no_new_compiles``: a block during which
its own thread captures a :class:`CapturedStep` raises
:class:`NewCaptureError` (the device-loss recovery warms under it: a
rebuild reloads parameters in place, so every graph stays valid). It
counts its thread's captures only: a cold round capturing its first
graph in an executor thread meanwhile is not the block's work.

Launch tallies: the kernel wrappers count their launches in Python when
they launch. A replay runs no Python, so the capture's tally (what the
step's wrappers counted while it was captured) is kept and added on
every replay, and what the warm-up and the capture counted is taken off
again: the counters still mean "launches that ran". A capture that
raises propagates its error; nothing falls back to eager.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from cassmantle_tpu_torch.ops.flash_attention import flash_attention
from cassmantle_tpu_torch.ops.fused_conv import gn_silu_conv3x3
from cassmantle_tpu_torch.ops.quant_matmul import int8_conv3x3, int8_matmul
from cassmantle_tpu_torch.utils.logging import metrics

# Every launch counter of the kernel wrappers: (wrapper, attribute).
COUNTERS = (
    (flash_attention, ("launches", "shapes", "paths", "shape_paths")),
    (gn_silu_conv3x3, ("launches", "shapes")),
    (int8_matmul, ("launches", "shapes")),
    (int8_conv3x3, ("launches", "shapes")),
)

Tally = Dict[Tuple[Callable, str], object]

# captures made in this process (every CapturedStep, any thread); each
# thread's own count is ``_local.captures``
_captures = 0
_captures_lock = threading.Lock()
_local = threading.local()


def thread_stream() -> "torch.cuda.Stream":
    """This thread's own side stream on the current device for warm-ups
    and captures, made on its first use there. Pool streams are handed
    out round-robin (32 a device), so one per thread keeps the capturing
    threads (fewer than 32) on streams no other thread enqueues to. A
    thread driving several cards (a meshed dispatch) has one on each."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    dev = torch.cuda.current_device()
    stream = streams.get(dev)
    if stream is None:
        stream = streams[dev] = torch.cuda.Stream(dev)
    return stream


# held by a thread while it captures or launches a graph, and around a
# switch of the device's activity tracing (``utils/profiling.py::trace``):
# switching it while another thread was inside a graph launch deadlocked
# both (seen on the card: a replay's cudaGraphLaunch and the switch, each
# waiting)
_graph_lock = threading.RLock()


@contextlib.contextmanager
def no_graph_running():
    """Hold off every thread's CUDA graph capture and launch for the
    block; the seconds held go to the ``graphs.held_off_s`` histogram."""
    with _graph_lock:
        start = time.perf_counter()
        try:
            yield
        finally:
            metrics.observe("graphs.held_off_s",
                            time.perf_counter() - start)


class LaunchGate:
    """Bounds the graph launches inside one trace window
    (``utils/profiling.py::trace``). A window's stop costs about as much
    per kernel event as it recorded, and one launch of a UNet step's
    graph puts thousands of kernels into a window however short it is
    (a denoise enqueues its 50 steps in a few ms). While a window is
    open, its first ``limit`` launches pass and count; a launch past
    them waits until the window closes (its stop holds every launch
    anyway), then runs untraced or in the next window. The capturing
    thread itself never waits. Closed, the gate costs a launch one
    attribute read."""

    def __init__(self):
        self._cond = threading.Condition()
        self._open = False
        self._window = 0
        self._owner: Optional[int] = None
        self._first_wait: Optional[float] = None
        self.limit = 0
        self.admitted = 0

    def open(self, limit: int) -> None:
        """Open a window for the calling thread, admitting ``limit``
        launches."""
        with self._cond:
            self._open, self.limit, self.admitted = True, limit, 0
            self._window += 1
            self._owner = threading.get_ident()
            self._first_wait = None

    def close(self) -> Tuple[int, float]:
        """Close the window and wake the launches waiting on it: returns
        the launches it admitted and the seconds its first waiting launch
        was held (0.0 if none waited)."""
        with self._cond:
            self._open = False
            held = (0.0 if self._first_wait is None
                    else time.perf_counter() - self._first_wait)
            self._cond.notify_all()
            return self.admitted, held

    def admit(self) -> None:
        """Called before every graph launch: returns at once unless a
        window of another thread is open and full."""
        if not self._open or threading.get_ident() == self._owner:
            return
        with self._cond:
            while self._open and self.admitted >= self.limit:
                if self._first_wait is None:
                    self._first_wait = time.perf_counter()
                window = self._window
                self._cond.wait_for(lambda: not self._open
                                    or self._window != window)
            if self._open:
                self.admitted += 1


#: the one gate every :meth:`CapturedStep.replay` passes
launch_gate = LaunchGate()


class NewCaptureError(RuntimeError):
    """A CUDA graph was captured inside a :func:`no_new_captures` block."""


def _note_capture() -> None:
    global _captures
    with _captures_lock:
        _captures += 1
    _local.captures = _thread_captures() + 1


def _thread_captures() -> int:
    return getattr(_local, "captures", 0)


def capture_count() -> int:
    """Captures made in this process so far (every thread)."""
    with _captures_lock:
        return _captures


@contextlib.contextmanager
def no_new_captures():
    """Raise :class:`NewCaptureError` at the end of the block when the
    calling thread captured a :class:`CapturedStep` inside it: the steady
    state after warm-up captures nothing. Other threads' captures do not
    count."""
    before = _thread_captures()
    yield
    new = _thread_captures() - before
    if new:
        raise NewCaptureError(
            f"{new} CUDA graph capture(s) inside a no_new_captures block: "
            f"a path that should replay its graphs captured new ones")


def snapshot() -> Tally:
    """A copy of every launch counter as it stands."""
    return {(fn, attr): (collections.Counter(getattr(fn, attr))
                         if isinstance(getattr(fn, attr), collections.Counter)
                         else getattr(fn, attr))
            for fn, attrs in COUNTERS for attr in attrs}


def difference(after: Tally, before: Tally) -> Tally:
    """What the counters gained from ``before`` to ``after`` (Counters
    keep only their changed keys)."""
    out = {}
    for key, value in after.items():
        if isinstance(value, collections.Counter):
            out[key] = collections.Counter(
                {k: n - before[key].get(k, 0) for k, n in value.items()
                 if n != before[key].get(k, 0)})
        else:
            out[key] = value - before[key]
    return out


def add(tally: Tally, times: int = 1) -> None:
    """Add ``times`` x ``tally`` to the live counters (negative: take it
    off); a Counter key that reaches 0 is dropped, as if never counted."""
    for (fn, attr), delta in tally.items():
        if isinstance(delta, collections.Counter):
            counter = getattr(fn, attr)
            for k, n in delta.items():
                counter[k] += times * n
                if counter[k] == 0:
                    del counter[k]
        else:
            setattr(fn, attr, getattr(fn, attr) + times * delta)


def pool_bytes(pool) -> int:
    """Device bytes of the segments in the allocator's private pool
    ``pool`` (a graph's ``pool()``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class CapturedStep:
    """``fn`` (no arguments; reads and writes buffers that stay put)
    warmed up, captured into a CUDA graph and replayed by
    :meth:`replay`. ``output`` is what ``fn`` returned at capture: a
    replay rewrites those tensors in place. ``reset``, where given, runs
    between the warm-up and the capture (it puts back loop state that
    the warm-up advanced).

    Host seconds of the set-up are kept: ``warmup_s``, ``capture_s``
    (the step's Python under capture) and ``instantiate_s`` (ending the
    capture, which instantiates the graph); ``pool_bytes`` is the device
    memory of the graph's private pool."""

    def __init__(self, fn: Callable[[], object],
                 reset: Optional[Callable[[], object]] = None):
        self.fn = fn
        self.replays = 0
        start = snapshot()
        try:
            t0 = time.perf_counter()
            self._warm_up()
            self.warmup_s = time.perf_counter() - t0
            if reset is not None:
                reset()
            warm = snapshot()
            self._capture()
            self.tally = difference(snapshot(), warm)
            _note_capture()
        finally:
            add(difference(snapshot(), start), -1)

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream()
        side = thread_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()
        current.wait_stream(side)
        side.synchronize()

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream()
        side = thread_stream()
        side.wait_stream(current)
        t0 = time.perf_counter()
        with _graph_lock, torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.output = self.fn()
                t1 = time.perf_counter()
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = pool_bytes(graph.pool())
        self.graph = graph

    def replay(self):
        """Launch the graph on the current stream (no sync) and count
        the kernels it launches; inside a trace window, after the
        window's :class:`LaunchGate` admits it."""
        launch_gate.admit()
        with _graph_lock:
            self.graph.replay()
        add(self.tally)
        self.replays += 1
        return self.output

    def stats(self) -> dict:
        """The set-up's seconds and the pool's bytes, for reports."""
        return {"warmup_s": self.warmup_s, "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s,
                "pool_bytes": self.pool_bytes}
