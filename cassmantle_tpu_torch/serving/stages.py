"""Stage-disaggregated image serving: step-level continuous batching.

Port of ``cassmantle_tpu/serving/stages.py``. The monolithic image path
(``serving/pipeline.py``) runs CLIP, the whole sampler loop and the VAE
as one dispatch under the pipeline's dispatch lock, so a request that
arrives one step after another's dispatch waits a whole image. Here the
path is three stages:

- **encode**: the pipeline's CLIP (SDXL: both towers and the
  micro-conditioning), a :class:`~cassmantle_tpu_torch.serving.queue.
  BatchingQueue` over the ``stage_encode_batch_sizes`` buckets with a
  dispatch thread of its own;
- **denoise**: one thread stepping a fixed-capacity slot tensor (the
  latents, the solver's aux state, each conditioning key, a step counter
  a slot). A request's rows are admitted into free slots at the next step
  boundary; each step gathers the live slots into the smallest width
  bucket >= occupancy (powers of two up to ``denoise_slots``, and the
  capacity), padded by repeating the first live slot, runs the CFG UNet
  at batch 2w and the solver step (``ops/samplers.py::
  make_slot_sampler``), and scatters the rows back; a finished slot
  retires to the decode stage at once, and an expired deadline frees its
  slot at the next boundary (``DeadlineExceeded``);
- **decode**: the VAE and the uint8 tail, again a BatchingQueue over
  ``stage_decode_batch_sizes`` with its own dispatch thread; a row whose
  latents are not finite, or whose frame is constant, fails its own
  request only.

A solo request computes the monolithic path's arithmetic: the same x_T
draw (one ``torch.Generator(seed)`` draw of the request's B rows), the
same CLIP batch, the solver spec's own ``x_for`` and ``update`` at each
slot's own step, the same 2B CFG batch and VAE batch.

On CUDA each width's step is one captured graph (``ops/graphs.py::
CapturedStep``), captured on the denoise thread's own stream at the
width's first use, over static buffers: the slot tensors, the counters
(C,) and the width's index vectors (2, w). Admission writes a slot's
rows and zeroes its counter by ``index_copy_``/``index_fill_`` at a
device index, so it never captures. The step loop never waits for the
device: no ``.item()``, no blocking copy, no synchronize. Host-to-device
writes (a width's slot list) come from pinned memory; the per-slot
finiteness verdict goes to pinned memory by an async copy and is read
once its event has completed; the loop keeps at most
``STEP_QUEUE_DEPTH`` steps queued by polling ``Event.query()``, which
also drives the wedge watchdog. Rows cross threads with an event: the
consumer's stream waits on it, and ``record_stream`` keeps the row's
memory from reuse while the consumer's stream still reads it. On the CPU
the same step runs eagerly.

Control state (which slot holds which request, at which step) lives on
the host, on the denoise thread. ``CASSMANTLE_NO_STAGED_SERVING=1``
routes every request through the monolithic path.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import contextvars
import os
import queue as _thread_queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from cassmantle_tpu_torch.chaos import fault_point
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import current_ctx, tracer
from cassmantle_tpu_torch.ops.ddim import initial_latents, make_slot_denoiser
from cassmantle_tpu_torch.ops.graphs import CapturedStep, thread_stream
from cassmantle_tpu_torch.ops.samplers import (
    consistency_disabled,
    make_slot_sampler,
)
from cassmantle_tpu_torch.serving import integrity
from cassmantle_tpu_torch.serving.integrity import (
    OutputInvalid,
    finite_verdict,
)
from cassmantle_tpu_torch.serving.queue import (
    BatchingQueue,
    DeadlineExceeded,
    DispatchTimeout,
    QueueStopped,
    _DispatchWorker,
)
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("stages")

#: sampler kinds the slot stepper replays (consistency rides it too, as
#: the pipeline's few-step mode, not as a kind)
STAGEABLE_KINDS = ("ddim", "euler", "dpmpp_2m")

#: steps the denoise loop keeps queued on the device ahead of the last
#: finished one: the device never idles between steps, and admissions,
#: deadlines and verdicts act at most this many steps behind it
STEP_QUEUE_DEPTH = 2

# the host's poll interval while the step queue is full
_POLL_S = 0.0005


def staged_serving_disabled() -> bool:
    """The kill switch: CASSMANTLE_NO_STAGED_SERVING=1 routes every
    generate through the monolithic dispatch."""
    return os.environ.get("CASSMANTLE_NO_STAGED_SERVING", "").lower() \
        not in ("", "0", "false", "no", "off")


class _Unit:
    """One latent row flowing encode -> denoise -> decode. ``done`` is set
    by the denoise thread to (the finished row, its event) or to the
    preemption error."""

    __slots__ = ("ids", "uncond_ids", "lat", "aux", "ready", "cond",
                 "cond_ready", "done", "deadline", "ctx", "slot",
                 "t_ready", "t_admit", "wall_ready")

    def __init__(self, ids, uncond_ids, lat, aux, ready, deadline,
                 ctx) -> None:
        self.ids = ids
        self.uncond_ids = uncond_ids
        self.lat = lat
        self.aux = aux
        self.ready = ready
        self.cond: Optional[dict] = None
        self.cond_ready = None
        self.done: concurrent.futures.Future = concurrent.futures.Future()
        self.deadline = deadline
        self.ctx = ctx
        self.slot: Optional[int] = None
        self.t_ready = 0.0
        self.t_admit = 0.0
        self.wall_ready = 0.0

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.01, self.deadline - time.monotonic())


class StagedImageServer:
    """The stage scheduler an image pipeline owns when
    ``ServingConfig.staged_serving`` is on. The pipeline gives its
    pieces:

    - ``encode_fn(ids, uncond_ids) -> dict`` of conditioning rows ``(B,
      ...)`` on ``device``: ``ctx``, ``uctx`` (SDXL adds ``add``,
      ``uadd``);
    - ``unet``: the CFG step's model (``ops/ddim.py::make_slot_denoiser``
      over it);
    - ``decode_fn(latents) -> (B, H, W, 3)`` uint8 on ``device``;
    - ``tokenize(prompts) -> (B, pad)`` host ids, the pipeline's own;
    - ``denoise_cost``: ``(kind, signature, counter)`` of the cost model
      (``obs/costmodel.py``) for one request's denoise work, or None for
      no FLOPs attribution.

    ``generate`` has the monolithic call's shape: prompts in, the stacked
    uint8 host batch out, blocking the caller until every row decodes.
    """

    def __init__(self, cfg, device: torch.device, *, encode_fn: Callable,
                 decode_fn: Callable, unet: Callable,
                 tokenize: Callable[[Sequence[str]], np.ndarray],
                 vae_scale: int, supervisor=None,
                 denoise_cost: Optional[tuple] = None) -> None:
        from cassmantle_tpu_torch.serving.pipeline import (
            effective_sampler_cfg,
        )

        self.cfg = cfg
        self.device = device
        self._cuda = device.type == "cuda"
        self._encode_fn = encode_fn
        self._decode_fn = decode_fn
        self._tokenize = tokenize
        self._vae_scale = vae_scale
        self._supervisor = supervisor
        s = cfg.sampler
        if (s.kind not in STAGEABLE_KINDS or s.deepcache or s.encprop
                or s.eta != 0.0):
            raise ValueError(
                "staged serving replays deterministic ddim/euler/dpmpp_2m "
                "(or consistency) without deepcache or encprop; the "
                f"pipeline should have served {s.kind!r} monolithic")
        self.capacity = int(cfg.serving.denoise_slots)
        if self.capacity < 1:
            raise ValueError("denoise_slots must be >= 1")
        # the step widths: powers of two below the capacity, and the
        # capacity; each has one step (one captured graph on CUDA)
        self._step_widths: List[int] = []
        w = 1
        while w < self.capacity:
            self._step_widths.append(w)
            w *= 2
        self._step_widths.append(self.capacity)
        eff = effective_sampler_cfg(s)
        #: the slot sampler's kind: the config's, or consistency
        self.slot_kind = ("consistency" if s.consistency
                          and not consistency_disabled() else s.kind)
        self.image_size = s.image_size
        hw = s.image_size // vae_scale
        self._sampler = make_slot_sampler(
            self.slot_kind, eff.num_steps,
            torch.zeros((1, hw, hw, 4), device=device), eta=s.eta,
            teacher_steps=s.consistency_teacher_steps)
        self.num_steps = self._sampler.num_steps
        self._denoise = make_slot_denoiser(unet, s.guidance_scale)
        self._negative = s.negative_prompt
        # scheduler lifecycle only, never held across device work
        self._lock = OrderedLock("stage.scheduler", rank=14)
        self._started = False
        self._stop_evt = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._denoise_thread: Optional[threading.Thread] = None
        self._denoise_stream = None
        self._encode_q: Optional[BatchingQueue] = None
        self._decode_q: Optional[BatchingQueue] = None
        self._enc_buckets = tuple(cfg.serving.stage_encode_batch_sizes)
        self._dec_buckets = tuple(cfg.serving.stage_decode_batch_sizes)
        # handed to the denoise thread: groups of units (one request's
        # rows, admitted at one boundary when slots allow), and calls to
        # run on it
        self._admit_q: _thread_queue.Queue = _thread_queue.Queue()
        self._calls: _thread_queue.Queue = _thread_queue.Queue()
        self._pend: deque = deque()
        self._inflight: set = set()
        # device state, made at the first admission: the slot tensors, the
        # per-slot counters and finiteness verdict, each slot's index and
        # each width's (2, w) index vectors: the slots a step gathers, and
        # for each row the first row holding the same slot (the one a
        # padded duplicate writes back)
        self._lat: Optional[torch.Tensor] = None
        self._aux: Optional[torch.Tensor] = None
        self._cond: Optional[Dict[str, torch.Tensor]] = None
        self._counter: Optional[torch.Tensor] = None
        self._finite: Optional[torch.Tensor] = None
        self._slot_index: Optional[torch.Tensor] = None
        self._width_idx: Dict[int, torch.Tensor] = {}
        # what each width's vector holds now (None: rewrite before use)
        self._width_slots: Dict[int, Optional[tuple]] = {}
        # each width's step: a graph's replay (CUDA) or the eager body
        self._step_fns: Dict[int, Callable[[], object]] = {}
        #: each width's captured graph (CUDA)
        self.graphs: Dict[int, CapturedStep] = {}
        #: steps built per width (captures on CUDA): one each, ever
        self.builds: collections.Counter = collections.Counter()
        #: steps run per width
        self.width_steps: collections.Counter = collections.Counter()
        # (event, host verdict, slot -> unit) per step, read once ready
        self._fin_probes: deque = deque()
        # (event, launch time) of the steps queued on the device
        self._queued: deque = deque()
        # host mirrors, written by the denoise thread only
        self._steps = np.zeros((self.capacity,), dtype=np.int64)
        self._alive = np.zeros((self.capacity,), dtype=bool)
        self._slots: List[Optional[_Unit]] = [None] * self.capacity
        self._free = list(range(self.capacity - 1, -1, -1))
        self._active_n = 0
        # single-writer counters; mean occupancy = slot_steps / (steps *
        # capacity)
        self.stats = {"steps": 0, "slot_steps": 0, "admissions": 0,
                      "retirements": 0, "preemptions": 0,
                      "quarantines": 0}
        self._on_step = None  # test seam: called once per loop iteration
        self._denoise_cost = denoise_cost

    # -- streams and events --------------------------------------------------

    def _stream(self):
        """This thread's own stream on CUDA (``thread_stream``), nothing
        on the CPU."""
        if self._cuda:
            return torch.cuda.stream(thread_stream())
        return contextlib.nullcontext()

    def _record(self):
        """An event after the work this thread queued so far (CUDA)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _consume(self, event, *tensors) -> None:
        """Make this thread's stream wait for ``event`` and keep each
        tensor's memory from reuse until this stream is done with it."""
        if not self._cuda:
            return
        stream = torch.cuda.current_stream()
        if event is not None:
            stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)

    @staticmethod
    def _ready(event) -> bool:
        return event is None or event.query()

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self) -> None:
        with self._lock:
            if self._started:
                return
            self._stop_evt.clear()
            self._loop = asyncio.new_event_loop()
            self._loop_thread = threading.Thread(
                target=self._loop.run_forever, daemon=True,
                name="cassmantle-stage-loop")
            self._loop_thread.start()
            self._denoise_thread = threading.Thread(
                target=self._denoise_loop, daemon=True,
                name="cassmantle-stage-denoise")
            self._denoise_thread.start()
            self._started = True
        if self._denoise_cost is not None:
            # counted on a thread of its own, never on the denoise thread:
            # retirements carry no attribution until it lands
            costmodel.count_later(*self._denoise_cost)

    def _ensure_queues(self) -> None:
        """Built on the stage loop (one thread there): each stage queue
        gets its own dispatch worker, so encode and decode batches never
        wait behind the process-global worker's scores and prompts."""
        if self._encode_q is not None:
            return
        serving = self.cfg.serving
        kw = dict(max_delay_ms=serving.stage_max_delay_ms,
                  max_pending=serving.max_pending,
                  hang_timeout_s=serving.dispatch_hang_s,
                  supervisor=self._supervisor,
                  degraded_max_pending=serving.degraded_max_pending)
        self._encode_q = BatchingQueue(
            handler=self._encode_batch, max_batch=max(self._enc_buckets),
            name="stage.encode",
            dispatcher=_DispatchWorker("stage.encode_dispatch", rank=21),
            **kw)
        self._decode_q = BatchingQueue(
            handler=self._decode_batch, max_batch=max(self._dec_buckets),
            name="stage.decode",
            dispatcher=_DispatchWorker("stage.decode_dispatch", rank=22),
            **kw)

    def stop(self) -> None:
        """Tear the stage graph down; pending and in-flight requests fail
        with :class:`QueueStopped`. Units fail and the stage queues stop
        while the stage loop still runs (their callers resume there); the
        loop stops once every request future has completed. The slot
        tensors and graphs stay: a later generate restarts the threads
        over them."""
        with self._lock:
            started = self._started
            self._started = False
        if not started:
            return
        self._stop_evt.set()
        if self._denoise_thread is not None:
            self._denoise_thread.join(timeout=10.0)
        if self._denoise_stream is not None:
            # the next denoise thread steps on a stream of its own
            self._denoise_stream.synchronize()
        leftovers = list(self._pend)
        self._pend.clear()
        while True:
            try:
                leftovers.extend(self._admit_q.get_nowait())
            except _thread_queue.Empty:
                break
        for i, u in enumerate(self._slots):
            if u is not None:
                leftovers.append(u)
                self._slots[i] = None
        self._free = list(range(self.capacity - 1, -1, -1))
        self._alive[:] = False
        self._active_n = 0
        self._reset_device_queue()
        for u in leftovers:
            self._fail_unit(u, QueueStopped("stage.denoise"))
        self._fail_calls(QueueStopped("stage.denoise"))

        async def _shutdown():
            if self._encode_q is not None:
                await self._encode_q.stop()
            if self._decode_q is not None:
                await self._decode_q.stop()

        asyncio.run_coroutine_threadsafe(
            _shutdown(), self._loop).result(timeout=10.0)
        # a request whose encode finished before the queues stopped can
        # still race its admission past the drain above: keep draining
        # while its future unwinds
        deadline = time.monotonic() + 10.0
        for cf in list(self._inflight):
            while not cf.done() and time.monotonic() < deadline:
                try:
                    for u in self._admit_q.get_nowait():
                        self._fail_unit(u, QueueStopped("stage.denoise"))
                except _thread_queue.Empty:
                    time.sleep(0.005)
            if not cf.done():
                log.error("stage request future did not unwind in 10s")
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        if not self._loop.is_running():
            self._loop.close()
        self._encode_q = None
        self._decode_q = None

    # -- request entry -------------------------------------------------------

    def generate(self, prompts: Sequence[str], seed: int = 0,
                 deadline_s: Optional[float] = None,
                 latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """prompts -> (B, H, W, 3) uint8 host array through the stage
        graph, blocking the caller. x_T is the monolithic path's: one
        ``torch.Generator(seed)`` draw of B rows on the device, or
        ``latents`` (B, h, w, 4) as given. ``deadline_s`` is honored at
        step granularity in the denoise stage."""
        self._ensure_started()
        prompts = list(prompts)
        n = len(prompts)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        ids = self._tokenize(prompts)
        uncond = self._tokenize([self._negative] * n)
        with torch.inference_mode():
            if latents is None:
                gen = torch.Generator(self.device).manual_seed(int(seed))
                latents = initial_latents(gen, n, self.image_size,
                                          self._vae_scale,
                                          device=self.device)
            lat, aux = self._sampler.prepare(
                latents.to(self.device, torch.float32))
            ready = self._record()
        ctx = current_ctx()
        units = [_Unit(ids[i:i + 1], uncond[i:i + 1], lat[i:i + 1],
                       aux[i:i + 1], ready, deadline, ctx)
                 for i in range(n)]
        cf: concurrent.futures.Future = concurrent.futures.Future()
        context = contextvars.copy_context()

        def start() -> None:
            # the request runs in the caller's context (its trace)
            task = self._loop.create_task(self._request(units),
                                          context=context)

            def settle(t: asyncio.Task) -> None:
                if t.cancelled():
                    cf.cancel()
                elif t.exception() is not None:
                    cf.set_exception(t.exception())
                else:
                    cf.set_result(t.result())

            task.add_done_callback(settle)

        self._inflight.add(cf)
        cf.add_done_callback(self._inflight.discard)
        self._loop.call_soon_threadsafe(start)
        return cf.result()

    async def _request(self, units: List[_Unit]) -> np.ndarray:
        self._ensure_queues()
        sup = self._supervisor
        encoded = await asyncio.gather(*(
            self._encode_q.submit((u.ids, u.uncond_ids),
                                  deadline_s=u.remaining())
            for u in units))
        if sup is not None:
            sup.note_stage_progress("encode")
        if self._stop_evt.is_set():
            # the denoise thread is (being) torn down; stop() drains the
            # window between this check and the put
            raise QueueStopped("stage.denoise")
        now, wall = time.monotonic(), time.time()
        for u, (cond, ready) in zip(units, encoded):
            u.cond, u.cond_ready = cond, ready
            u.t_ready, u.wall_ready = now, wall
        # one group: a request's rows are admitted at one boundary when
        # there are slots for them all
        self._admit_q.put(units)
        images = await asyncio.gather(*(self._finish(u) for u in units))
        return np.concatenate(images, axis=0)

    async def _finish(self, u: _Unit) -> np.ndarray:
        row = await asyncio.wrap_future(u.done)
        img = await self._decode_q.submit(row, deadline_s=u.remaining())
        if self._supervisor is not None:
            self._supervisor.note_stage_progress("decode")
        return img

    # -- encode / decode handlers (their dispatch threads) -------------------

    def _encode_batch(self, items):
        n = len(items)
        bucket = next((b for b in self._enc_buckets if n <= b), n)
        pad_len = items[0][0].shape[1]
        ids = np.zeros((bucket, pad_len), dtype=np.int64)
        uncond = np.zeros((bucket, pad_len), dtype=np.int64)
        for i, (row, urow) in enumerate(items):
            ids[i] = row[0]
            uncond[i] = urow[0]
        with torch.inference_mode(), self._stream():
            cond = self._encode_fn(torch.from_numpy(ids).to(self.device),
                                   torch.from_numpy(uncond).to(self.device))
            ready = self._record()
        # per-item row views; they ride to the admission as device rows
        return [({k: v[i:i + 1] for k, v in cond.items()}, ready)
                for i in range(n)]

    def _decode_batch(self, rows):
        n = len(rows)
        bucket = next((b for b in self._dec_buckets if n <= b), n)
        with torch.inference_mode(), self._stream():
            lats = []
            for row, ready in rows:
                self._consume(ready, row)
                lats.append(row)
            lats += [torch.zeros_like(lats[0])] * (bucket - n)
            lat = torch.cat(lats, dim=0)
            # the retirement verdict on the latents, then the decode; the
            # one blocking copy of the stage graph is here, on this thread
            verdict = finite_verdict(lat)
            images = self._decode_fn(lat).cpu().numpy()
            verdict = verdict.cpu().numpy()
        bad = set(integrity.invalid_members(verdict, images=images,
                                            n=n).tolist())
        if bad:
            # one bad row fails its own request; its neighbours decode
            integrity.note_invalid("staged", "decode", sorted(bad))
        return [OutputInvalid("staged", "decode", [i]) if i in bad
                else images[i:i + 1] for i in range(n)]

    # -- the denoise thread --------------------------------------------------

    def run_on_denoise_thread(self, fn: Callable[[], object],
                              timeout: Optional[float] = 120.0):
        """Run ``fn()`` on the denoise thread between two ticks (the slot
        tensors are its alone) and return its result; checks and
        measurements use it."""
        self._ensure_started()
        cf: concurrent.futures.Future = concurrent.futures.Future()
        self._calls.put((fn, cf))
        return cf.result(timeout=timeout)

    def _run_calls(self) -> None:
        while True:
            try:
                fn, cf = self._calls.get_nowait()
            except _thread_queue.Empty:
                return
            try:
                cf.set_result(fn())
            except Exception as exc:  # noqa: BLE001 — carried to the caller
                cf.set_exception(exc)

    def _fail_calls(self, exc: Exception) -> None:
        while True:
            try:
                _, cf = self._calls.get_nowait()
            except _thread_queue.Empty:
                return
            cf.set_exception(exc)

    def _drain_admissions(self, block: bool) -> None:
        try:
            if block:
                self._pend.extend(self._admit_q.get(timeout=0.05))
            while True:
                self._pend.extend(self._admit_q.get_nowait())
        except _thread_queue.Empty:
            pass

    def _denoise_loop(self) -> None:
        """The step-level continuous-batching loop, on this thread's own
        stream; it queues device work and never waits for it."""
        if self._cuda:
            self._denoise_stream = thread_stream()
        with torch.inference_mode(), self._stream():
            while not self._stop_evt.is_set():
                try:
                    self._denoise_tick()
                except Exception as exc:  # noqa: BLE001 — contained below
                    # a failed step fails its callers, not this thread
                    log.exception("stage.denoise loop error")
                    metrics.inc("stage.denoise.loop_errors")
                    self._fail_inflight(exc)

    def _fail_inflight(self, exc: Exception) -> None:
        """Fail every admitted and pending unit after a loop error and
        reset the host state; the slot tensors and graphs stay (admission
        rewrites a slot's rows)."""
        for slot, u in enumerate(self._slots):
            if u is not None:
                self._fail_unit(u, exc)
                self._free_slot(slot)
        while self._pend:
            self._fail_unit(self._pend.popleft(), exc)
        self._reset_device_queue()

    def _reset_device_queue(self) -> None:
        self._fin_probes.clear()
        self._queued.clear()
        self._width_slots = {w: None for w in self._width_slots}

    def _denoise_tick(self) -> None:
        self._run_calls()
        # the test seam runs before admission, so a hook that holds this
        # boundary until a submission lands sees it admitted here
        hook = self._on_step
        if hook is not None:
            hook(self)
        fault_point("stage.denoise.tick")
        idle = self._active_n == 0 and not self._pend
        self._drain_admissions(block=idle)
        now = time.monotonic()
        self._admit_pending(now)
        self._preempt_expired(now)
        if self._active_n == 0:
            return
        width = next(w for w in self._step_widths if w >= self._active_n)
        live = np.flatnonzero(self._alive)
        slots = np.full((width,), live[0], dtype=np.int64)
        slots[: len(live)] = live
        if not self._wait_step_queue():
            return
        self._set_width_slots(width, slots)
        self._step_fn(width)()
        self._queue_verdict()
        self.width_steps[width] += 1
        self._note_step()
        self._check_quarantine()
        self._retire_finished()
        self._watchdog_check()

    def _ensure_state(self, u: _Unit) -> None:
        if self._lat is not None:
            return
        c, dev = self.capacity, self.device

        def zeros(row):
            return torch.zeros((c,) + tuple(row.shape[1:]), dtype=row.dtype,
                               device=dev)

        self._lat = zeros(u.lat)
        self._aux = zeros(u.aux)
        self._cond = {k: zeros(v) for k, v in u.cond.items()}
        self._counter = torch.zeros((c,), dtype=torch.long, device=dev)
        self._finite = torch.ones((c,), dtype=torch.bool, device=dev)
        self._slot_index = torch.arange(c, device=dev)
        self._width_idx = {w: torch.zeros((2, w), dtype=torch.long,
                                          device=dev)
                           for w in self._step_widths}
        self._width_slots = {w: None for w in self._step_widths}

    def _admit_pending(self, now: float) -> None:
        while self._pend and self._free:
            u = self._pend.popleft()
            if u.deadline is not None and now >= u.deadline:
                self._preempt(u, "expired_before_admission")
                continue
            slot = self._free.pop()
            self._ensure_state(u)
            self._consume(u.ready, u.lat, u.aux)
            self._consume(u.cond_ready, *u.cond.values())
            # device.poison drill lever: corrupts THIS request's row at
            # admission; detection is the per-step verdict's job
            lat_row = integrity.poison(u.lat, peer="stage")
            idx = self._slot_index[slot:slot + 1]
            self._lat.index_copy_(0, idx, lat_row)
            self._aux.index_copy_(0, idx, u.aux)
            for k, buf in self._cond.items():
                buf.index_copy_(0, idx, u.cond[k])
            self._counter.index_fill_(0, idx, 0)
            # the slot tensors own copies now
            u.cond = u.lat = u.aux = None
            self._steps[slot] = 0
            self._alive[slot] = True
            self._slots[slot] = u
            self._active_n += 1
            u.slot = slot
            u.t_admit = now
            self.stats["admissions"] += 1
            metrics.inc("stage.denoise.admissions")
            metrics.observe("stage.denoise.queue_wait_s", now - u.t_ready)
            flight_recorder.record(
                "stage.admit", stage="denoise", slot=slot,
                step=self.stats["steps"], occupancy=self._active_n)

    def _preempt(self, u: _Unit, reason: str) -> None:
        self.stats["preemptions"] += 1
        metrics.inc("stage.denoise.preemptions")
        flight_recorder.record(
            "stage.preempt", stage="denoise", reason=reason, slot=u.slot,
            step=self.stats["steps"],
            steps_done=int(self._steps[u.slot]) if u.slot is not None
            else 0)
        self._fail_unit(u, DeadlineExceeded("stage.denoise"))

    def _preempt_expired(self, now: float) -> None:
        """Deadlines at step granularity: an expired request frees its
        slot at this boundary; a freed slot leaves the gathered step."""
        for slot, u in enumerate(self._slots):
            if u is None or u.deadline is None or now < u.deadline:
                continue
            self._preempt(u, "deadline")
            self._free_slot(slot)

    def _free_slot(self, slot: int) -> None:
        self._slots[slot] = None
        self._alive[slot] = False
        self._steps[slot] = 0
        self._free.append(slot)
        self._active_n -= 1

    def _note_step(self) -> None:
        self.stats["steps"] += 1
        self.stats["slot_steps"] += self._active_n
        for slot, u in enumerate(self._slots):
            if u is not None:
                self._steps[slot] += 1
        metrics.inc("stage.denoise.steps")
        metrics.gauge("stage.denoise.slot_occupancy",
                      self._active_n / self.capacity)

    # -- the step ------------------------------------------------------------

    def _set_width_slots(self, width: int, slots: np.ndarray) -> None:
        """Write a width's index vectors where its slots changed (at
        admissions and retirements, not per tick): from pinned memory,
        asynchronously, on this stream ahead of the step."""
        key = tuple(int(s) for s in slots)
        if self._width_slots.get(width) == key:
            return
        first: Dict[int, int] = {}
        rows = [first.setdefault(slot, j) for j, slot in enumerate(key)]
        src = torch.from_numpy(np.stack([np.asarray(key, dtype=np.int64),
                                         np.asarray(rows, dtype=np.int64)]))
        if self._cuda:
            # the pinned block is not reused before its copy lands (the
            # host allocator records the copy's event)
            src = src.pin_memory()
        self._width_idx[width].copy_(src, non_blocking=self._cuda)
        self._width_slots[width] = key

    def _step_body(self, vectors: torch.Tensor) -> torch.Tensor:
        """One denoise step of the slots ``vectors[0]`` (w,): gather, the
        CFG UNet at batch 2w and the solver step at each slot's own
        counter, scatter back, counters + 1, and the per-slot finiteness
        verdict. A padded duplicate's row is not bit-equal to its first
        row on the card (a GEMM's rows can round apart by position), so
        each row scatters its first row's result (``vectors[1]``): the
        duplicate writes are idempotent and the step deterministic."""
        idx, first = vectors[0], vectors[1]
        lat_g = self._lat.index_select(0, idx)
        aux_g = (self._aux.index_select(0, idx) if self._sampler.has_aux
                 else None)
        cond_g = {k: v.index_select(0, idx) for k, v in self._cond.items()}
        steps = self._counter.index_select(0, idx)

        def denoise(x, t):
            return self._denoise(x, t, cond_g["ctx"], cond_g["uctx"],
                                 cond_g.get("add"), cond_g.get("uadd"))

        new_lat, new_aux = self._sampler.step(denoise, lat_g, aux_g, steps)
        self._lat.index_copy_(0, idx, new_lat.index_select(0, first).to(
            self._lat.dtype))
        if self._sampler.has_aux:
            self._aux.index_copy_(0, idx, new_aux.index_select(0, first).to(
                self._aux.dtype))
        self._counter.index_copy_(0, idx, steps + 1)
        self._finite.copy_(finite_verdict(self._lat))
        return self._lat

    def _step_fn(self, width: int) -> Callable[[], object]:
        """The width's step: on CUDA a graph's replay, captured here at
        the width's first use (the warm-up's step undone before the
        capture), else the eager body."""
        fn = self._step_fns.get(width)
        if fn is not None:
            return fn
        body = lambda: self._step_body(self._width_idx[width])  # noqa: E731
        if self._cuda:
            state = (self._lat, self._aux, self._counter, self._finite)
            saved = [t.clone() for t in state]

            def restore() -> None:
                for t, s in zip(state, saved):
                    t.copy_(s)

            graph = CapturedStep(body, reset=restore)
            del saved
            self.graphs[width] = graph
            fn = graph.replay
        else:
            fn = body
        self.builds[width] += 1
        self._step_fns[width] = fn
        return fn

    def _queue_verdict(self) -> None:
        """After a step: its event, and the slots' verdict copied to the
        host (pinned, async), read once the event has completed."""
        if self._cuda:
            host = torch.empty((self.capacity,), dtype=torch.bool,
                               pin_memory=True)
            host.copy_(self._finite, non_blocking=True)
        else:
            host = self._finite.clone()
        ev = self._record()
        self._queued.append((ev, time.monotonic()))
        self._fin_probes.append((ev, host, tuple(self._slots)))

    def _wait_step_queue(self) -> bool:
        """Wait, polling events and never blocking on the device, until
        fewer than ``STEP_QUEUE_DEPTH`` steps are queued. False when the
        loop is stopping or the watchdog failed the slots meanwhile."""
        queued = self._queued
        while queued:
            if self._ready(queued[0][0]):
                queued.popleft()
                if self._supervisor is not None:
                    self._supervisor.note_stage_progress("denoise")
                continue
            if len(queued) < STEP_QUEUE_DEPTH:
                return True
            if self._stop_evt.is_set() or self._watchdog_check():
                return False
            time.sleep(_POLL_S)
        return True

    # -- slot quarantine -----------------------------------------------------

    def _check_quarantine(self) -> None:
        """Quarantine slots whose latents went non-finite, from the
        verdicts whose events completed (no wait): detection lags the
        device by at most the queued steps, and a poisoned slot stays
        non-finite until scrubbed. A row that retires first is caught by
        the decode stage's verdict. Under CASSMANTLE_NO_INTEGRITY_CHECKS
        ready verdicts drain unjudged."""
        probes = self._fin_probes
        disabled = integrity.integrity_disabled()
        while probes and self._ready(probes[0][0]):
            _, host, units = probes.popleft()
            verdict = host.numpy()
            for slot, u in enumerate(units):
                if disabled or u is None or verdict[slot]:
                    continue
                if self._slots[slot] is not u:
                    continue      # retired or preempted already
                self._quarantine(slot, u)
        while len(probes) > 32:
            probes.popleft()

    def _quarantine(self, slot: int, u: _Unit) -> None:
        """Fail a poisoned slot's request with OutputInvalid, scrub its
        rows to zeros and free it; each quarantine is a content-breaker
        failure, so a sick device reads as sick."""
        steps_done = int(self._steps[slot])
        self.stats["quarantines"] += 1
        metrics.inc("stage.denoise.quarantines")
        integrity.note_invalid("staged", "denoise", [slot])
        flight_recorder.record(
            "stage.quarantine", stage="denoise", slot=slot,
            step=self.stats["steps"], steps_done=steps_done)
        log.error("stage.denoise slot %d latents non-finite after %d "
                  "steps: quarantined", slot, steps_done)
        idx = self._slot_index[slot:slot + 1]
        for buf in (self._lat, self._aux, *self._cond.values()):
            buf.index_fill_(0, idx, 0)
        # counted before the request fails: its caller may read the
        # breaker as soon as it wakes
        if self._supervisor is not None:
            self._supervisor.content_breaker.record_failure()
        self._fail_unit(u, OutputInvalid("staged", "denoise", [slot]))
        self._free_slot(slot)

    def _retire_finished(self) -> None:
        sup = self._supervisor
        for slot, u in enumerate(self._slots):
            if u is None or self._steps[slot] < self.num_steps:
                continue
            row = self._lat.index_select(0, self._slot_index[slot:slot + 1])
            ready = self._record()
            self._free_slot(slot)
            self.stats["retirements"] += 1
            now = time.monotonic()
            metrics.observe("stage.denoise.service_s", now - u.t_admit)
            flight_recorder.record(
                "stage.retire", stage="denoise", slot=slot,
                step=self.stats["steps"], occupancy=self._active_n)
            unit = self._unit_products()
            if unit is not None:
                self._attribute(unit, now - u.t_admit)
            if u.ctx is not None and u.ctx.sampled:
                wait_s = u.t_admit - u.t_ready
                tracer.record_span(
                    "stage.denoise.wait", tracer.child_ctx(u.ctx),
                    parent_id=u.ctx.span_id, start_wall=u.wall_ready,
                    duration_s=wait_s, attrs={"slot": slot})
                attrs = {"slot": slot, "steps": self.num_steps}
                if unit is not None:
                    attrs["flops_est"] = unit.total
                tracer.record_span(
                    "stage.denoise.service", tracer.child_ctx(u.ctx),
                    parent_id=u.ctx.span_id,
                    start_wall=u.wall_ready + wait_s,
                    duration_s=now - u.t_admit, attrs=attrs)
            if sup is not None:
                sup.note_stage_progress("denoise")
            # stop(), a deadline or the verdict may have failed it already
            if not u.done.done():
                u.done.set_result((row, ready))

    def _unit_products(self) -> Optional[costmodel.Products]:
        """One request's denoise products, once the daemon count landed."""
        if self._denoise_cost is None:
            return None
        return costmodel.cached(*self._denoise_cost[:2])[1]

    @staticmethod
    def _attribute(unit: costmodel.Products, service_s: float) -> None:
        """A retirement's FLOPs attribution: the request's num_steps CFG
        forwards wherever its slot sat, and the gauge over its residency
        (admit to retire). Co-resident slots overlap, so the gauge is a
        lower bound that nears the truth as occupancy rises."""
        from cassmantle_tpu_torch.obs.device import note_dispatch

        labels = {"pipeline": "staged_denoise"}
        metrics.inc("request.device_flops", unit.total, labels=labels)
        if service_s > 0:
            metrics.gauge("pipeline.mxu_utilization",
                          costmodel.utilization(unit, service_s),
                          labels=labels)
        note_dispatch("staged_denoise")

    # -- wedge watchdog ------------------------------------------------------

    def _watchdog_check(self) -> bool:
        """Dispatch health without a host sync: a queued step whose event
        has not completed ``dispatch_hang_s`` after its launch means the
        device wedged mid-denoise. Flip the supervisor degraded and fail
        the in-flight slots (their callers must not wait on a device that
        never answers). True when it fired."""
        hang = self.cfg.serving.dispatch_hang_s
        if hang is None or not self._queued:
            return False
        ev, t0 = self._queued[0]
        if self._ready(ev) or time.monotonic() - t0 <= hang:
            return False
        log.error("stage.denoise step unready after %.1fs; failing %d "
                  "in-flight slots", hang, self._active_n)
        metrics.inc("stage.denoise.dispatch_hangs")
        flight_recorder.record("stage.dispatch_hang", stage="denoise",
                               hang_timeout_s=hang,
                               in_flight=self._active_n)
        if self._supervisor is not None:
            self._supervisor.note_dispatch_overrun("stage.denoise")
        exc = DispatchTimeout(f"stage.denoise step exceeded {hang}s")
        for slot, u in enumerate(self._slots):
            if u is not None:
                self._fail_unit(u, exc)
                self._free_slot(slot)
        self._reset_device_queue()
        return True

    @staticmethod
    def _fail_unit(u: _Unit, exc: Exception) -> None:
        if not u.done.done():
            u.done.set_exception(exc)

    # -- checks --------------------------------------------------------------

    def probe_step(self, slots: Sequence[int], step: int = 0,
                   graphed: bool = True, same_rows: bool = False,
                   reps: int = 1):
        """``reps`` steps of the slots ``slots`` (a width's worth, in order)
        from the current slot tensors with each of their counters set to
        ``step``, run on the denoise thread through the width's captured
        graph (``graphed``, CUDA) or its eager body; ``same_rows`` first
        copies the first slot's rows into the others. Returns (the slots'
        latents after the steps, device ms a step between CUDA events or
        None on the CPU) and leaves every slot tensor as it was. For
        checks and measurements: graph against eager, width against
        width, a width's step time."""
        width = len(slots)
        if width not in self._step_widths:
            raise ValueError(f"{width} slots is not a step width "
                             f"{self._step_widths}")
        if not 0 <= step <= self.num_steps - reps:
            raise ValueError(f"steps {step}..{step + reps} outside the "
                             f"schedule's {self.num_steps}")

        def run():
            if self._lat is None:
                raise RuntimeError("no slot state yet: serve a request "
                                   "first")
            state = (self._lat, self._aux, self._counter, self._finite,
                     *self._cond.values())
            saved = [t.clone() for t in state]
            idx = torch.tensor(list(slots), dtype=torch.long,
                               device=self.device)
            if same_rows:
                for t in (self._lat, self._aux, *self._cond.values()):
                    t.index_copy_(0, idx, t.index_select(
                        0, idx[:1]).expand((width,) + t.shape[1:]))
            self._counter.index_fill_(0, idx, step)
            self._set_width_slots(width, np.asarray(slots, dtype=np.int64))
            fn = (self._step_fn(width) if graphed and self._cuda else
                  lambda: self._step_body(self._width_idx[width]))
            ms = None
            if self._cuda:
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                start.record()
            for _ in range(reps):
                fn()
            if self._cuda:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / reps
            out = self._lat.index_select(0, idx)
            for t, s in zip(state, saved):
                t.copy_(s)
            self._width_slots[width] = None
            return out, ms

        return self.run_on_denoise_thread(run)
