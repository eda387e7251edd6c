"""Continuous-batching coalescer: async requests -> fixed-shape device batches.

A copy of ``cassmantle_tpu/serving/queue.py`` (``:50-770``). Concurrent
requests (guess scorings, prompt decodes) land in an asyncio queue; a
collector drains up to ``max_batch`` or until ``max_delay_ms`` passes,
then hands the batch to a single dispatch thread, one per process, so
device dispatches serialize while the event loop stays free. The handler
pads a batch to its bucket (a batch of 37 guesses runs the 64 bucket).

Failure containment:

- **Backpressure**: a bounded queue; when full, ``submit`` fails fast and
  the caller degrades. While the supervisor reports degraded, the bound
  tightens to ``degraded_max_pending``; while it reports ``device_lost``,
  ``submit`` fails fast.
- **Per-request deadlines**: ``submit`` fails its future with
  :class:`DeadlineExceeded` when the deadline passes, whether the item is
  still queued or stuck inside a hung handler.
- **Dispatch watchdog**: a handler that runs past ``hang_timeout_s`` has
  wedged the dispatch thread (device calls hang rather than raise). The
  batch's futures fail with :class:`DispatchTimeout`, the supervisor is
  flipped degraded, and the wedged thread is *disowned* (daemon) and
  replaced so later batches still dispatch.

Overload control (``serving/overload.py``):

- **Adaptive admission**: with an :class:`AdaptiveLimiter` wired
  (``admission=``), the effective pending bound is the AIMD limit.
  Rejections raise :class:`OverloadShed` carrying a computed Retry-After,
  and a submission whose predicted wait already exceeds its
  ``deadline_s`` is rejected at once.
- **Priority tiers**: ``submit(priority=)`` with two classes. Interactive
  (guess scoring, the default) dispatches ahead of background (round
  generation); background is the first shed under pressure; and a
  starvation bound makes a background item head a batch after
  ``background_every`` consecutive batches dispatched with background
  work pending.

A handler may return an exception instance in a member's slot: that
member's future fails with it while the rest of the batch resolves (the
integrity sentinels' per-member verdicts).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import queue as _thread_queue
import threading
import time
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

from cassmantle_tpu_torch.chaos import ChaosInjected, fault_point
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import current_ctx, run_with_ctx, tracer
from cassmantle_tpu_torch.serving.overload import (
    PRIORITY_BACKGROUND,
    PRIORITY_INTERACTIVE,
    note_shed,
)
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

T = TypeVar("T")
R = TypeVar("R")

log = get_logger("queue")

# batch-size histogram bounds: the configured bucket ladder's shape
# (powers of two through the largest score bucket)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


class QueueFull(Exception):
    pass


class QueueStopped(QueueFull):
    """The queue shut down with this item still pending."""


class OverloadShed(QueueFull):
    """Rejected by the adaptive admission controller — not a hard
    capacity wall but a *decision*, carrying the computed Retry-After
    the HTTP layer serves and the reason (overload / background /
    predicted_late / loop_lag / chaos). Subclasses QueueFull so legacy
    call sites that degrade on backpressure keep degrading."""

    def __init__(self, name: str, *, reason: str = "overload",
                 retry_after_s: float = 1.0) -> None:
        super().__init__(f"{name} ({reason}; retry in "
                         f"{retry_after_s:.1f}s)")
        self.queue_name = name
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """A submitted item missed its per-request deadline."""


class DispatchTimeout(Exception):
    """The batch handler wedged the dispatch thread past the watchdog."""


class _HandlerWedged(Exception):
    """Internal watchdog signal: the RUNNING handler overran its hang
    deadline (distinct from a handler-raised TimeoutError, which must
    propagate per-item like any other handler exception)."""


class _DispatchWorker:
    """One DAEMON dispatch thread per process: device work serializes
    here. Daemon because a wedged device call cannot be cancelled, only
    disowned — ``replace()`` retires the stuck thread (it exits if its
    call ever returns), re-queues any jobs it hadn't started, and starts
    a fresh thread, without ever pinning process exit."""

    def __init__(self, name: str = "queue.dispatch_worker",
                 rank: int = 20) -> None:
        # lock hierarchy: worker bookkeeping nests inside nothing and may
        # precede supervisor state. The staged image server builds
        # workers of its own (stage.encode_dispatch 21,
        # stage.decode_dispatch 22), so each stage dispatches apart from
        # the process-global worker.
        self.name = name
        self._lock = OrderedLock(name, rank=rank)
        self._jobs: Optional[_thread_queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _loop(jobs: "_thread_queue.Queue") -> None:
        while True:
            job = jobs.get()
            if job is None:  # retired by replace()
                return
            fn, args, cf, started = job
            # the idle thread must not hold the last job's handler (and the
            # service behind it, its models included) until the next job
            del job
            if not cf.set_running_or_notify_cancel():
                continue
            started.set()
            del started
            outcome, failed = None, False
            try:
                outcome = fn(*args)
            except BaseException as exc:  # noqa: BLE001 — carried to waiter
                outcome, failed = exc, True
                del exc
            # drop the handler and its arguments BEFORE completing: the
            # waiter may drop the service and collect it the moment the
            # future resolves, while this frame would still hold it
            del fn, args
            if failed:
                cf.set_exception(outcome)
            else:
                cf.set_result(outcome)
            del outcome, cf

    def _ensure(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._jobs = _thread_queue.Queue()
            self._thread = threading.Thread(
                target=self._loop, args=(self._jobs,),
                daemon=True, name=f"cassmantle-{self.name}",
            )
            self._thread.start()

    def submit(self, fn: Callable, *args):
        """Returns (future, started_event). ``started`` distinguishes a
        handler that is actually RUNNING from one merely queued behind
        another queue's dispatch — the watchdog must only declare a wedge
        for the former."""
        with self._lock:
            self._ensure()
            cf: concurrent.futures.Future = concurrent.futures.Future()
            started = threading.Event()
            self._jobs.put((fn, args, cf, started))
            return cf, started

    def stop(self, timeout_s: float = 5.0) -> None:
        """Retire a dedicated worker's thread when its queue stops: the
        retire sentinel, then a bounded join; a thread still running (a
        wedged handler) is disowned, counted and flight-recorded. The
        process-global worker is never stopped."""
        with self._lock:
            jobs, thread = self._jobs, self._thread
            self._jobs = None
            self._thread = None
        if jobs is not None:
            jobs.put(None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                metrics.inc("dispatch.stop_overruns")
                flight_recorder.record("dispatch.stop_overrun",
                                       worker=self.name,
                                       timeout_s=timeout_s)
                log.warning("%s dispatch thread still running %.1fs after "
                            "stop; disowning it (wedged handler?)",
                            self.name, timeout_s)

    def replace(self) -> None:
        """Disown a wedged thread and start a fresh one. Jobs the old
        thread had not started move to the new thread; the in-flight call
        keeps its (already-failed) future and its eventual result is
        dropped."""
        with self._lock:
            old_jobs = self._jobs
            self._jobs = _thread_queue.Queue()
            if old_jobs is not None:
                while True:
                    try:
                        job = old_jobs.get_nowait()
                    except _thread_queue.Empty:
                        break
                    if job is not None:
                        self._jobs.put(job)
                old_jobs.put(None)  # retire the old thread when it unwedges
            self._thread = threading.Thread(
                target=self._loop, args=(self._jobs,),
                daemon=True, name=f"cassmantle-{self.name}",
            )
            self._thread.start()
            metrics.inc("dispatch.thread_replacements")


_dispatcher = _DispatchWorker()


class BatchingQueue(Generic[T, R]):
    """Coalesces ``submit`` calls into batched ``handler`` invocations.

    ``handler(items) -> results`` runs on the dispatch thread and must
    return one result per item (it pads internally to its bucket shapes).

    ``default_deadline_s`` bounds each submission end to end;
    ``hang_timeout_s`` arms the dispatch watchdog; ``supervisor`` (a
    :class:`~cassmantle_tpu.serving.supervisor.ServingSupervisor`)
    receives overrun notifications and drives the degraded admission
    bound ``degraded_max_pending``.
    """

    def __init__(
        self,
        handler: Callable[[List[T]], Sequence[R]],
        max_batch: int = 1024,
        max_delay_ms: float = 25.0,
        max_pending: int = 4096,
        name: str = "queue",
        default_deadline_s: Optional[float] = None,
        hang_timeout_s: Optional[float] = None,
        supervisor=None,
        degraded_max_pending: Optional[int] = None,
        dispatcher: Optional[_DispatchWorker] = None,
        admission=None,
        background_every: int = 8,
        on_dispatch_error: Optional[Callable[[BaseException], None]]
        = None,
    ) -> None:
        # the process-global worker, where device work serializes, unless
        # the queue is given a dedicated one (the staged image server's
        # encode and decode stages)
        self._dispatcher = (dispatcher if dispatcher is not None
                            else _dispatcher)
        self.handler = handler
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1000.0
        self.max_pending = max_pending
        self.name = name
        self.default_deadline_s = default_deadline_s
        self.hang_timeout_s = hang_timeout_s
        self.supervisor = supervisor
        self.degraded_max_pending = (
            degraded_max_pending if degraded_max_pending is not None
            else max(1, max_pending // 8)
        )
        # adaptive admission (serving/overload.py AdaptiveLimiter):
        # None keeps the legacy static max_pending bound exactly
        self.admission = admission
        # called with the exception when a dispatched batch fails —
        # the device-loss classification seam (device_recovery.py)
        self.on_dispatch_error = on_dispatch_error
        # starvation bound: after this many consecutive batches
        # dispatched while background work sat pending, the oldest
        # background item heads the next batch
        self.background_every = max(1, int(background_every))
        self._batches_since_bg = 0
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_pending)
        # background tier rides its own queue so dispatch order can
        # prefer interactive without scanning
        self._bg_queue: asyncio.Queue = asyncio.Queue(maxsize=max_pending)
        # items a racing get() returned after its cancellation was
        # requested (priority-pop bookkeeping); consulted first by the
        # collector and drained by stop()
        self._spill: List = []
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        """Start the collector on the running event loop. A queue first
        used from a loop that has since ended (each ``asyncio.run`` makes
        a new one) starts afresh on the new loop: its asyncio queues are
        bound to the old one, whose pending callers ended with it."""
        loop = asyncio.get_running_loop()
        get_loop = getattr(self._task, "get_loop", None)
        if self._task is not None and (get_loop is None
                                       or get_loop() is loop):
            return
        if self._task is not None:
            self._queue = asyncio.Queue(maxsize=self.max_pending)
            self._bg_queue = asyncio.Queue(maxsize=self.max_pending)
            self._spill = []
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            get_loop = getattr(self._task, "get_loop", None)
            if get_loop is not None and \
                    get_loop() is asyncio.get_running_loop():
                self._task.cancel()
                try:
                    await self._task
                except asyncio.CancelledError:
                    pass
            self._task = None
        # fail anything still queued: a pending future left to dangle
        # hangs its awaiting caller forever
        stopped = 0
        pending = list(self._spill)
        self._spill.clear()
        for q in (self._queue, self._bg_queue):
            while True:
                try:
                    pending.append(q.get_nowait())
                except asyncio.QueueEmpty:
                    break
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(QueueStopped(self.name))
            stopped += 1
        if stopped:
            metrics.inc(f"{self.name}.stopped_pending", stopped)
        # a dedicated dispatch worker dies with its queue; the shared one
        # outlives any one queue
        if self._dispatcher is not _dispatcher:
            self._dispatcher.stop()

    def _expire(self, fut: asyncio.Future) -> None:
        if not fut.done():
            metrics.inc(f"{self.name}.deadline_expired")
            flight_recorder.record("queue.deadline_expired",
                                   queue=self.name)
            # the wait histogram must include the waits that EXPIRED —
            # they are the tail that matters during degradation; only
            # counting survivors would report healthy p99s while users
            # time out
            t_submit = getattr(fut, "_obs_t", None)
            if t_submit is not None:
                metrics.observe(f"{self.name}.queue_wait_s",
                                time.perf_counter() - t_submit)
                # consumed: if the batch was already in flight when the
                # deadline hit, _record_batch_obs must not observe this
                # future a second time
                fut._obs_t = None          # type: ignore[attr-defined]
            fut.set_exception(DeadlineExceeded(self.name))

    def depth(self) -> int:
        """Pending submissions across both priority tiers."""
        return (self._queue.qsize() + self._bg_queue.qsize()
                + len(self._spill))

    async def submit(self, item: T, *,
                     deadline_s: Optional[float] = None,
                     priority: str = PRIORITY_INTERACTIVE) -> R:
        self.start()
        loop = asyncio.get_running_loop()
        depth = self.depth()
        deadline_s = (deadline_s if deadline_s is not None
                      else self.default_deadline_s)
        if self.supervisor is not None:
            lost = getattr(self.supervisor, "device_lost", None)
            if lost is not None:
                # the accelerator runtime is GONE: queuing work behind
                # it only manufactures deadline misses — fail fast with
                # a retriable error while the rebuild runs
                metrics.inc(f"{self.name}.rejected_device_lost")
                raise QueueFull(f"{self.name} (device_lost: {lost})")
        if self.supervisor is not None and self.supervisor.degraded and \
                depth >= self.degraded_max_pending:
            # degraded: admit only a short queue — deep backlogs behind a
            # sick device are all going to miss their deadlines anyway
            metrics.inc(f"{self.name}.rejected_degraded")
            raise QueueFull(f"{self.name} (degraded)")
        try:
            # drill lever: a fired ``server.admit``
            # rule forces a mis-admission — the request is shed as if
            # the limiter had rejected it
            fault_point("server.admit", peer=self.name)
        except ChaosInjected:
            metrics.inc(f"{self.name}.rejected_overload")
            note_shed()
            raise OverloadShed(
                self.name, reason="chaos",
                retry_after_s=(self.admission.retry_after_s(depth)
                               if self.admission is not None else 1.0))
        # canary-probe exemption: a probe-marked request (the server
        # stamps the trace context) bypasses adaptive admission and
        # never feeds the limiter's latency/capacity estimator — the
        # probe measures the system, it must not steer it. The static
        # max_pending wall and the degraded/device-lost fail-fasts still
        # apply: a probe that can't be served should FAIL (that is its
        # job), not queue-jump a dead device.
        ctx = current_ctx()
        probe = bool(ctx is not None and ctx.marks.get("probe"))
        if self.admission is not None and not probe:
            verdict = self.admission.admit(depth, priority, deadline_s)
            if verdict is not None:
                if verdict.reason == "predicted_late":
                    # doomed work rejected at submit, not at deadline
                    metrics.inc(f"{self.name}.rejected_predicted_late")
                elif verdict.reason == "background":
                    metrics.inc(f"{self.name}.rejected_background")
                else:
                    metrics.inc(f"{self.name}.rejected_overload")
                metrics.gauge(f"{self.name}.predicted_wait_s",
                              self.admission.predicted_wait_s(depth))
                note_shed()
                raise OverloadShed(self.name, reason=verdict.reason,
                                   retry_after_s=verdict.retry_after_s)
        if depth >= self.max_pending:
            # the static wall applies to the COMBINED depth: two
            # priority tiers must not quietly double the legacy
            # max_pending bound (each tier queue's own maxsize still
            # backstops the single-tier case identically)
            metrics.inc(f"{self.name}.rejected")
            raise QueueFull(self.name)
        fut: asyncio.Future = loop.create_future()
        # trace propagation rides the future, not the queue tuple: the
        # (item, fut) shape is a stable seam (tests poke it directly),
        # and a future without these attributes simply goes untraced
        fut._obs_ctx = ctx                  # type: ignore[attr-defined]
        fut._obs_t = time.perf_counter()    # type: ignore[attr-defined]
        fut._obs_priority = priority        # type: ignore[attr-defined]
        fut._obs_probe = probe              # type: ignore[attr-defined]
        q = (self._bg_queue if priority == PRIORITY_BACKGROUND
             else self._queue)
        try:
            q.put_nowait((item, fut))
        except asyncio.QueueFull:
            metrics.inc(f"{self.name}.rejected")
            raise QueueFull(self.name)
        metrics.gauge(f"{self.name}.depth", self.depth())
        if deadline_s is not None:
            handle = loop.call_later(deadline_s, self._expire, fut)
            fut.add_done_callback(lambda _f: handle.cancel())
        return await fut

    async def _pop_one(self, timeout: Optional[float]):
        """One pending item honoring priority: spilled items first,
        then interactive ahead of background — UNLESS background has
        sat out ``background_every`` consecutive batches (the
        starvation bound: its oldest item heads this batch). Both
        empty: await whichever tier produces first. Returns None on
        timeout. An item a racing get() returns after losing the
        FIRST_COMPLETED race (or after cancellation was requested)
        lands in ``self._spill`` — never lost, consumed next pop."""
        if self._spill:
            return self._spill.pop(0)
        starving = (self._bg_queue.qsize() > 0
                    and self._batches_since_bg >= self.background_every)
        order = ((self._bg_queue, self._queue) if starving
                 else (self._queue, self._bg_queue))
        for q in order:
            try:
                return q.get_nowait()
            except asyncio.QueueEmpty:
                pass
        getters = (
            # asyncio.Queue.get() is a COROUTINE here, not the blocking
            # queue.Queue.get — it runs as a task and is awaited below
            asyncio.ensure_future(self._queue.get()),
            asyncio.ensure_future(self._bg_queue.get()),
        )
        try:
            done, pending = await asyncio.wait(
                set(getters), timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            for t in getters:
                t.cancel()
            for t in getters:
                try:
                    self._spill.append(await t)
                except asyncio.CancelledError:
                    pass
            raise
        for t in pending:
            t.cancel()

            def _salvage(task) -> None:
                # the cancel can lose the race with an arriving item:
                # keep it for the next pop instead of dropping it
                if not task.cancelled() and task.exception() is None:
                    self._spill.append(task.result())

            t.add_done_callback(_salvage)
        items = [t.result() for t in getters
                 if t in done and not t.cancelled()
                 and t.exception() is None]
        if not items:
            return None
        self._spill.extend(items[1:])   # both tiers produced at once
        return items[0]

    async def _collect(self) -> List:
        """One entry (blocking) + everything arriving within the window.
        Cancellation-safe: items already popped off the queue when the
        collector is cancelled (queue stopping mid-window) have their
        futures failed here — stop()'s drain can no longer see them."""
        batch: List = []
        try:
            first = await self._pop_one(None)
            if first is not None:
                batch.append(first)
            loop = asyncio.get_running_loop()
            opened = loop.time()
            deadline = opened + self.max_delay_s
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                nxt = await self._pop_one(timeout)
                if nxt is None:
                    break
                batch.append(nxt)
            # how long the window actually held the first item before
            # dispatch: ~0 under load (bucket fills instantly), ~the
            # full max_delay under trickle traffic — the knob's cost
            metrics.gauge(f"{self.name}.coalesce_wait_s",
                          loop.time() - opened)
        except asyncio.CancelledError:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(QueueStopped(self.name))
            raise
        return batch

    async def _run(self) -> None:
        while True:
            batch = await self._collect()
            # deadline-expired entries are already failed; don't spend a
            # device dispatch on items nobody is waiting for
            batch = [(item, fut) for item, fut in batch if not fut.done()]
            if not batch:
                continue
            items = [item for item, _ in batch]
            futures = [fut for _, fut in batch]
            # starvation-bound bookkeeping: a batch that carried any
            # background member resets the counter; one dispatched while
            # background sat pending ages it toward background_every
            if any(getattr(f, "_obs_priority", None) == PRIORITY_BACKGROUND
                   for f in futures):
                self._batches_since_bg = 0
            elif self._bg_queue.qsize() > 0:
                self._batches_since_bg += 1
            metrics.inc(f"{self.name}.batches")
            metrics.inc(f"{self.name}.items", len(items))
            metrics.observe(f"{self.name}.batch_size", len(items),
                            buckets=BATCH_SIZE_BUCKETS)
            # the batch span JOINS the first traced member's trace (a
            # single-request batch — the interactive case — reads as one
            # contiguous trace); every traced member additionally gets
            # queue_wait/batch_service spans in its OWN trace, linked to
            # the batch by id (_record_batch_obs)
            ctxs = [c for c in (getattr(f, "_obs_ctx", None)
                                for f in futures) if c is not None]
            # prefer a SAMPLED member as the batch span's parent: joining
            # an unsampled member's trace would silently drop the batch
            # and device-stage spans for every sampled member behind it.
            # No traced member at all -> a DETACHED (unsampled) ctx, so
            # the batch records nothing rather than minting an orphan
            # root trace per batch that would flush the ring
            parent = next((c for c in ctxs if c.sampled),
                          ctxs[0] if ctxs else None)
            batch_ctx = (tracer.child_ctx(parent) if parent is not None
                         else tracer.detached_ctx())
            start_wall = time.time()
            t_dispatch = time.perf_counter()
            status = "ok"
            # the handler runs on the dispatch thread under the batch
            # span's context, so its block_timer stage spans land in the
            # batch's trace (contextvars don't cross threads on their own)
            dispatch, started = self._dispatcher.submit(
                run_with_ctx, batch_ctx, self._handle_batch, items)
            wrapped = asyncio.wrap_future(dispatch)
            try:
                with metrics.timer(f"{self.name}.batch_s"):
                    results = await self._await_dispatch(wrapped, started)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"handler returned {len(results)} results for "
                        f"{len(items)} items"
                    )
                for fut, res in zip(futures, results):
                    if not fut.done():
                        if isinstance(res, Exception):
                            # per-member failure (integrity sentinels:
                            # one poisoned batch row fails one request,
                            # not the batch)
                            fut.set_exception(res)
                        else:
                            fut.set_result(res)
            except asyncio.CancelledError:
                # queue stopping mid-batch: the in-flight futures must
                # fail, not dangle (their handler result is dropped)
                status = "error"
                self._disown(wrapped)
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(QueueStopped(self.name))
                raise
            except _HandlerWedged:
                # OUR handler is running and wedged (hung device call): fail
                # the batch, flip the supervisor degraded, and hand
                # future batches a fresh dispatch thread
                status = "error"
                log.error(
                    "%s handler exceeded %.1fs hang deadline; replacing "
                    "dispatch thread", self.name, self.hang_timeout_s)
                metrics.inc(f"{self.name}.dispatch_hangs")
                flight_recorder.record(
                    "queue.dispatch_hang", queue=self.name,
                    hang_timeout_s=self.hang_timeout_s,
                    batch_size=len(items))
                if self.supervisor is not None:
                    self.supervisor.note_dispatch_overrun(self.name)
                self._dispatcher.replace()
                self._disown(wrapped)
                exc = DispatchTimeout(
                    f"{self.name} dispatch exceeded {self.hang_timeout_s}s")
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(exc)
            except Exception as exc:  # noqa: BLE001 — propagate per-item
                status = "error"
                log.exception("%s batch failed", self.name)
                metrics.inc(f"{self.name}.failures")
                if self.on_dispatch_error is not None:
                    # device-loss classification seam (serving/
                    # device_recovery.py); advisory — a hook failure
                    # must not change the per-item failure contract
                    try:
                        self.on_dispatch_error(exc)
                    except Exception:
                        log.exception("%s on_dispatch_error hook "
                                      "failed", self.name)
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(exc)
            finally:
                self._record_batch_obs(
                    batch_ctx, parent, futures, start_wall, t_dispatch,
                    status)

    def _handle_batch(self, items: List[T]):
        """The dispatched body: the ``queue.dispatch`` fault point runs
        ON the dispatch thread, peer-scoped by queue name — a ``wedge``
        rule wedges the real thread and exercises the real watchdog
        (deadline expiry, thread disown + replace), not a mock of it."""
        fault_point("queue.dispatch", peer=self.name)
        return self.handler(items)

    def _record_batch_obs(self, batch_ctx, parent, futures,
                          start_wall: float, t_dispatch: float,
                          status: str) -> None:
        """Sink the batch span plus, per traced member, the queue-wait /
        batch-service split: wait is submit -> dispatch handoff, service
        is handoff -> batch completion (shared by all members — the
        device ran them as one computation). Also fills the request's
        marks blackboard so the HTTP layer can answer with
        ``X-Queue-Wait`` / ``X-Service-Time`` headers."""
        service_s = time.perf_counter() - t_dispatch
        tracer.record_span(
            f"{self.name}.batch", batch_ctx,
            parent_id=parent.span_id if parent is not None else None,
            start_wall=start_wall, duration_s=service_s, status=status,
            attrs={"queue": self.name, "batch_size": len(futures)})
        # probe members are invisible to the limiter's estimator AND
        # the queue-wait histogram: the canary's timings
        # belong to probe.e2e_s, never to the series that size
        # admission or alarm players' latency
        player = [f for f in futures
                  if not getattr(f, "_obs_probe", False)]
        if self.admission is not None and status == "ok" and player:
            # the AIMD signal: the batch's end-to-end latency is its
            # service time plus its slowest member's queue wait (error
            # batches excluded — a handler bug is not a latency signal)
            waits = [t_dispatch - t
                     for t in (getattr(f, "_obs_t", None)
                               for f in player) if t is not None]
            self.admission.observe_batch(
                max(waits) if waits else 0.0, service_s, len(player))
        for fut in futures:
            t_submit = getattr(fut, "_obs_t", None)
            if t_submit is None:
                continue
            wait_s = t_dispatch - t_submit
            if not getattr(fut, "_obs_probe", False):
                metrics.observe(f"{self.name}.queue_wait_s", wait_s)
            ctx = getattr(fut, "_obs_ctx", None)
            if ctx is None:
                continue
            # a request that rode several batches (gathered submits)
            # reports its slowest leg — the one that bounded its latency
            ctx.marks["queue_wait_s"] = max(
                wait_s, ctx.marks.get("queue_wait_s", 0.0))
            ctx.marks["service_s"] = max(
                service_s, ctx.marks.get("service_s", 0.0))
            if not ctx.sampled:
                continue
            link = {"queue": self.name,
                    "batch_trace": batch_ctx.trace_id,
                    "batch_span": batch_ctx.span_id}
            tracer.record_span(
                f"{self.name}.queue_wait", tracer.child_ctx(ctx),
                parent_id=ctx.span_id, start_wall=start_wall - wait_s,
                duration_s=wait_s, attrs=link)
            tracer.record_span(
                f"{self.name}.batch_service", tracer.child_ctx(ctx),
                parent_id=ctx.span_id, start_wall=start_wall,
                duration_s=service_s, status=status, attrs=link)

    async def _await_dispatch(self, wrapped: asyncio.Future,
                              started: "threading.Event"):
        """Await the dispatched batch, raising _HandlerWedged only when
        THIS handler has been RUNNING past the hang deadline. Time spent
        merely queued behind another queue's dispatch on the shared
        thread never counts: the hang clock arms only once ``started``
        is observed set, so a handler that began late (behind a slow but
        healthy neighbor) gets its full budget — declaring it wedged at
        the first window expiry would fail the batch, flip the
        supervisor degraded, and disown a healthy in-flight device call.
        (A genuinely queued-forever job is bounded elsewhere: the
        neighbor's own watchdog replaces the wedged thread and
        replace() moves unstarted jobs onto the fresh one, and every
        submission carries its per-request deadline.)"""
        if self.hang_timeout_s is None:
            return await wrapped
        loop = asyncio.get_running_loop()
        hang_deadline = None   # armed when the handler is seen running
        while True:
            if hang_deadline is None and started.is_set():
                hang_deadline = loop.time() + self.hang_timeout_s
            if hang_deadline is not None and \
                    loop.time() >= hang_deadline:
                raise _HandlerWedged()
            timeout = (self.hang_timeout_s if hang_deadline is None
                       else hang_deadline - loop.time())
            done, _ = await asyncio.wait({wrapped}, timeout=timeout)
            if done:
                # asyncio.wait just completed this future, so .result()
                # returns immediately (re-raising handler exceptions)
                return wrapped.result()

    @staticmethod
    def _disown(wrapped: asyncio.Future) -> None:
        """Abandon a dispatch future we will never await again; mark its
        eventual exception retrieved so asyncio doesn't log it."""
        if not wrapped.done():
            wrapped.add_done_callback(
                lambda f: None if f.cancelled() else f.exception())
