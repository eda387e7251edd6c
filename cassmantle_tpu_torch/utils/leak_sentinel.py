"""LeakSentinel: threads and asyncio tasks that outlive their owner.

Port of ``cassmantle_tpu/utils/leak_sentinel.py``. While armed,
``threading.Thread.start`` and ``BaseEventLoop.create_task`` (under both
``asyncio.create_task`` and ``ensure_future``) are wrapped to stamp each
new thread and task with a sequence number and its creation site (the
first stack frame outside threading, asyncio and this module), held in
``WeakSet``s. :func:`verify` reports every tracked thread still alive
and task still pending that was made after a :func:`snapshot`, with its
origin, so a failure names who leaked. Open file descriptors are
diffed through ``/proc/self/fd`` where it exists, with no origin.

The sentinel wraps whatever ``Thread.start`` and ``create_task`` are
when it is armed, and puts back exactly those when it is disarmed, so it
nests with another wrapper of the same two functions (a test suite's own
sentinel). Its stamps live under their own attribute names: a thread
another wrapper stamped is still tracked here, and this one's stamps
never hide a thread from the other. A wrapper that someone else wrapped
over in the meantime cannot be taken out; it then passes calls through
untracked until the next arming.

Known limits, by design:

- process-lifetime singletons are allowlisted by thread name (the
  device probe, the staged server's stage threads, the shared queue
  dispatcher); tasks created on an allowlisted thread's loop are its
  working set and exempt the same way;
- a task that finishes before the diff runs is not a leak: the sentinel
  measures what outlives the owner.

Production: ``CASSMANTLE_LEAK_SENTINEL=1`` arms origin tracking at
server start (:func:`maybe_enable_from_env`), and the server calls
:func:`scan` at ``ObsConfig.process_sample_interval_s``: it counts
``leaks.threads`` / ``leaks.tasks`` / ``leaks.fds`` and records
``leak.detected`` with the oldest origins whenever the tracked census
grows past its high-water mark. Steady growth is the leak signal; a
stable census is the working set.
"""

from __future__ import annotations

import fnmatch
import os
import sys
import threading
import weakref
from typing import Dict, List, Optional, Set

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("leak_sentinel")

#: process-lifetime singletons by contract (thread names, fnmatch)
_THREAD_ALLOWLIST = (
    "cassmantle-queue.dispatch_worker",
    "device-probe",
    # the staged image server's loop, denoise and stage-dispatch threads
    "cassmantle-stage*",
    "ThreadPoolExecutor-*",
)

# the stamps' attribute names, apart from any other wrapper's
_SEQ, _ORIGIN, _THREAD = ("_port_leak_seq", "_port_leak_origin",
                          "_port_leak_thread")


class LeakError(AssertionError):
    """A thread, task or fd made after the snapshot outlived it; the
    message carries each one's creation site."""


_lock = threading.Lock()
_seq = 0
_armed = False
_orig_thread_start = None
_orig_create_task = None
_tracked_threads: "weakref.WeakSet" = weakref.WeakSet()
_tracked_tasks: "weakref.WeakSet" = weakref.WeakSet()
#: scan()'s high-water marks (census sizes at the last scan)
_hiwater = {"threads": 0, "tasks": 0, "fds": 0}

_SKIP_FRAMES = (os.sep + "threading.py", os.sep + "asyncio" + os.sep,
                "leak_sentinel.py")


def _origin() -> str:
    """The first stack frame outside threading, asyncio and the sentinels:
    the site that asked for the thread or task (a raw frame walk, cheap
    enough to run on every spawn)."""
    frame = sys._getframe(1)
    while frame is not None:
        fn = frame.f_code.co_filename
        if not any(s in fn for s in _SKIP_FRAMES):
            return f"{fn}:{frame.f_lineno} in {frame.f_code.co_name}"
        frame = frame.f_back
    return "<unknown>"


def _next_seq() -> int:
    global _seq
    with _lock:
        _seq += 1
        return _seq


def _wrapped_thread_start(self, *args, **kwargs):
    inner = _orig_thread_start
    if _armed and not getattr(self, _SEQ, None):
        setattr(self, _SEQ, _next_seq())
        setattr(self, _ORIGIN, _origin())
        _tracked_threads.add(self)
    return inner(self, *args, **kwargs)


def _wrapped_create_task(loop, coro, **kwargs):
    task = _orig_create_task(loop, coro, **kwargs)
    if _armed:
        try:
            setattr(task, _SEQ, _next_seq())
            setattr(task, _ORIGIN, _origin())
            # create_task runs on the loop's thread: an allowlisted
            # worker's tasks are its working set
            setattr(task, _THREAD, threading.current_thread().name)
            _tracked_tasks.add(task)
        except Exception:  # a task subclass with slots
            pass
    return task


def enable_sentinel() -> None:
    """Wrap Thread.start and create_task as they are now (idempotent; a
    wrapper of this module's still installed is armed again, not wrapped
    twice)."""
    global _armed, _orig_thread_start, _orig_create_task
    import asyncio.base_events

    base = asyncio.base_events.BaseEventLoop
    with _lock:
        if _armed:
            return
        _armed = True
        if _orig_thread_start is None:
            _orig_thread_start = threading.Thread.start
            threading.Thread.start = _wrapped_thread_start
        if _orig_create_task is None:
            _orig_create_task = base.create_task
            base.create_task = _wrapped_create_task


def disable_sentinel() -> None:
    """Put back what :func:`enable_sentinel` wrapped where this module's
    wrapper is still the one installed; a wrapper someone wrapped over
    stays in place and passes calls through."""
    global _armed, _orig_thread_start, _orig_create_task
    import asyncio.base_events

    base = asyncio.base_events.BaseEventLoop
    with _lock:
        if not _armed:
            return
        _armed = False
        if threading.Thread.start is _wrapped_thread_start:
            threading.Thread.start = _orig_thread_start
            _orig_thread_start = None
        if base.create_task is _wrapped_create_task:
            base.create_task = _orig_create_task
            _orig_create_task = None


def sentinel_active() -> bool:
    return _armed


def maybe_enable_from_env() -> None:
    """Arm log-only tracking under CASSMANTLE_LEAK_SENTINEL=1 (the server
    calls this at startup and :func:`scan` at its sampling cadence)."""
    if os.environ.get("CASSMANTLE_LEAK_SENTINEL", "") not in ("", "0"):
        enable_sentinel()


def _allowlisted_name(name: str) -> bool:
    return any(fnmatch.fnmatch(name or "", pat) for pat in _THREAD_ALLOWLIST)


def _open_fds() -> Optional[Set[int]]:
    try:
        return {int(x) for x in os.listdir("/proc/self/fd")}
    except (OSError, ValueError):  # no /proc: fd diffing is off
        return None


def snapshot() -> Dict[str, object]:
    """The baseline: the spawn sequence's high-water mark and the open fds.
    Anything tracked later and still alive at :func:`verify` leaked."""
    return {"seq": _seq, "fds": _open_fds()}


def _live_after(snap_seq: int):
    threads = [t for t in list(_tracked_threads)
               if getattr(t, _SEQ, 0) > snap_seq and t.is_alive()
               and not _allowlisted_name(t.name)]
    tasks = [t for t in list(_tracked_tasks)
             if getattr(t, _SEQ, 0) > snap_seq and not t.done()
             and not _allowlisted_name(getattr(t, _THREAD, ""))]
    return threads, tasks


def verify(snap: Dict[str, object], *, raise_on_leak: bool = True,
           fd_policy: str = "log") -> List[str]:
    """The leaks since ``snap`` (empty: clean). ``raise_on_leak`` raises
    :class:`LeakError` on a thread or task leak. ``fd_policy``: ``"log"``
    (counted, never raised: lazy process-lifetime caches open fds),
    ``"raise"`` or ``"off"``."""
    threads, tasks = _live_after(int(snap["seq"]))
    leaks = [
        f"thread {t.name!r} (daemon={t.daemon}) still alive, "
        f"created at {getattr(t, _ORIGIN, '<unknown>')}"
        for t in threads
    ] + [
        f"task {t.get_name()!r} still pending, "
        f"created at {getattr(t, _ORIGIN, '<unknown>')}"
        for t in tasks
    ]
    if threads:
        metrics.inc("leaks.threads", float(len(threads)))
    if tasks:
        metrics.inc("leaks.tasks", float(len(tasks)))
    fd_leaks: List[str] = []
    if fd_policy != "off" and snap.get("fds") is not None:
        now = _open_fds()
        if now is not None:
            grew = now - snap["fds"]  # type: ignore[operator]
            if grew:
                fd_leaks = [f"{len(grew)} fd(s) opened and not closed: "
                            f"{sorted(grew)[:8]}"]
                metrics.inc("leaks.fds", float(len(grew)))
    if leaks or fd_leaks:
        _record(leaks + fd_leaks)
    if raise_on_leak and (leaks or (fd_policy == "raise" and fd_leaks)):
        detail = "\n  ".join(leaks + fd_leaks)
        raise LeakError(
            f"{len(leaks) + len(fd_leaks)} leak(s) outlived the test:\n"
            f"  {detail}\nJoin the thread / await-or-cancel the task / "
            f"close the fd in teardown (or allowlist a documented "
            f"process-lifetime singleton in utils/leak_sentinel.py)")
    return leaks + fd_leaks


def _record(leaks: List[str]) -> None:
    from cassmantle_tpu_torch.obs.recorder import flight_recorder

    flight_recorder.record("leak.detected", count=len(leaks),
                           leaks=leaks[:8])
    for line in leaks:
        log.warning("leak: %s", line)


def scan() -> Dict[str, int]:
    """The production sweep (log-only): the tracked live census against
    the high-water marks. Growth counts ``leaks.*`` and records
    ``leak.detected``; never raises."""
    threads, tasks = _live_after(0)
    fds = _open_fds()
    census = {"threads": len(threads), "tasks": len(tasks),
              "fds": len(fds) if fds is not None else 0}
    grew: List[str] = []
    for key, objs in (("threads", threads), ("tasks", tasks)):
        if census[key] > _hiwater[key]:
            oldest = sorted(objs, key=lambda o: getattr(o, _SEQ, 0))
            grew.append(f"{key} census {census[key]} > high-water "
                        f"{_hiwater[key]}; oldest from "
                        + "; ".join(getattr(o, _ORIGIN, "<unknown>")
                                    for o in oldest[:3]))
            metrics.inc(f"leaks.{key}", float(census[key] - _hiwater[key]))
            _hiwater[key] = census[key]
    if fds is not None and census["fds"] > _hiwater["fds"]:
        if _hiwater["fds"]:  # the first scan sets the baseline
            metrics.inc("leaks.fds", float(census["fds"] - _hiwater["fds"]))
            grew.append(f"fd census {census['fds']} > high-water "
                        f"{_hiwater['fds']}")
        _hiwater["fds"] = census["fds"]
    if grew:
        _record(grew)
    return census


def reset() -> None:
    """Drop the tracking state: the WeakSets, the sequence counter and the
    high-water marks."""
    global _seq
    with _lock:
        _seq = 0
        _hiwater.update(threads=0, tasks=0, fds=0)
    _tracked_threads.clear()
    _tracked_tasks.clear()
