"""The bounded trace capture behind ``POST /debug/trace``, on the CPU's
profiler (``utils/profiling.py::capture``).

A capture of N seconds runs as consecutive windows, each one
``torch.profiler`` trace written into the one directory; each next
window is sized, in seconds and in graph launches
(``ops/graphs.py::launch_gate``), from the dearest stop-and-write rates
seen so far so that they take about ``STOP_BUDGET_S``. The sizing rules
are checked as arithmetic; the gate with a thread standing in for the
graph launches of a denoise; the capture on the CPU profiler, with a
stop that is made slow on purpose, where each freeze's length is under
control. The route's contract (403, 400, 409, a counted 500,
``{"trace_dir", "seconds"}``) is ``tests/test_torch_port_opsurface.py``'s;
a failure inside a window is checked here.
"""

import asyncio
import contextlib
import json
import os
import threading
import time

import pytest
import torch

from cassmantle_tpu_torch.ops import graphs
from cassmantle_tpu_torch.ops.graphs import LaunchGate
from cassmantle_tpu_torch.utils import profiling
from cassmantle_tpu_torch.utils.logging import metrics
from cassmantle_tpu_torch.utils.profiling import (
    FIRST_WINDOW_S,
    LAUNCH_BOUNDS,
    STOP_BUDGET_S,
    WINDOW_BOUNDS_S,
    annotate,
    capture,
    next_launches,
    next_window_s,
)

LO, HI = WINDOW_BOUNDS_S


@pytest.mark.parametrize("rate,want", [
    (20.0, 0.05),             # 20 s of stop and write a second: 0.05 s
    (25.0, 0.04),
    (1e-3, HI),               # nearly free: the upper bound
    (1e4, LO),                # very dear: the lower bound
    (0.0, HI),                # nothing measured
])
def test_next_window_scales_to_the_budget(rate, want):
    assert next_window_s(rate, budget_s=1.0) == pytest.approx(want)
    assert LO <= next_window_s(rate) <= HI
    assert HI <= 0.1 and STOP_BUDGET_S <= 2.5 / 2


@pytest.mark.parametrize("cost,want", [
    (0.1, 10),                # 0.1 s of stop and write a launch: 10
    (0.3, 3),
    (1e-4, LAUNCH_BOUNDS[1]),  # nearly free: the upper bound
    (10.0, LAUNCH_BOUNDS[0]),  # dearer than the budget: the lower bound
    (0.0, LAUNCH_BOUNDS[0]),   # nothing measured: the lower bound
])
def test_next_launches_scales_to_the_budget(cost, want):
    assert next_launches(cost, budget_s=1.0) == want
    assert LAUNCH_BOUNDS[0] == 1


def test_capture_writes_windows_that_cover_the_seconds(tmp_path):
    """Every window a file of its own with events in it, the first
    FIRST_WINDOW_S long and admitting one graph launch, the capture
    lasting the seconds asked (less at most its last stop and write)
    and tracing no more of them; each window's start and stop held
    graph launches once, and counted."""
    windows = metrics.counter_total("obs.profiler_windows")
    held = metrics.hist_totals("graphs.held_off_s")
    t = time.perf_counter()
    out = capture(str(tmp_path), 0.4)
    wall = time.perf_counter() - t
    n = len(out["paths"])
    assert n >= 1 and out["window_s"][0] == pytest.approx(FIRST_WINDOW_S)
    assert sum(out["window_s"]) <= 0.4 + 1e-6
    assert wall >= 0.4 - out["stop_s"][-1] - out["write_s"][-1]
    assert out["launches"] == [LAUNCH_BOUNDS[0]] * n
    assert out["launched"] == [0] * n and out["launch_wait_s"] == [0.0] * n
    assert all(w >= 0 for w in out["lock_wait_s"])
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in out["paths"] + [out["ranges_path"]])
    for path in out["paths"]:
        with open(path) as f:
            assert "traceEvents" in json.load(f)
    assert metrics.counter_total("obs.profiler_windows") == windows + n
    assert metrics.hist_totals("graphs.held_off_s")[2] == \
        (held[2] if held else 0) + 2 * n
    assert all(s >= 0 for s in out["stop_s"] + out["write_s"])


def _slowed(monkeypatch, per_second=0.0, per_launch=0.0):
    """``profiling.trace`` with a stop made to cost ``per_second`` s a
    second of the window's span (as the capture slept it) and
    ``per_launch`` s a graph launch it admitted (a worker traced under
    load)."""
    real = profiling.trace
    slept = []

    class Clock:
        """``profiling``'s ``time``, keeping the seconds it sleeps."""

        def __getattr__(self, name):
            return getattr(time, name)

        def sleep(self, seconds):
            slept.append(seconds)
            time.sleep(seconds)

    monkeypatch.setattr(profiling, "time", Clock())

    @contextlib.contextmanager
    def slow_trace(log_dir, timings=None, launches=None):
        with real(log_dir, timings, launches) as path:
            yield path
        cost = (per_second * slept[-1]
                + per_launch * timings.get("launches", 0))
        time.sleep(cost)                 # the stop's collection
        timings["stop_s"] += cost

    monkeypatch.setattr(profiling, "trace", slow_trace)


def test_a_dear_stop_shortens_the_next_windows(tmp_path, monkeypatch):
    """With a stop made to cost 20 s a second traced (a worker traced
    under load), every window after the first is the shortest, so no
    stop and write exceeds the budget by more than the shortest window's
    cost, and the capture still lasts its seconds."""
    _slowed(monkeypatch, per_second=20.0)
    t = time.perf_counter()
    out = capture(str(tmp_path), 1.5, budget_s=0.15)
    wall = time.perf_counter() - t
    spent = [a + b for a, b in zip(out["stop_s"], out["write_s"])]
    assert out["window_s"][0] == pytest.approx(FIRST_WINDOW_S)
    assert len(out["paths"]) >= 2
    assert all(w <= LO + 1e-9 for w in out["window_s"][1:])
    assert max(spent[1:]) < 20.0 * LO + 0.15
    assert wall >= 1.5 - spent[-1]


def test_the_gate_admits_its_limit_and_holds_the_rest():
    """An open window admits its limit of another thread's launches at
    once and holds the next until it closes (reporting that wait); a
    closed gate and the window's own thread never wait."""
    gate = LaunchGate()
    gate.admit()                           # closed: passes
    gate.open(2)
    gate.admit()                           # the owner: passes, uncounted
    assert gate.admitted == 0
    passed = []

    def launcher():
        for i in range(3):
            gate.admit()
            passed.append((i, time.perf_counter()))

    thread = threading.Thread(target=launcher)
    thread.start()
    deadline = time.perf_counter() + 5.0
    while len(passed) < 2 and time.perf_counter() < deadline:
        time.sleep(0.005)
    time.sleep(0.2)
    assert [i for i, _ in passed] == [0, 1]   # the third waits
    closed = time.perf_counter()
    admitted, waited = gate.close()
    thread.join(5.0)
    assert not thread.is_alive()
    assert admitted == 2 and waited >= 0.15
    assert [i for i, _ in passed] == [0, 1, 2] and passed[2][1] >= closed


def test_a_dear_launch_lowers_the_next_windows_limit(tmp_path,
                                                     monkeypatch):
    """A thread launching without pause (a denoise's 50 step graphs),
    with each admitted launch making the stop 0.1 s dearer: the windows
    admit one launch until one has been admitted, every later window as
    many as the budget buys (2 at 0.28 s), never more, and the launcher
    is never left waiting after the capture."""
    _slowed(monkeypatch, per_launch=0.1)
    done = threading.Event()
    count = [0]

    def launcher():
        while not done.is_set():
            graphs.launch_gate.admit()
            count[0] += 1
            time.sleep(0.002)

    thread = threading.Thread(target=launcher)
    thread.start()
    try:
        out = capture(str(tmp_path), 1.5, budget_s=0.28)
    finally:
        done.set()
        thread.join(5.0)
    assert not thread.is_alive() and count[0] > 0
    n = len(out["paths"])
    first = next(i for i, k in enumerate(out["launched"]) if k)
    assert out["launches"] == [1] * (first + 1) + [2] * (n - first - 1)
    assert n - first >= 2
    assert all(a <= b for a, b in zip(out["launched"], out["launches"]))
    assert max(out["launch_wait_s"]) < 1.0


def test_capture_keeps_the_host_ranges(tmp_path):
    """An annotated range that another thread runs during a capture is in
    the capture's host ranges (the profiler itself records the capturing
    thread's host ops only), with that thread's id and a duration."""
    import threading

    done = threading.Event()

    def work():
        while not done.is_set():
            with annotate("trace_capture_range"):
                torch.ones(32, 32) @ torch.ones(32, 32)

    t = threading.Thread(target=work)
    t.start()
    try:
        out = capture(str(tmp_path), 0.3)
    finally:
        done.set()
        t.join()
    with open(out["ranges_path"]) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e["name"] == "trace_capture_range"]
    assert ours and all(e["tid"] == t.ident and e["dur"] >= 0
                        and e["cat"] == "user_annotation" for e in ours)
    # outside a capture, annotate records nothing of its own
    assert profiling._capture_ranges is None


def test_a_failing_window_fails_the_route_and_counts(tmp_path, monkeypatch):
    """A window whose trace raises ends the capture: the route answers
    500 and counts obs.profiler_capture_failures, and frees its single
    flight."""
    from aiohttp.test_utils import TestClient, TestServer

    from cassmantle_tpu_torch import config as pconfig
    from cassmantle_tpu_torch.server import app as papp

    monkeypatch.setenv("CASSMANTLE_TRACE_ROOT", str(tmp_path))
    monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    calls = []
    real = profiling.trace

    def flaky(log_dir, timings=None, launches=None):
        calls.append(log_dir)
        if len(calls) == 2:
            raise RuntimeError("profiler lost")
        return real(log_dir, timings, launches)

    monkeypatch.setattr(profiling, "trace", flaky)
    cfg = pconfig.test_config()

    async def body():
        fabric = papp.build_fabric(cfg, fake=True, worker_id="f2")
        app = papp.create_app(fabric, cfg, start_timer=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            res = await client.post("/debug/trace",
                                    params={"seconds": "0.5"})
            state = client.server.app[papp._TRACE_STATE]
            return res.status, state["active"]
        finally:
            await client.close()

    failures = metrics.counter_total("obs.profiler_capture_failures")
    status, active = asyncio.run(body())
    assert (status, active) == (500, False)
    assert len(calls) == 2
    assert metrics.counter_total("obs.profiler_capture_failures") == \
        failures + 1
