"""Profiler captures beside CUDA graph replays on another thread.

    python3 tools/capture_stress.py [--captures 10] [--seconds 0.5]
        [--small-kernels K] [--variant trace|cpu+cuda|cuda|cpu+cuda-noext]

On one NVIDIA card: a thread replays a captured graph without pause
(``ops/graphs.py::CapturedStep``, which takes the graph lock): 64 bf16
1024x1024 products, or with ``--small-kernels K`` K in-place adds on a
small tensor (a UNet step's graph launches about 2,800 kernels). The main
thread makes ``--captures`` profiler captures of ``--seconds`` each. The
default variant ``trace`` goes through ``utils/profiling.py::trace``, the
path of ``POST /debug/trace``; the others make the same capture with the
profiler's calls timed one by one: host and CUDA activity (``cpu+cuda``,
what ``trace`` records), CUDA activity only (``cuda``), or host and CUDA
with external correlation off (``cpu+cuda-noext``). A third thread ticks
every 10 ms, as an event loop would. Per capture it prints one JSON line:
the capture's seconds from start to its trace written, the seconds graph
launches were held off (``graphs.held_off_s``), the longest replay call
on the host (a launch waiting for the lock), the ticker's longest stall
(the interpreter held), the trace's bytes, its kernel and host-op events,
and for the timed variants the seconds of each profiler call. Then the
card line (name, power limit) and a summary line. A capture that hangs
dumps every thread's stack after 120 s. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed_capture(log_dir: str, seconds: float, variant: str,
                  calls: dict) -> str:
    """``utils/profiling.py::trace``'s capture with the activities and
    correlation of ``variant``, each profiler call's seconds put in
    ``calls``; returns the trace's path."""
    import torch
    from torch.autograd import _disable_profiler
    from torch.autograd import profiler as autograd_profiler
    from torch._C._profiler import _ExperimentalConfig

    from cassmantle_tpu_torch.ops.graphs import no_graph_running

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof = autograd_profiler.profile(
        use_cpu=variant != "cuda", use_device="cuda", use_kineto=True,
        experimental_config=_ExperimentalConfig(
            disable_external_correlation=variant.endswith("-noext")))

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        calls[name] = time.perf_counter() - t
        return out

    with no_graph_running():
        timed("prepare", prof._prepare_trace)
        timed("start", prof._start_trace)
    time.sleep(seconds)
    timed("synchronize", torch.cuda.synchronize)
    with no_graph_running():
        result = timed("disable", _disable_profiler)
    autograd_profiler._run_on_profiler_stop()
    timed("save", lambda: result.save(path))
    return path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--captures", type=int, default=10)
    parser.add_argument("--seconds", type=float, default=0.5)
    parser.add_argument("--small-kernels", type=int, default=0)
    parser.add_argument("--variant", default="trace", choices=(
        "trace", "cpu+cuda", "cuda", "cpu+cuda-noext"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("capture_stress: no CUDA device", file=sys.stderr)
        return 1
    from cassmantle_tpu_torch.ops.graphs import CapturedStep
    from cassmantle_tpu_torch.utils import profiling
    from cassmantle_tpu_torch.utils.logging import metrics

    a = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(a)
    small = torch.zeros(256, device="cuda")

    def body():
        if args.small_kernels:
            for _ in range(args.small_kernels):
                small.add_(1.0)
            return small
        x = a
        for _ in range(64):
            x = torch.mm(x, a).mul_(1e-3)
        out.copy_(x)
        return out

    step = CapturedStep(body)
    stop = threading.Event()
    replay_walls: list = []      # (end time, host seconds of one replay)
    ticks: list = []             # (end time, stall past 10 ms)

    def replays():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not stop.is_set():
                t = time.perf_counter()
                step.replay()
                now = time.perf_counter()
                replay_walls.append((now, now - t))
                torch.cuda.current_stream().synchronize()

    def ticker():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.01)
            now = time.perf_counter()
            ticks.append((now, now - last - 0.01))
            last = now

    def held() -> tuple:
        hist = metrics.snapshot()["timings"].get("graphs.held_off_s")
        return ((hist["count"], hist["count"] * hist["mean_s"])
                if hist else (0, 0.0))

    threads = [threading.Thread(target=replays, name="stress-replays"),
               threading.Thread(target=ticker, name="stress-ticker")]
    for th in threads:
        th.start()
    root = tempfile.mkdtemp(prefix="capture_stress_")
    rows = []
    try:
        time.sleep(0.5)
        for i in range(args.captures):
            faulthandler.dump_traceback_later(120, repeat=True)
            h0 = held()
            t0 = time.perf_counter()
            calls = {}
            if args.variant == "trace":
                with profiling.trace(os.path.join(root, str(i))) as path:
                    time.sleep(args.seconds)
            else:
                path = timed_capture(os.path.join(root, str(i)),
                                     args.seconds, args.variant, calls)
            t1 = time.perf_counter()
            faulthandler.cancel_dump_traceback_later()
            h1 = held()
            with open(path) as f:
                text = f.read()
            kernels = len(re.findall(r'"cat":\s*"kernel"', text))
            host_ops = len(re.findall(r'"cat":\s*"cpu_op"', text))
            rows.append({
                "capture": i, "capture_s": t1 - t0,
                "held_off_times": h1[0] - h0[0],
                "held_off_s": h1[1] - h0[1],
                "replay_max_s": max((w for t, w in replay_walls
                                     if t0 <= t <= t1 + 0.1), default=0.0),
                "ticker_max_stall_s": max((g for t, g in ticks
                                           if t0 <= t <= t1 + 0.1),
                                          default=0.0),
                "trace_bytes": len(text), "kernel_events": kernels,
                "host_op_events": host_ops, "calls_s": calls})
            print(json.dumps(rows[-1]), flush=True)
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)
            time.sleep(0.2)
    finally:
        stop.set()
        for th in threads:
            th.join()
        shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(card[0] if card else torch.cuda.get_device_name(0))
    ok = len(rows) == args.captures and all(r["kernel_events"] > 0
                                            for r in rows)
    print(json.dumps({
        "ok": ok, "captures": len(rows), "replays": step.replays,
        "capture_s_max": max(r["capture_s"] for r in rows),
        "held_off_s_max": max(r["held_off_s"] for r in rows),
        "replay_max_s": max(r["replay_max_s"] for r in rows),
        "ticker_max_stall_s": max(r["ticker_max_stall_s"] for r in rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
