"""The serving seam's host-side control plane of the port against the
reference, on the same scripts: ``BatchingQueue`` (priorities, deadlines,
backpressure, admission, the watchdog, per-member failures, the
``device_lost`` and chaos fail-fasts), ``CircuitBreaker`` and
``ServingSupervisor``, ``AdaptiveLimiter``, ``RetryBudget``, the chaos
plan, and the trace spans a request's queue hop records. Each script runs
once against each package's module; the transcripts (batches in dispatch
order, each submission's result or exception class, states and
snapshots) must be equal. Clocks are
injected where the modules take one; the only real waits are the queue's
own (a few ms windows, handlers blocking at most 0.15 s).
"""

import asyncio
import threading

import pytest

from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu.obs import trace as jtrace
from cassmantle_tpu.serving import overload as joverload
from cassmantle_tpu.serving import queue as jqueue
from cassmantle_tpu.serving import supervisor as jsupervisor
from cassmantle_tpu.utils import circuit as jcircuit
from cassmantle_tpu.utils import retry as jretry
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.obs import trace as ptrace
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.serving import queue as pqueue
from cassmantle_tpu_torch.serving import supervisor as psupervisor
from cassmantle_tpu_torch.utils import circuit as pcircuit
from cassmantle_tpu_torch.utils import retry as pretry

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

PACKAGES = {
    "reference": dict(queue=jqueue, overload=joverload, chaos=jchaos,
                      supervisor=jsupervisor, circuit=jcircuit,
                      retry=jretry, trace=jtrace),
    "port": dict(queue=pqueue, overload=poverload, chaos=pchaos,
                 supervisor=psupervisor, circuit=pcircuit, retry=pretry,
                 trace=ptrace),
}


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def both(script):
    """(reference transcript, port transcript) of ``script(modules)``."""
    return tuple(script(PACKAGES[name]) for name in ("reference", "port"))


def outcome(task):
    exc = task.exception()
    return type(exc).__name__ if exc is not None else task.result()


async def _submit_all(q, items, **kw):
    """Submit ``items`` (item, priority, deadline) in order, all enqueued
    before the collector's first pop; the outcome of each."""
    tasks = []
    for item, priority, deadline in items:
        tasks.append(asyncio.ensure_future(
            q.submit(item, priority=priority, deadline_s=deadline)))
    await asyncio.wait(tasks)
    return [outcome(t) for t in tasks]


def _queue_script(m, *, handler_block=None, items, **queue_kw):
    """Build the module's queue with a recording handler (batch 0 can
    block on ``handler_block`` seconds), submit ``items`` and return
    (batches, outcomes)."""
    batches = []

    def handler(batch):
        batches.append(list(batch))
        if handler_block and len(batches) == 1:
            threading.Event().wait(handler_block)
        return [x if not str(x).startswith("bad") else ValueError(x)
                for x in batch]

    async def run():
        q = m["queue"].BatchingQueue(handler, **queue_kw)
        out = await _submit_all(q, items)
        await q.stop()
        return batches, out

    return asyncio.run(run())


IA, BG = "interactive", "background"


@pytest.mark.parametrize("case", [
    # interactive dispatches ahead of background queued first
    dict(items=[("bg0", BG, None), ("bg1", BG, None), ("ia0", IA, None),
                ("ia1", IA, None), ("ia2", IA, None)],
         max_batch=2, max_delay_ms=5),
    # the starvation bound: background heads a batch after 2 batches
    dict(items=[("bg0", BG, None)] + [(f"ia{i}", IA, None)
                                      for i in range(7)],
         max_batch=1, max_delay_ms=1, background_every=2),
    # per-member failures: the bad members fail alone
    dict(items=[("ok0", IA, None), ("bad1", IA, None), ("ok2", IA, None),
                ("bad3", BG, None)], max_batch=8, max_delay_ms=5),
    # the static wall: the combined depth of both tiers
    dict(items=[(f"x{i}", IA if i % 2 else BG, None) for i in range(7)],
         max_batch=2, max_delay_ms=5, max_pending=4),
    # deadlines: items queued behind a blocking batch expire
    dict(items=[("a", IA, None), ("b", IA, 0.05), ("c", IA, 0.05),
                ("d", IA, None)],
         max_batch=1, max_delay_ms=1, handler_block=0.15),
], ids=["priority", "starvation", "members", "backpressure", "deadlines"])
def test_queue_forms_the_references_batches(case):
    ref, port = both(lambda m: _queue_script(m, **case))
    assert port == ref
    assert port[0], "no batch dispatched"


def test_queue_watchdog_matches_reference():
    """A handler wedged past ``hang_timeout_s``: its batch fails with
    DispatchTimeout, the supervisor hears of the overrun once, and the
    replaced dispatch thread serves the next batch."""
    def script(m):
        overruns = []

        class Sup:
            degraded = False
            device_lost = None

            def note_dispatch_overrun(self, name):
                overruns.append(name)

        out = _queue_script(m, items=[("a", IA, None)], max_batch=1,
                            max_delay_ms=1, hang_timeout_s=0.05,
                            handler_block=0.15, supervisor=Sup(),
                            name="t_wd")

        async def again():
            q = m["queue"].BatchingQueue(lambda b: list(b), max_batch=1,
                                         max_delay_ms=1, name="t_wd2")
            res = await q.submit("b")
            await q.stop()
            return res

        return out, overruns, asyncio.run(again())

    ref, port = both(script)
    assert port == ref
    assert port[0][1] == ["DispatchTimeout"] and port[1] == ["t_wd"]


def test_queue_admission_matches_reference():
    """Adaptive admission on an injected clock: background sheds at half
    the limit, interactive at the limit, both as OverloadShed (a
    QueueFull) with the limiter's reason."""
    def script(m):
        clock = FakeClock()
        lim = m["overload"].AdaptiveLimiter(
            "t_adm", target_s=1.0, min_limit=2, max_limit=4,
            background_fraction=0.5, clock=clock, loop_lag_fn=lambda: 0.0)
        res = _queue_script(
            m, items=[("b0", BG, None), ("b1", BG, None), ("b2", BG, None),
                      ("i0", IA, None), ("i1", IA, None), ("i2", IA, None)],
            max_batch=8, max_delay_ms=5, admission=lim)
        return res, lim.snapshot()["limit"]

    ref, port = both(script)
    assert port == ref
    assert "OverloadShed" in port[0][1]


def test_queue_fails_fast_while_device_lost_and_under_chaos():
    def script(m):
        class Lost:
            degraded = True
            device_lost = "gone"

        lost = _queue_script(m, items=[("a", IA, None)], max_batch=1,
                             max_delay_ms=1, supervisor=Lost())
        m["chaos"].configure("seed=3;server.admit=raise:times=1")
        try:
            shed = _queue_script(m, items=[("a", IA, None),
                                           ("b", IA, None)],
                                 max_batch=2, max_delay_ms=5)
        finally:
            m["chaos"].disarm()
        return lost, shed

    ref, port = both(script)
    assert port == ref
    assert port[0][1] == ["QueueFull"] and port[1][1][0] == "OverloadShed"


# -- breaker and supervisor ----------------------------------------------------

def _breaker_script(m):
    clock = FakeClock()
    b = m["circuit"].CircuitBreaker("t_cb", failure_threshold=3,
                                    window_s=10.0, reset_timeout_s=5.0,
                                    clock=clock)
    log = []
    for op in ("f", "f", "tick6", "f", "f", "f", "allow", "tick5", "allow",
               "allow", "f", "tick5", "allow", "s", "allow", "tick20",
               "allow", "f"):
        if op == "f":
            b.record_failure()
        elif op == "s":
            b.record_success()
        elif op == "allow":
            log.append(b.allow())
        else:
            clock.advance(float(op[4:]))
        log.append((op, b.state, b.snapshot(),
                    b.seconds_until_half_open()))
    return log


def test_breaker_matches_reference():
    ref, port = both(_breaker_script)
    assert port == ref


def _supervisor_script(m):
    clock = FakeClock()
    sup = m["supervisor"].ServingSupervisor(degraded_cooldown_s=30.0,
                                            clock=clock)
    log = []

    def state():
        st = sup.status()
        log.append((st["ready"], st["state"], st["breakers"],
                     st["watchdog"], st.get("device_lost"),
                     sup.degraded, sup.shed_scores(), sup.retry_after_s()))

    state()
    sup.note_dispatch_overrun("score")
    state()
    clock.advance(31.0)
    state()
    for _ in range(5):
        sup.score_breaker.record_failure()
    state()
    clock.advance(46.0)
    state()
    sup.score_breaker.allow()
    sup.score_breaker.record_success()
    sup.note_device_lost("chaos: device.lost")
    state()
    sup.note_device_recovered()
    state()
    return log


def test_supervisor_matches_reference():
    ref, port = both(_supervisor_script)
    assert port == ref


# -- admission, retry budget, chaos ---------------------------------------------

def _limiter_script(m):
    clock = FakeClock()
    lag = [0.0]
    lim = m["overload"].AdaptiveLimiter(
        "t_lim", target_s=1.0, min_limit=4, max_limit=64, clock=clock,
        loop_lag_fn=lambda: lag[0])
    log = []
    trace = [(0.2, 0.3, 8), (0.1, 0.2, 16), (1.5, 0.8, 32), (0.4, 2.0, 8),
             (0.0, 0.1, 4), (3.0, 1.0, 64), (0.1, 0.1, 8), (0.1, 0.1, 8)]
    for wait, service, size in trace:
        lim.observe_batch(wait, service, size)
        clock.advance(0.7)
        log.append((lim.limit(), lim.predicted_wait_s(10),
                    lim.retry_after_s(10), lim.snapshot()))
        for depth, prio, deadline in ((2, "interactive", None),
                                      (30, "background", None),
                                      (60, "interactive", 1.0),
                                      (5, "interactive", 0.01)):
            verdict = lim.admit(depth, prio, deadline)
            log.append(None if verdict is None else
                       (verdict.reason, verdict.retry_after_s))
    lag[0] = 0.3
    log.append(lim.admit(0, "background", None).reason)
    log.append(lim.admit(0, "interactive", None))
    return log


def test_adaptive_limiter_reaches_the_references_limits():
    ref, port = both(_limiter_script)
    assert port == ref


def _budget_script(m):
    clock = FakeClock()
    budget = m["retry"].RetryBudget("t_budget", capacity=3.0,
                                    refill_per_s=0.5, clock=clock)
    log = []
    for dt in (0, 0, 0, 0, 1.0, 0, 2.0, 0, 0, 10.0, 0):
        clock.advance(dt)
        log.append((budget.acquire(), round(budget.tokens(), 9)))
    return log


def test_retry_budget_matches_reference():
    ref, port = both(_budget_script)
    assert port == ref


def _chaos_script(m):
    spec = ("seed=11;device.poison=flake:p=0.4,peer=scorer;"
            "device.lost=raise:after=2,times=2;queue.dispatch=latency:"
            "delay_s=0.0,p=0.5")
    _, rules = m["chaos"].parse_spec(spec)
    plan = m["chaos"].ChaosPlan(11, rules, sleep=lambda s: None)
    fired = []
    for i in range(40):
        for point, peer in (("device.poison", "scorer"),
                            ("device.poison", "t2i"),
                            ("device.lost", "prompt"),
                            ("queue.dispatch", "score")):
            try:
                plan.hit(point, peer)
            except Exception as exc:
                fired.append((i, point, type(exc).__name__))
    return fired, plan.schedule()


def test_chaos_plan_replays_the_references_schedule():
    """The same seeded plan fires at the same hits (the schedule's
    ``seq``/``hit``/``peer``) in both packages."""
    (ref_fired, ref_sched), (port_fired, port_sched) = both(_chaos_script)
    assert port_fired == ref_fired and port_fired
    assert port_sched == ref_sched


def test_chaos_registry_is_the_seams_and_refuses_others():
    """The port's registry is the reference's, the serving seam's points
    and those of many workers; a point outside it is refused."""
    assert set(pchaos.FAULT_POINTS) == set(jchaos.FAULT_POINTS)
    assert {"server.admit", "queue.dispatch", "device.lost",
            "device.poison", "round.generate", "overload.brownout",
            "stage.denoise.tick", "store.client.op", "repl.leader_call",
            "repl.pump", "fabric.heartbeat", "fabric.peer_http",
            "score.hedge"} == set(pchaos.FAULT_POINTS)
    pchaos.parse_spec("repl.pump=raise")
    with pytest.raises(ValueError, match="unknown fault point"):
        pchaos.parse_spec("repl.pmp=raise")


def _traced_script(m):
    """One traced request through a queue: the batch span joins the
    request's trace, which also gets the member's queue-wait and
    batch-service spans; the request's marks carry both seconds."""
    trace = m["trace"]

    async def run():
        q = m["queue"].BatchingQueue(lambda b: list(b), max_batch=4,
                                     max_delay_ms=1, name="t_trace")
        with trace.tracer.span("request", root=True):
            ctx = trace.current_ctx()
            await q.submit("x")
        await q.stop()
        names = sorted(s["name"] for s in trace.tracer.get_trace(
            ctx.trace_id))
        return names, sorted(k for k in ctx.marks
                             if k in ("queue_wait_s", "service_s"))

    return asyncio.run(run())


def test_queue_traces_like_the_reference():
    ref, port = both(_traced_script)
    assert port == ref
    assert port[0] == ["request", "t_trace.batch", "t_trace.batch_service",
                       "t_trace.queue_wait"]
    assert port[1] == ["queue_wait_s", "service_s"]


def test_the_dispatch_worker_drops_a_job_before_completing_it():
    """A future's done-callbacks run inside ``set_result`` on the worker
    thread. By then the worker must hold nothing of the job: a waiter
    that drops the handler's owner the moment the result lands (a
    stopped, dropped service) must see it collected."""
    import gc
    import weakref

    class Owner:
        def run(self, go):
            go.wait(5.0)
            return 7

    go = threading.Event()
    owner = Owner()
    ref = weakref.ref(owner)
    cf, _started = pqueue._dispatcher.submit(owner.run, go)
    del owner
    seen = {}
    called = threading.Event()

    def on_done(fut):
        gc.collect()
        seen["alive"] = ref() is not None
        seen["result"] = fut.result()
        called.set()

    cf.add_done_callback(on_done)
    go.set()
    assert called.wait(5.0)
    assert seen == {"alive": False, "result": 7}
