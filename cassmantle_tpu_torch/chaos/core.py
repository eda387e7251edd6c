"""Deterministic fault injection: named fault points and a seeded plan.

A copy of ``cassmantle_tpu/chaos/core.py`` (``:59-438``) with the
reference's whole registry of fault points: the serving seam's
(``server.admit``, ``queue.dispatch``, ``device.lost``, ``device.poison``,
``round.generate``, ``overload.brownout``, ``stage.denoise.tick``) and
those of many workers (``store.client.op``, ``repl.leader_call``,
``repl.pump``, ``fabric.heartbeat``, ``fabric.peer_http``,
``score.hedge``). Disarmed, a fault point is one module-global ``None``
check. An armed plan (the reference's ``CASSMANTLE_CHAOS`` grammar, given
to :func:`configure`, e.g. ``"seed=1;device.poison=raise:peer=scorer,
times=1"``) decides which hits fire; each rule draws from its own PRNG
seeded from (plan seed, point, kind, position), so a seed replays the same
schedule. :func:`plan` is the armed plan and :func:`release` the drill
lever that ends a wedge-until-released fault.

Fault kinds: ``raise`` (:class:`ChaosInjected`), ``flake`` (``raise``
with probability p, default 0.5), ``latency`` (sleep ``delay_s``),
``wedge`` (block until :func:`release`, :func:`disarm` or ``wedge_s``) and ``partition``
(:class:`ChaosPartition`, a ``ConnectionError``). Shared params: ``p``,
``after``, ``times``, ``peer``, ``delay_s``, ``wedge_s``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.locks import OrderedLock
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("chaos")

# The fault-point registry: every ``fault_point("name")`` literal in the
# port appears here. Plans validate against it, so a typo'd drill fails
# loudly instead of silently injecting nothing.
FAULT_POINTS: Dict[str, str] = {
    "store.client.op": "native store command round trip "
                       "(native/client.py; peer=host:port)",
    "repl.leader_call": "replicated-store leader operation "
                        "(engine/store.py; peer=host:port)",
    "repl.pump": "log-shipping pump pass (engine/store.py)",
    "queue.dispatch": "batch handler on the dispatch thread "
                      "(serving/queue.py; peer=queue name)",
    "server.admit": "queue admission decision "
                    "(serving/queue.py submit; peer=queue name)",
    "device.poison": "NaN/zero corruption of one dispatch-result "
                     "batch member (serving/integrity.py poison; "
                     "peer=pipeline)",
    "device.lost": "accelerator-runtime loss at a dispatch point "
                   "(serving dispatch regions; peer=scorer, t2i, sdxl "
                   "or prompt)",
    "round.generate": "content generation attempt "
                      "(engine/rounds.py; breaker-guarded)",
    "fabric.heartbeat": "membership heartbeat (fabric/membership.py)",
    "fabric.peer_http": "cluster peer HTTP fan-out "
                        "(server/app.py; peer=worker id)",
    "score.hedge": "cross-worker scorer hedge attempt "
                   "(server/app.py; peer=worker id)",
    "overload.brownout": "brownout-ladder tier evaluation "
                         "(serving/overload.py)",
    "stage.denoise.tick": "staged denoise step tick "
                          "(serving/stages.py)",
}

# the env lever that arms a plan at server boot; it wins over the config
CHAOS_ENV = "CASSMANTLE_CHAOS"

KINDS = ("raise", "flake", "latency", "wedge", "partition")


class ChaosInjected(RuntimeError):
    """An injected failure (kinds ``raise`` / ``flake``)."""


class ChaosPartition(ConnectionError):
    """An injected peer partition: a ``ConnectionError`` so the
    transport failover paths (store client drop + redial, replication
    leader election) treat it exactly like a real network cut."""


class ChaosRule:
    """One armed clause of the plan. Mutable counters are guarded by
    the plan lock; the release event is for ``wedge`` rules."""

    __slots__ = ("point", "kind", "p", "after", "times", "delay_s",
                 "wedge_s", "peer", "rng", "hits", "fires", "release")

    def __init__(self, point: str, kind: str, *, p: float = 1.0,
                 after: int = 0, times: Optional[int] = None,
                 delay_s: float = 0.05, wedge_s: float = 30.0,
                 peer: Optional[str] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.point = point
        self.kind = kind
        self.p = p
        self.after = after
        self.times = times
        self.delay_s = delay_s
        self.wedge_s = wedge_s
        self.peer = peer
        self.rng = rng or random.Random(0)
        self.hits = 0
        self.fires = 0
        self.release = threading.Event()

    def snapshot(self) -> Dict[str, object]:
        return {
            "point": self.point, "kind": self.kind, "p": self.p,
            "after": self.after, "times": self.times, "peer": self.peer,
            "hits": self.hits, "fires": self.fires,
        }


def parse_spec(spec: str, default_seed: int = 0,
               ) -> Tuple[int, List[ChaosRule]]:
    """(seed, rules) from the ``CASSMANTLE_CHAOS`` grammar. Unknown
    points and kinds raise ValueError — a typo'd drill must fail at arm
    time, not silently inject nothing."""
    clauses = [c.strip() for c in spec.split(";") if c.strip()]
    seed = default_seed
    raw: List[Tuple[str, str, Dict[str, str]]] = []
    for clause in clauses:
        key, sep, val = clause.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(f"chaos clause {clause!r}: expected "
                             f"point=kind[:k=v,...] or seed=N")
        if key == "seed":
            seed = int(val)
            continue
        if key not in FAULT_POINTS:
            raise ValueError(
                f"chaos clause {clause!r}: unknown fault point {key!r} "
                f"(registry: {sorted(FAULT_POINTS)})")
        kind, _, params_raw = val.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"chaos clause {clause!r}: unknown kind "
                             f"{kind!r} (kinds: {KINDS})")
        params: Dict[str, str] = {}
        for item in params_raw.split(","):
            item = item.strip()
            if not item:
                continue
            pk, psep, pv = item.partition("=")
            if not psep:
                raise ValueError(f"chaos clause {clause!r}: bad param "
                                 f"{item!r} (expected k=v)")
            params[pk.strip()] = pv.strip()
        unknown = set(params) - {"p", "after", "times", "delay_s",
                                 "wedge_s", "peer"}
        if unknown:
            raise ValueError(f"chaos clause {clause!r}: unknown "
                             f"param(s) {sorted(unknown)}")
        raw.append((key, kind, params))
    rules = []
    for i, (point, kind, params) in enumerate(raw):
        # per-rule PRNG seeded from (plan seed, point, kind, position):
        # each rule's fire/skip draws are a pure function of ITS hit
        # sequence — cross-point interleaving can never perturb them,
        # which is what makes the schedule replayable (acceptance)
        rng = random.Random(f"{seed}:{point}:{kind}:{i}")
        rules.append(ChaosRule(
            point, kind,
            p=float(params.get("p", "0.5" if kind == "flake" else "1.0")),
            after=int(params.get("after", "0")),
            times=int(params["times"]) if "times" in params else None,
            delay_s=float(params.get("delay_s", "0.05")),
            wedge_s=float(params.get("wedge_s", "30.0")),
            peer=params.get("peer"),
            rng=rng,
        ))
    return seed, rules


class ChaosPlan:
    """The armed fault schedule: rules indexed by point, a bounded
    fired-log for replay pinning, injectable sleeps for tests."""

    def __init__(self, seed: int, rules: List[ChaosRule], *,
                 sleep=time.sleep, max_log: int = 256) -> None:
        self.seed = seed
        self.rules = list(rules)
        self._by_point: Dict[str, List[ChaosRule]] = {}
        for rule in self.rules:
            self._by_point.setdefault(rule.point, []).append(rule)
        # leaf rank: hit bookkeeping nests
        # inside anything and holds nothing else
        self._lock = OrderedLock("chaos.plan", rank=60)
        self._sleep = sleep
        self._seq = 0
        self.fired: Deque[Dict[str, object]] = deque(maxlen=max_log)

    # -- decision (deterministic) -----------------------------------------
    def _decide(self, name: str, peer: Optional[str],
                ) -> Optional[ChaosRule]:
        rules = self._by_point.get(name)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if rule.peer is not None and rule.peer != peer:
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.times is not None and rule.fires >= rule.times:
                    continue
                if rule.p < 1.0 and rule.rng.random() >= rule.p:
                    continue
                rule.fires += 1
                self._seq += 1
                self.fired.append({
                    "seq": self._seq, "point": name, "kind": rule.kind,
                    "peer": peer, "hit": rule.hits,
                })
                return rule
        return None

    def _record(self, rule: ChaosRule, name: str,
                peer: Optional[str]) -> None:
        metrics.inc("chaos.injections")
        # attr named ``fault`` (not ``kind``): the recorder's own first
        # parameter is the event kind
        flight_recorder.record("chaos.injected", point=name,
                               fault=rule.kind, peer=peer)
        # whatever request this injection landed in is a trace worth
        # keeping: mark the ambient context
        from cassmantle_tpu_torch.obs.trace import tracer

        tracer.mark_retain("chaos")
        log.warning("chaos: injecting %s at %s (peer=%s, fire %d)",
                    rule.kind, name, peer, rule.fires)

    # -- execution ---------------------------------------------------------
    def hit(self, name: str, peer: Optional[str] = None) -> None:
        """The fault point's body."""
        rule = self._decide(name, peer)
        if rule is None:
            return
        self._record(rule, name, peer)
        if rule.kind == "latency":
            self._sleep(rule.delay_s)
            return
        if rule.kind == "wedge":
            rule.release.wait(timeout=rule.wedge_s)
            return
        if rule.kind == "partition":
            raise ChaosPartition(f"chaos: partitioned {name} "
                                 f"(peer={peer})")
        raise ChaosInjected(f"chaos: injected failure at {name}")

    async def ahit(self, name: str, peer: Optional[str] = None) -> None:
        """The async fault point's body (generation, store operations)."""
        import asyncio

        rule = self._decide(name, peer)
        if rule is None:
            return
        self._record(rule, name, peer)
        if rule.kind == "latency":
            await asyncio.sleep(rule.delay_s)
            return
        if rule.kind == "wedge":
            deadline = time.monotonic() + rule.wedge_s
            while not rule.release.is_set() and \
                    time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            return
        if rule.kind == "partition":
            raise ChaosPartition(f"chaos: partitioned {name} "
                                 f"(peer={peer})")
        raise ChaosInjected(f"chaos: injected failure at {name}")

    # -- control -----------------------------------------------------------
    def release_point(self, name: str) -> int:
        """Release every wedge rule at a point; returns how many."""
        released = 0
        for rule in self._by_point.get(name, ()):
            if rule.kind == "wedge":
                rule.release.set()
                released += 1
        return released

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "armed": True,
                "seed": self.seed,
                "injections": self._seq,
                "rules": [r.snapshot() for r in self.rules],
                "recent": list(self.fired)[-10:],
            }

    def schedule(self) -> List[Dict[str, object]]:
        """The fired log so far (replay pinning: same seed + same hit
        sequence => identical schedules)."""
        with self._lock:
            return list(self.fired)


# -- module-level fault points (the zero-overhead contract) ----------------

_PLAN: Optional[ChaosPlan] = None


class _Done:
    """A reusable already-done awaitable: ``await afault_point(...)``
    while disarmed costs one global check and one empty iterator."""

    __slots__ = ()

    def __await__(self):
        return iter(())


_DONE = _Done()


def fault_point(name: str, peer: Optional[str] = None) -> None:
    """Sync fault point: a no-op unless a plan is armed."""
    if _PLAN is None:
        return
    _PLAN.hit(name, peer)


def afault_point(name: str, peer: Optional[str] = None):
    """Awaitable fault point: ``await afault_point("x")``. Disarmed it
    returns a shared no-op awaitable (no coroutine allocation)."""
    if _PLAN is None:
        return _DONE
    return _PLAN.ahit(name, peer)


def armed() -> bool:
    return _PLAN is not None


def plan() -> Optional[ChaosPlan]:
    return _PLAN


def configure(spec: object, *, sleep=time.sleep) -> Optional[ChaosPlan]:
    """Arm (or disarm, on an empty spec) the process-global plan.
    ``spec`` is a grammar string or a ``config.ChaosConfig``."""
    global _PLAN
    default_seed = 0
    if spec is not None and not isinstance(spec, str):
        default_seed = int(getattr(spec, "seed", 0))
        spec = getattr(spec, "spec", "")
    if not spec:
        disarm()
        return None
    seed, rules = parse_spec(spec, default_seed=default_seed)
    _PLAN = ChaosPlan(seed, rules, sleep=sleep)
    metrics.gauge("chaos.armed", 1.0)
    flight_recorder.record("chaos.armed", seed=seed, rules=len(rules))
    log.warning("chaos armed: seed=%d, %d rule(s) — this worker is "
                "running a DRILL (/readyz carries the chaos block)",
                seed, len(rules))
    return _PLAN


def configure_from_env(cfg: object = None) -> Optional[ChaosPlan]:
    """The server's boot entry: ``CASSMANTLE_CHAOS`` wins, else the
    config's ``ChaosConfig`` spec, else disarmed."""
    import os

    env_spec = os.environ.get(CHAOS_ENV, "")
    if env_spec:
        return configure(env_spec)
    if cfg is not None and getattr(cfg, "spec", ""):
        return configure(cfg)
    disarm()
    return None


def disarm() -> None:
    global _PLAN
    if _PLAN is not None:
        # unblock anything parked in a wedge before dropping the plan
        for rule in _PLAN.rules:
            rule.release.set()
    _PLAN = None
    metrics.gauge("chaos.armed", 0.0)


def release(name: str) -> int:
    """Release the wedge rules at a point (the drill lever that ends a
    wedge-until-released fault); returns how many."""
    if _PLAN is None:
        return 0
    return _PLAN.release_point(name)


def status() -> Dict[str, object]:
    """The `/readyz` / `/healthz` chaos block: ``{"armed": False}``
    when disarmed, else the plan snapshot."""
    if _PLAN is None:
        return {"armed": False}
    return _PLAN.status()
