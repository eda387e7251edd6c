"""Synthetic canary prober: play the real game, constantly.

Port of ``cassmantle_tpu/obs/prober.py``. White-box health (breakers,
watchdogs, the device probe) says whether the parts report healthy; the
canary says whether someone can play right now. The worker runs a
background loop that plays the whole serving surface over real HTTP:
``/init``, one ``/clock`` WebSocket tick, ``/fetch/contents`` (the JPEG
decoded, the masks checked) and ``/compute_score`` on a known-answer
probe room. Every answer but one is exact (the 1.0 shortcut); the last
is a near guess, so the batched similarity rung runs: the int8 embed
table when one is armed, the score queue and the device otherwise.

The probe room (``engine/game.py::PROBE_ROOM``) is isolated: its store
keys live under ``probe:<worker_id>:``, its Game counts no engine
metrics, it is absent from the room directory, and the HTTP layer
answers it only for cluster peers (``?room=__probe__`` is a 404 to
anyone else). Its requests carry the ``probe`` trace mark, so the
batching queues' adaptive admission neither sheds them nor learns from
them (``serving/queue.py``).

Every probe runs under a root span ``probe.run`` retained by the tail
sampler as ``"probe"``, so a failed probe's trace is at
``/debugz?trace=<id>`` and the ``probe.e2e_s`` histogram's exemplars
point at it. Verdicts feed ``probe.ok`` / ``probe.failures`` /
``probe.e2e_s``, the ``probe.fail`` flight-recorder event, ``/readyz``'s
``canary`` block and the two SLO objectives ``probe_success`` and
``probe_latency`` (``obs/slo.py``).

``CASSMANTLE_NO_PROBER=1`` (read at startup and every tick) leaves no
probe artifact: no metric, no store key, no task, no objective.
``CASSMANTLE_PROBE_INTERVAL_S`` overrides the cadence (floor 0.5 s). Each
pass probes this worker through its own listener, then every live peer
with an advertised address through the peer's listener, with the cluster
token: every worker checks its peers' serving paths from outside.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from cassmantle_tpu_torch.engine.masking import build_prompt_state
from cassmantle_tpu_torch.engine.rounds import (
    COUNTDOWN_KEY,
    IMAGE_KEY,
    PROMPT_KEY,
    STORY_KEY,
)
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import format_traceparent, tracer
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("prober")

# Fixed probe content: build_prompt_state has no randomness, so every
# worker derives the same masks and answers from this sentence.
PROBE_SENTENCE = (
    "a violet lighthouse hums beside the glass harbor while copper "
    "gulls drift over the quiet evening tide"
)
PROBE_IMAGE_SIZE = 64
# The probe room's countdown, refreshed when it runs low: its clock always
# reads a live round, and no round timer ever runs there.
PROBE_COUNTDOWN_S = 3600.0
# The near guess for the last mask: not in the sentence, so the
# exact-match shortcut cannot fire and the similarity rung runs.
PROBE_NEAR_GUESS = "harbinger"


class ProbeFailure(AssertionError):
    """One leg's check failed; the message says what, the span's ``leg``
    attribute which leg."""


def probe_image() -> np.ndarray:
    """The probe round's image: a diagonal gradient whose shape the fetch
    leg checks after the blur and JPEG round trip."""
    g = np.arange(PROBE_IMAGE_SIZE, dtype=np.int32)
    grad = (np.add.outer(g, g) * 2 % 256).astype(np.uint8)
    return np.stack([grad, grad.T, 255 - grad], axis=-1)


def probe_state(game) -> Dict:
    """The probe round's prompt state from the probe game's own embed
    function, kept on the game after the first call."""
    state = getattr(game, "_probe_state", None)
    if state is None:
        state = build_prompt_state(
            PROBE_SENTENCE, game.rounds.embed, game.rounds.num_masked)
        game._probe_state = state
    return state


def probe_answers(state: Dict) -> Dict[str, str]:
    tokens = state["tokens"]
    return {str(m): str(tokens[int(m)]) for m in state["masks"]}


async def ensure_probe_round(game) -> Dict:
    """Seed the probe room's store with the known-answer round if it is
    missing, and keep its countdown alive. Seeding also pins the answers
    into the embed table when one is armed (``rounds._notify_answers``),
    so the near guess rides the table rung as players' guesses do."""
    from cassmantle_tpu_torch.utils.codec import encode_jpeg

    state = probe_state(game)
    store = game.store
    if await store.hget(PROMPT_KEY, "current") is None:
        await store.hset(PROMPT_KEY, "seed", PROBE_SENTENCE)
        await store.hset(PROMPT_KEY, "current", json.dumps(state))
        await store.hset(IMAGE_KEY, "current", encode_jpeg(probe_image()))
        await store.hset(IMAGE_KEY, "version", "1")
        await store.hset(STORY_KEY, mapping={
            "title": "canary", "content": PROBE_SENTENCE})
        await game.rounds._notify_answers(state)
    if await store.ttl(COUNTDOWN_KEY) < 60.0:
        await store.setex(COUNTDOWN_KEY, PROBE_COUNTDOWN_S, "active")
    return state


def prober_disabled() -> bool:
    """CASSMANTLE_NO_PROBER set: no probes, no probe artifacts."""
    return os.environ.get("CASSMANTLE_NO_PROBER", "").lower() in (
        "1", "true", "yes", "on")


class CanaryProber:
    """The worker's probe loop. ``self_addr`` is this worker's own HTTP
    address: the probe goes through the real listener and its
    middlewares; peers are probed at the addresses they advertise."""

    def __init__(self, fabric, cfg, self_addr: Optional[str] = None):
        self.fabric = fabric
        self.cfg = cfg
        self.self_addr = self_addr
        self._http = None
        # worker -> last verdict (the /readyz canary block)
        self._last: Dict[str, dict] = {}
        self._consecutive_failures = 0

    def interval_s(self) -> float:
        raw = os.environ.get("CASSMANTLE_PROBE_INTERVAL_S", "")
        if raw:
            try:
                return max(0.5, float(raw))
            except ValueError:
                log.warning("bad CASSMANTLE_PROBE_INTERVAL_S=%r; using the "
                            "config's cadence", raw)
        return float(self.cfg.obs.probe_interval_s)

    def _session(self):
        import aiohttp

        if self._http is None or self._http.closed:
            self._http = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(
                    total=float(self.cfg.obs.probe_timeout_s)))
        return self._http

    async def close(self) -> None:
        if self._http is not None and not self._http.closed:
            await self._http.close()
        self._http = None

    async def probe_once(self, worker: Optional[str] = None,
                         addr: Optional[str] = None) -> dict:
        """Play the game surface against one worker and record the
        verdict, which is returned and kept for ``/readyz``."""
        if worker is None:
            worker = self.fabric.worker_id
        if addr is None:
            addr = self.self_addr or self.fabric.membership.addr
        verdict: Dict[str, object] = {
            "target": worker, "ok": False, "leg": None, "error": None,
            "e2e_s": None, "trace": None, "t": time.time(),
        }
        with tracer.span("probe.run", root=True,
                         attrs={"target": worker,
                                "worker": self.fabric.worker_id}) as span:
            # every probe is retained: a failed one's trace must be
            # retrievable, a slow passing one is early latency evidence
            tracer.mark_retain("probe", span.ctx)
            verdict["trace"] = span.trace_id
            t0 = time.perf_counter()
            try:
                if not addr:
                    raise ProbeFailure("no probe target address")
                await self._play(addr, span)
                verdict["ok"] = True
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                verdict["leg"] = span.attrs.get("leg", "connect")
                verdict["error"] = f"{type(exc).__name__}: {exc}"
                span.attrs["error"] = verdict["error"]
            dt = time.perf_counter() - t0
            verdict["e2e_s"] = round(dt, 6)
            # inside the span: the bucket's exemplar names this trace
            metrics.observe("probe.e2e_s", dt)
            if verdict["ok"]:
                metrics.inc("probe.ok")
                self._consecutive_failures = 0
            else:
                metrics.inc("probe.failures")
                self._consecutive_failures += 1
                flight_recorder.record(
                    "probe.fail", target=worker, leg=verdict["leg"],
                    error=verdict["error"], trace=span.trace_id)
                log.warning("canary probe failed (target=%s leg=%s): %s",
                            worker, verdict["leg"], verdict["error"])
        self._last[worker] = verdict
        return verdict

    async def _play(self, addr: str, span) -> None:
        """The four legs in a player's order; the first that misbehaves
        raises, with ``span.attrs['leg']`` naming it."""
        from cassmantle_tpu_torch.engine.game import PROBE_ROOM
        from cassmantle_tpu_torch.utils.codec import decode_jpeg

        http = self._session()
        base = addr.rstrip("/")
        state = probe_state(self.fabric.probe_game())
        answers = probe_answers(state)
        session_id = f"canary-{self.fabric.worker_id}"
        params = {"room": PROBE_ROOM, "session": session_id}
        headers = {"traceparent": format_traceparent(span.ctx)}
        token = self.fabric.cluster_token()
        if token:
            headers["X-Cluster-Auth"] = token

        span.attrs["leg"] = "init"
        async with http.get(base + "/init", params=params,
                            headers=headers) as res:
            if res.status != 200:
                raise ProbeFailure(f"init answered {res.status}")
            data = await res.json()
            if data.get("session_id") != session_id:
                raise ProbeFailure("init echoed a foreign session id")

        span.attrs["leg"] = "clock"
        timeout = float(self.cfg.obs.probe_timeout_s)
        async with http.ws_connect(base + "/clock", params=params,
                                   headers=headers) as ws:
            tick = await ws.receive_json(timeout=timeout)
            missing = [k for k in ("time", "reset", "conns")
                       if k not in tick]
            if missing:
                raise ProbeFailure(f"clock tick missing {missing}")

        span.attrs["leg"] = "fetch"
        async with http.get(base + "/fetch/contents", params=params,
                            headers=headers) as res:
            if res.status != 200:
                raise ProbeFailure(f"fetch/contents answered {res.status}")
            data = await res.json()
        image = decode_jpeg(base64.b64decode(data["image"]))
        if image.shape != (PROBE_IMAGE_SIZE, PROBE_IMAGE_SIZE, 3):
            raise ProbeFailure(
                f"image decoded to shape {image.shape}, expected "
                f"({PROBE_IMAGE_SIZE}, {PROBE_IMAGE_SIZE}, 3)")
        prompt = data.get("prompt", {})
        if list(prompt.get("masks", [])) != list(state["masks"]):
            raise ProbeFailure(f"masks {prompt.get('masks')} != seeded "
                               f"{state['masks']}")
        for m in state["masks"]:
            if prompt["tokens"][int(m)] != "*":
                raise ProbeFailure(f"mask {m} not redacted in prompt")
        if not data.get("story"):
            raise ProbeFailure("story block missing")

        span.attrs["leg"] = "score"
        inputs = dict(answers)
        near_mask: Optional[str] = None
        if len(inputs) > 1:
            near_mask = str(state["masks"][-1])
            inputs[near_mask] = PROBE_NEAR_GUESS
        async with http.post(base + "/compute_score", params=params,
                             json={"inputs": inputs},
                             headers=headers) as res:
            if res.status != 200:
                raise ProbeFailure(f"compute_score answered {res.status}")
            scores = await res.json()
        for m in answers:
            raw = scores.get(m)
            if raw is None:
                raise ProbeFailure(f"mask {m} missing from scores")
            val = float(raw)
            if m == near_mask:
                # the similarity path clamps into [min_score, 0.999]: 1.0
                # means the exact shortcut fired; the floor is the
                # degraded answer (breaker open, deadline, invalid output)
                floor = float(self.cfg.game.min_score)
                if val <= floor:
                    raise ProbeFailure(
                        f"near-guess scored the {floor} floor — degraded "
                        f"(breaker/deadline/invalid-output) similarity "
                        f"serving")
                if val > 0.999:
                    raise ProbeFailure(
                        f"near-guess score {val} > 0.999: the similarity "
                        f"path was not exercised")
            elif val != 1.0:
                raise ProbeFailure(
                    f"exact answer for mask {m} scored {val}, not 1.0")

    def _targets(self) -> List[Tuple[str, Optional[str]]]:
        """This worker first, then every live peer of the membership
        table with an advertised address."""
        targets: List[Tuple[str, Optional[str]]] = [
            (self.fabric.worker_id,
             self.self_addr or self.fabric.membership.addr or None)]
        for worker, info in sorted(
                self.fabric.membership.live_workers().items()):
            if worker == self.fabric.worker_id:
                continue
            peer_addr = info.get("addr")
            if peer_addr:
                targets.append((worker, peer_addr))
        return targets

    async def probe_all(self) -> None:
        for worker, addr in self._targets():
            if addr:
                await self.probe_once(worker, addr)

    async def run(self) -> None:
        """The background loop of the server's startup. The kill switch
        is read every tick: set on a live worker, probing stops within
        one interval."""
        try:
            while True:
                await asyncio.sleep(self.interval_s())
                if prober_disabled():
                    continue
                try:
                    await self.probe_all()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # the prober observes the system and never takes it down
                    log.exception("canary probe pass failed; continuing")
        finally:
            await self.close()

    def status_block(self) -> Dict[str, object]:
        """The ``/readyz`` ``canary`` block: the last verdict per target
        and the failure streak. Advisory: a failing canary explains a
        drain, it does not cause one."""
        last = {w: dict(v) for w, v in self._last.items()}
        ok: Optional[bool] = None
        if last:
            ok = all(bool(v.get("ok")) for v in last.values())
        return {
            "enabled": not prober_disabled(),
            "interval_s": self.interval_s(),
            "ok": ok,
            "consecutive_failures": self._consecutive_failures,
            "targets": last,
        }
