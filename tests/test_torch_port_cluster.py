"""Many workers of the port: federation math against the reference's, two
in-process workers over one store, and ``serve --workers 2`` as processes.

- ``merge_states``: shard registries merged by the port equal the
  reference's merge of the same JSON states and the one registry that saw
  every event (counters and histogram buckets exactly); gauges take a
  ``worker`` label and a bounds mismatch keeps a worker-labeled series, as
  the reference's.
- Two workers (``w-a``, ``w-b``), each the port's ``create_app`` over its
  own ``RoomFabric`` on a real socket, sharing one store: rooms are placed
  as the reference's ring places them for the same worker ids, a room of
  the peer answers 307 to the peer's advertised address (room, session,
  signed traceparent) and one trace spans the hop; a scorer that chaos
  darkens hedges to the healthy peer, and floors when both are dark;
  ``/metrics?scope=cluster`` equals the merge of both workers' states and
  marks stale and dark peers; a graceful handoff waits until the peer has
  adopted the rooms; the canary walks every live peer through its
  listener.
- ``python -m cassmantle_tpu_torch serve --fake --workers 2 --store
  native:<port>``: both workers answer on one port, one of them generates
  each round, and a SIGKILLed worker counts ``server.worker_deaths``.
"""

import asyncio
import dataclasses
import json
import math
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestServer

import cassmantle_tpu.utils.logging as jlogging
from cassmantle_tpu.fabric.directory import RoomDirectory as JRoomDirectory
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.engine.content import FakeContentBackend, hash_embed
from cassmantle_tpu_torch.engine.game import Game
from cassmantle_tpu_torch.engine.store import MemoryStore
from cassmantle_tpu_torch.fabric.rooms import RoomFabric, room_ids
from cassmantle_tpu_torch.native.client import MantleStore, spawn_server
from cassmantle_tpu_torch.serving import overload
from cassmantle_tpu_torch.utils import logging as plogging
from cassmantle_tpu_torch.utils.logging import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what a healthy scorer answers a wrong guess: a floor score is min_score,
# so 0.5 shows a real similarity ran
REAL_SIM = 0.5


@pytest.fixture(autouse=True)
def _no_background(monkeypatch):
    """No prober or SLO loop of the apps' own: each test drives what it
    checks; the chaos plan and the ladder start and end disarmed."""
    monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    monkeypatch.setenv("CASSMANTLE_NO_SLO", "1")
    for var in ("CASSMANTLE_CHAOS", "CASSMANTLE_NO_CLUSTER_OBS",
                "CASSMANTLE_ROOM_COUNT"):
        monkeypatch.delenv(var, raising=False)
    pchaos.disarm()
    overload.reset_brownout()
    yield
    pchaos.disarm()
    overload.reset_brownout()


# -- merge_states against the reference's ------------------------------------

def _metric_of(line: str) -> str:
    return re.split(r"[{ ]", line, maxsplit=1)[0]


def _shards(package, seed=7, n_shards=3, events=400):
    """(ground registry, shard registries) fed one seeded event stream."""
    rng = random.Random(seed)
    bounds = (0.01, 0.1, 1.0)
    ground = package.Metrics(default_buckets=bounds)
    shards = [package.Metrics(default_buckets=bounds)
              for _ in range(n_shards)]
    for _ in range(events):
        shard = rng.choice(shards)
        if rng.random() < 0.5:
            name = rng.choice(["a.hits", "b.misses"])
            labels = ({"room": rng.choice(["r1", "r2"])}
                      if rng.random() < 0.5 else None)
            v = rng.randint(1, 5)
            shard.inc(name, v, labels=labels)
            ground.inc(name, v, labels=labels)
        else:
            name = rng.choice(["a.lat_s", "b.wait_s"])
            v = rng.random() * 2.0
            shard.observe(name, v)
            ground.observe(name, v)
        if rng.random() < 0.1:
            shard.gauge("c.depth", rng.random())
    return ground, shards


def test_merge_states_matches_the_reference_and_the_ground_truth():
    ground, shards = _shards(plogging)
    states = [(f"w{i}", json.loads(json.dumps(s.dump_state())))
              for i, s in enumerate(shards)]
    # the reference's shards make the same states, byte for byte
    _, jshards = _shards(jlogging)
    assert states == [(f"w{i}", json.loads(json.dumps(s.dump_state())))
                      for i, s in enumerate(jshards)]
    merged = plogging.merge_states(states)
    reference = jlogging.merge_states(states)
    assert merged.prometheus() == reference.prometheus()
    assert merged.snapshot() == reference.snapshot()
    # exact against one registry that saw every event
    assert merged.snapshot()["counters"] == ground.snapshot()["counters"]

    def hist_lines(m):
        return [line for line in m.prometheus().splitlines()
                if "_bucket{" in line or _metric_of(line).endswith("_count")]

    assert hist_lines(merged) == hist_lines(ground)
    for name in ("a.lat_s", "b.wait_s"):
        hm, hg = merged.hist_totals(name), ground.hist_totals(name)
        assert hm[1] == hg[1] and hm[2] == hg[2]
    mt, gt = merged.snapshot()["timings"], ground.snapshot()["timings"]
    for name in mt:
        assert math.isclose(mt[name]["mean_s"], gt[name]["mean_s"],
                            rel_tol=1e-9)
    # gauges: one series a worker, never a sum
    assert {k for k in merged.snapshot()["gauges"]} == {
        f'c.depth{{worker="w{i}"}}' for i in range(3)}


def test_merge_states_gauges_labeled_and_bounds_mismatch_falls_back():
    snaps = []
    for package in (plogging, jlogging):
        a, b = package.Metrics(), package.Metrics()
        a.gauge("x.depth", 3.0)
        a.observe("x.lat_s", 0.5, buckets=(0.1, 1.0))
        b.gauge("x.depth", 5.0)
        b.observe("x.lat_s", 0.5, buckets=(0.2, 2.0))   # a skewed ladder
        merged = package.merge_states([("wa", a.dump_state()),
                                       ("wb", b.dump_state())])
        snaps.append((merged.snapshot(), merged.prometheus()))
    (snap, text), ref = snaps
    assert (snap, text) == ref
    assert snap["gauges"]['x.depth{worker="wa"}'] == 3.0
    assert snap["gauges"]['x.depth{worker="wb"}'] == 5.0
    assert snap["timings"]["x.lat_s"]["count"] == 1
    assert snap["timings"]['x.lat_s{worker="wb"}']["count"] == 1


def test_merge_hist_state_refuses_other_bounds():
    m = plogging.Metrics()
    assert m.merge_hist_state("h_s", None, (0.1, 1.0), (1, 0, 2), 5.0, 3)
    assert not m.merge_hist_state("h_s", None, (0.5,), (1, 1), 1.0, 2)
    assert m.hist_totals("h_s") == ((0.1, 1.0), (1, 0, 2), 3)


# -- two in-process workers over one store -----------------------------------

def make_cfg(num_rooms=8, heartbeat_s=30.0, ttl_s=120.0, grace_s=0.5):
    """Heartbeats driven by hand (30 s) and a short handoff grace: each
    app's shutdown hands off, and waits for peers no test keeps beating."""
    cfg = pconfig.test_config()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=60.0,
                                 rate_limit_default=1e6,
                                 rate_limit_api=1e6),
        fabric=dataclasses.replace(cfg.fabric, num_rooms=num_rooms,
                                   heartbeat_s=heartbeat_s,
                                   membership_ttl_s=ttl_s,
                                   handoff_grace_s=grace_s))


def chaos_similarity(sup, worker):
    """A scorer in miniature: its dispatch is the ``queue.dispatch`` fault
    point (peer ``score-<worker>``), a fault counts toward the worker's
    score breaker and floors, an open breaker floors at once; healthy, it
    answers REAL_SIM."""

    async def sim(pairs):
        pairs = list(pairs)
        if not sup.score_breaker.allow():
            return np.zeros((len(pairs),), np.float32)
        try:
            pchaos.fault_point("queue.dispatch", peer=f"score-{worker}")
        except pchaos.ChaosInjected:
            sup.score_breaker.record_failure()
            return np.zeros((len(pairs),), np.float32)
        sup.score_breaker.record_success()
        return np.full((len(pairs),), REAL_SIM, np.float32)

    return sim


class Worker:
    """One fabric worker on a real socket, advertising its own URL."""

    def __init__(self, server, fabric, url):
        self.server, self.fabric, self.url = server, fabric, url

    @classmethod
    async def start(cls, cfg, store, worker_id, heartbeat=True):
        from cassmantle_tpu_torch.server.app import create_app
        from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor

        sup = ServingSupervisor()

        def factory(room, room_store):
            return Game(cfg, room_store, FakeContentBackend(image_size=16),
                        hash_embed, chaos_similarity(sup, worker_id),
                        supervisor=sup, room=room)

        fabric = RoomFabric(cfg, store, factory, worker_id=worker_id,
                            start_timers=False, heartbeat=heartbeat,
                            supervisor=sup)
        server = TestServer(create_app(fabric, cfg, start_timer=False))
        await server.start_server()
        url = f"http://127.0.0.1:{server.port}"
        fabric.membership.addr = url
        return cls(server, fabric, url)


async def _sync(workers):
    """One heartbeat each, then each rebuilds its ring and drains moves."""
    for w in workers:
        await w.fabric.membership.heartbeat(len(w.fabric._games))
    for w in workers:
        live = await w.fabric.membership.refresh()
        await w.fabric._handle_moves(w.fabric._apply_membership(live))


async def _pair(cfg=None, store=None):
    cfg = cfg or make_cfg()
    store = store or MemoryStore()
    a = await Worker.start(cfg, store, "w-a")
    b = await Worker.start(cfg, store, "w-b")
    await _sync([a, b])
    return cfg, store, a, b


async def _close(*workers):
    for w in workers:
        await w.server.close()


def test_redirect_to_the_owner_the_reference_ring_picks():
    import aiohttp

    async def run():
        cfg, store, a, b = await _pair()
        http = aiohttp.ClientSession()
        try:
            placement = a.fabric.directory.placement()
            ref = JRoomDirectory(room_ids(cfg), workers=["w-a", "w-b"],
                                 vnodes=cfg.fabric.vnodes).placement()
            assert placement == ref == b.fabric.directory.placement()
            b_rooms = [r for r, w in placement.items() if w == "w-b"]
            assert b_rooms and len(b_rooms) < len(placement)
            for room in b_rooms:
                res = await http.get(
                    a.url + "/fetch/contents",
                    params={"room": room, "session": "s-hop"},
                    allow_redirects=False)
                assert res.status == 307
                loc = res.headers["Location"]
                assert loc.startswith(b.url + "/fetch/contents?")
                assert f"room={room}" in loc and "session=s-hop" in loc
                assert "traceparent=00-" in loc and "tracesig=" in loc
            room = b_rooms[0]
            # /init redirects too, and starts no engine of the room here
            res = await http.get(a.url + "/init", params={"room": room},
                                 allow_redirects=False)
            assert res.status == 307 and room not in a.fabric._games
            # followed: the owner serves it, and one trace spans the hop
            q = {"room": room, "session": "s-hop"}
            res = await http.get(a.url + "/fetch/contents", params=q)
            assert res.status == 200 and str(res.url).startswith(b.url)
            mask = (await res.json())["prompt"]["masks"][0]
            res = await http.post(a.url + "/compute_score", params=q,
                                  json={"inputs": {str(mask): "storm"}})
            assert res.status == 200 and str(res.url).startswith(b.url)
            trace = res.headers["X-Trace-Id"]
            res = await http.get(a.url + "/debugz",
                                 params={"trace": trace, "scope": "cluster"})
            data = await res.json()
            assert {w: p["status"] for w, p in data["peers"].items()} == \
                {"w-a": "self", "w-b": "ok"}
            hops = {s["attrs"]["worker"]: s for s in data["spans"]
                    if s["name"] == "http.post /compute_score"}
            assert hops["w-a"]["attrs"]["status"] == 307
            assert hops["w-b"]["attrs"]["status"] == 200
            assert hops["w-b"]["parent_id"] == hops["w-a"]["span_id"]
            assert {s["trace_id"] for s in data["spans"]} == {trace}
            # a peer without an address: the room serves where it landed
            await store.hdel("fabric:workers", "w-b")
            b.fabric.membership.addr = ""
            await b.fabric.membership.heartbeat(0)
            await a.fabric.membership.refresh()
            res = await http.get(a.url + "/fetch/contents", params=q,
                                 allow_redirects=False)
            assert res.status == 200
        finally:
            await http.close()
            await _close(a, b)

    asyncio.run(run())


def test_hedge_when_chaos_darkens_the_local_scorer():
    import aiohttp

    async def run():
        cfg, store, a, b = await _pair()
        http = aiohttp.ClientSession()
        try:
            room = next(r for r, w in a.fabric.directory.placement().items()
                        if w == "w-a")
            q = {"room": room, "session": "hedge-s"}
            res = await http.get(a.url + "/fetch/contents", params=q)
            mask = str((await res.json())["prompt"]["masks"][0])
            pchaos.configure("seed=1;queue.dispatch=raise:peer=score-w-a")
            breaker = a.fabric.supervisor.score_breaker
            floors = 0
            while breaker.state != "open":
                res = await http.post(a.url + "/compute_score", params=q,
                                      json={"inputs": {mask: "wrong"}})
                assert res.status == 200 and "X-Score-Hedged" not in \
                    res.headers
                floors += 1
            assert floors == breaker.failure_threshold
            before = {k: metrics.counter_total(k) for k in (
                "score.hedge_success", "score.hedge_served",
                "score.hedge_attempts")}
            res = await http.post(a.url + "/compute_score", params=q,
                                  json={"inputs": {mask: "wrong2"}})
            assert res.status == 200
            assert res.headers.get("X-Score-Hedged") == "1"
            assert float((await res.json())[mask]) == pytest.approx(REAL_SIM)
            moved = {k: metrics.counter_total(k) - v
                     for k, v in before.items()}
            assert moved == {"score.hedge_success": 1,
                             "score.hedge_served": 1,
                             "score.hedge_attempts": 1}
            # both dark: w-b sheds the hedge 503 and w-a floors, marked
            pchaos.configure("seed=1;queue.dispatch=raise")
            while b.fabric.supervisor.score_breaker.state != "open":
                b.fabric.supervisor.score_breaker.record_failure()
            res = await http.post(a.url + "/compute_score", params=q,
                                  json={"inputs": {mask: "wrong3"}})
            assert res.status == 200
            assert res.headers.get("X-Score-Degraded") == "floor"
            assert "X-Score-Hedged" not in res.headers
            assert float((await res.json())[mask]) == pytest.approx(
                cfg.game.min_score)
        finally:
            await http.close()
            await _close(a, b)

    asyncio.run(run())


def test_hedge_skips_a_peer_advertising_overload():
    import aiohttp

    async def run():
        cfg, store, a, b = await _pair()
        http = aiohttp.ClientSession()
        try:
            await store.hset("fabric:workers", "w-b", json.dumps(
                {"addr": b.url, "rooms": 0, "t": time.time(), "shed": 1}))
            room = next(r for r, w in a.fabric.directory.placement().items()
                        if w == "w-a")
            q = {"room": room, "session": "skip-s"}
            res = await http.get(a.url + "/fetch/contents", params=q)
            mask = str((await res.json())["prompt"]["masks"][0])
            breaker = a.fabric.supervisor.score_breaker
            while breaker.state != "open":
                breaker.record_failure()
            skipped = metrics.counter_total("score.hedge_skipped_overloaded")
            attempts = metrics.counter_total("score.hedge_attempts")
            res = await http.post(a.url + "/compute_score", params=q,
                                  json={"inputs": {mask: "wrong"}})
            assert res.headers.get("X-Score-Degraded") == "floor"
            assert metrics.counter_total(
                "score.hedge_skipped_overloaded") == skipped + 1
            assert metrics.counter_total("score.hedge_attempts") == attempts
        finally:
            await http.close()
            await _close(a, b)

    asyncio.run(run())


def _exact_lines(text):
    return sorted(line for line in text.splitlines()
                  if not line.startswith("#")
                  and (_metric_of(line).endswith(("_total", "_count",
                                                  "_sum"))
                       or "_bucket{" in line))


def test_exact_federation_and_marked_peers():
    import aiohttp

    async def run():
        cfg, store, a, b = await _pair()
        http = aiohttp.ClientSession()
        try:
            room = next(r for r, w in a.fabric.directory.placement().items()
                        if w == "w-b")
            q = {"room": room, "session": "fed"}
            res = await http.get(a.url + "/fetch/contents", params=q)
            mask = str((await res.json())["prompt"]["masks"][0])
            await http.post(a.url + "/compute_score", params=q,
                            json={"inputs": {mask: "storm"}})
            sa = await (await http.get(a.url + "/metrics",
                                       params={"format": "state"})).json()
            sb = await (await http.get(b.url + "/metrics",
                                       params={"format": "state"})).json()
            assert (sa["worker"], sb["worker"]) == ("w-a", "w-b")
            res = await http.get(a.url + "/metrics",
                                 params={"scope": "cluster"},
                                 headers={"Accept": "text/plain"})
            got = await res.text()
            want = plogging.merge_states([("w-a", sa["state"]),
                                          ("w-b", sb["state"])]).prometheus()
            assert _exact_lines(got) == _exact_lines(want)
            assert 'cassmantle_federation_peer_up{worker="w-b"} 1' in got
            # the reference's merge of the port's states reads the same
            assert _exact_lines(got) == _exact_lines(jlogging.merge_states(
                [("w-a", sa["state"]), ("w-b", sb["state"])]).prometheus())
            # stale and dark peers are marked, never dropped
            await store.hset("fabric:workers", "w-stale", json.dumps(
                {"addr": "http://127.0.0.1:1", "rooms": 0,
                 "t": time.time() - 9999}))
            await store.hset("fabric:workers", "w-dark", json.dumps(
                {"addr": "http://127.0.0.1:9", "rooms": 0,
                 "t": time.time()}))
            snap = await (await http.get(a.url + "/metrics",
                                         params={"scope": "cluster"})).json()
            fed = snap["federation"]
            assert fed["w-a"] == {"status": "self"}
            assert fed["w-b"] == {"status": "ok"}
            assert fed["w-stale"]["status"] == "stale"
            assert fed["w-dark"]["status"] == "error"
            assert snap["gauges"]['federation.peer_up{worker="w-dark"}'] \
                == 0.0
            # a worker-scoped partition marks exactly that peer
            pchaos.configure("seed=1;fabric.peer_http=partition:peer=w-b")
            snap = await (await http.get(a.url + "/metrics",
                                         params={"scope": "cluster"})).json()
            assert snap["federation"]["w-b"]["status"] == "error"
            pchaos.disarm()
        finally:
            await http.close()
            await _close(a, b)

    asyncio.run(run())


def test_handoff_waits_for_the_peer_to_adopt():
    """w-b leaves gracefully: its rooms drain, and handoff returns once
    w-a's heartbeat has rebuilt w-a's ring without w-b (every room w-a's,
    within the grace); the adopted room keeps its round."""
    import aiohttp

    async def run():
        cfg = make_cfg(heartbeat_s=0.2, ttl_s=2.0, grace_s=3.0)
        store = MemoryStore()
        a = await Worker.start(cfg, store, "w-a")
        b = await Worker.start(cfg, store, "w-b")
        http = aiohttp.ClientSession()
        try:
            await _sync([a, b])        # the apps' heartbeat loops run too
            b_rooms = [r for r, w in a.fabric.directory.placement().items()
                       if w == "w-b"]
            room = b_rooms[0]
            q = {"room": room, "session": "adopt"}
            res = await http.get(b.url + "/fetch/contents", params=q)
            prompt = (await res.json())["prompt"]
            assert room in b.fabric._games
            t0 = time.monotonic()
            await b.fabric.handoff()
            took = time.monotonic() - t0
            assert took < cfg.fabric.handoff_grace_s
            assert not b.fabric._games
            assert set(a.fabric.directory.placement().values()) == {"w-a"}
            assert "w-b" not in await a.fabric.membership.refresh()
            res = await http.get(a.url + "/fetch/contents", params=q,
                                 allow_redirects=False)
            assert res.status == 200
            assert (await res.json())["prompt"] == prompt
        finally:
            await http.close()
            await _close(a, b)

    asyncio.run(run())


def test_prober_walks_every_live_peer_through_its_listener():
    from cassmantle_tpu_torch.obs.prober import CanaryProber

    async def run():
        cfg, store, a, b = await _pair()
        prober = CanaryProber(a.fabric, cfg, self_addr=a.url)
        seen = []
        played = prober._play

        async def recorded(addr, span):
            seen.append(addr)
            return await played(addr, span)

        prober._play = recorded
        try:
            await prober.probe_all()
            block = prober.status_block()
        finally:
            await prober.close()
            await _close(a, b)
        assert seen == [a.url, b.url]
        assert block["ok"] is True
        assert set(block["targets"]) == {"w-a", "w-b"}
        assert all(v["ok"] for v in block["targets"].values())

    asyncio.run(run())


# -- serve --workers 2 as processes ------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get_json(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as res:
        return json.load(res)


def test_serve_two_workers_share_one_port_and_one_generator(tmp_path):
    """Two processes answer on one port (each connection lands on one of
    them), the shared store's round locks let one of them generate each
    round (the workers' generations sum to the rounds the store counted,
    plus at most a buffered next), and a SIGKILLed worker is counted."""
    node = spawn_server(0)
    port = _free_port()
    log_path = tmp_path / "serve.log"
    cmd = [sys.executable, "-m", "cassmantle_tpu_torch", "serve", "--fake",
           "--workers", "2", "--store", f"native:{node.port}",
           "--round-seconds", "2", "--host", "127.0.0.1",
           "--port", str(port)]
    env = dict(os.environ, PYTHONPATH=REPO, CASSMANTLE_NO_PROBER="1")
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        states, errors, deadline = {}, [], time.monotonic() + 90
        while len(states) < 2 and time.monotonic() < deadline:
            assert proc.poll() is None, log_path.read_text()[-3000:]
            try:
                got = _get_json(base + "/metrics?format=state")
            except OSError as exc:         # not listening yet, or booting
                errors.append(repr(exc))
                time.sleep(0.2)
                continue
            states[got["worker"]] = got["state"]
        assert len(states) == 2, (errors[-3:], log_path.read_text()[-3000:])
        pids = {int(w.rsplit(":", 1)[1]) for w in states}
        assert proc.pid in pids
        (child,) = pids - {proc.pid}
        time.sleep(5.0)                      # two rounds turn

        async def episode():
            c = MantleStore(port=node.port)
            try:
                raw = await c.hget("story", "episode")
                return int(raw or 0)
            finally:
                await c.close()

        def generations():
            """{worker: generations}, read until both answered."""
            seen = {}
            while len(seen) < 2:
                got = _get_json(base + "/metrics?format=state")
                seen[got["worker"]] = sum(
                    h[5] for h in got["state"]["hists"]
                    if h[0] == "round.generate_s")
            return seen

        for _ in range(20):
            e0 = asyncio.run(episode())
            gens = generations()
            if asyncio.run(episode()) == e0:
                break
        assert e0 >= 2
        assert e0 <= sum(gens.values()) <= e0 + 1, (e0, gens)
        os.kill(child, signal.SIGKILL)
        deaths, deadline = 0.0, time.monotonic() + 20
        while deaths < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
            deaths = _get_json(base + "/metrics")["counters"].get(
                "server.worker_deaths", 0.0)
        assert deaths == 1.0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) in (0, -signal.SIGINT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        node.kill()
        node.wait()
