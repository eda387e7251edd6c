"""The port's replicated store (``engine/store.py::ReplicatedStore``) held
against the reference's.

Each package's ``ReplicatedStore`` runs a game over a leader and a
follower of the port's mantlestore build (``--repl`` / ``--follower``, a
500 ms lease, ports the kernel picked): the leader is killed mid-round,
the follower is promoted within the failover grace (two leases and 3 s),
and the round, the image and the session's scores survive; both packages
give the same outcome. Sixteen sessions guessing at once across the kill
are all answered (the reference's client writes to the dead leader's
closed connection there and raises AttributeError). Beside it: a
follower refuses writes until it is promoted, the pump's fault point
counts and recovers, and ``close()`` ends a pump that swallows a cancel.
"""

import asyncio
import dataclasses
import time

import pytest

import cassmantle_tpu.config as jconfig
import cassmantle_tpu.engine.content as jcontent
import cassmantle_tpu.engine.game as jgame
import cassmantle_tpu.engine.store as jstore
import cassmantle_tpu_torch.config as pconfig
import cassmantle_tpu_torch.engine.content as pcontent
import cassmantle_tpu_torch.engine.game as pgame
import cassmantle_tpu_torch.engine.store as pstore
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.native.client import MantleStore, spawn_server
from cassmantle_tpu_torch.utils.logging import metrics

PACKAGES = {"reference": (jconfig, jcontent, jgame, jstore),
            "port": (pconfig, pcontent, pgame, pstore)}
LEASE_MS = 500


@pytest.fixture
def pair():
    """A leader and a follower with a 500 ms lease; killed at the end."""
    leader = spawn_server(0, repl=True, repl_id="A", lease_ms=LEASE_MS)
    follower = spawn_server(0, follower=True, repl_id="B", lease_ms=LEASE_MS)
    yield leader, follower
    for proc in (leader, follower):
        proc.kill()
        proc.wait()


async def _caught_up(leader_port, follower_port, timeout_s=5.0):
    lc, fc = MantleStore(port=leader_port), MantleStore(port=follower_port)
    try:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            _, lend, _ = await lc.repl_offset()
            _, _, fapp = await fc.repl_offset()
            if fapp >= lend:
                return True
            await asyncio.sleep(0.02)
        return False
    finally:
        await lc.close()
        await fc.close()


async def _leader_kill(package, leader, follower):
    config, content, game_mod, store_mod = PACKAGES[package]
    store = store_mod.ReplicatedStore([leader.port, follower.port],
                                      poll_interval_s=0.02,
                                      lease_timeout_s=LEASE_MS / 1000.0)
    try:
        await store.start()
        cfg = config.test_config()
        cfg = cfg.replace(game=dataclasses.replace(cfg.game,
                                                   time_per_prompt=60.0))
        game = game_mod.Game(cfg, store,
                             content.FakeContentBackend(image_size=32),
                             content.hash_embed, content.hash_similarity)
        await game.startup()
        prompt = await game.rounds.fetch_current_prompt()
        image = await game.rounds.fetch_current_image_bytes()
        masks = prompt["masks"]
        await game.init_client("p1")
        first = await game.compute_client_scores(
            "p1", {str(masks[0]): prompt["tokens"][masks[0]]})
        assert await _caught_up(leader.port, follower.port)
        leader.kill()
        leader.wait()
        # a guess in flight across the kill is answered on the follower
        t0 = time.monotonic()
        in_flight = await game.compute_client_scores(
            "p1", {str(masks[1]): "zzq"})
        failover_s = time.monotonic() - t0
        after = await game.rounds.fetch_current_prompt()
        scores = await game.sessions.fetch_scores("p1")
        won = await game.compute_client_scores(
            "p1", {str(m): prompt["tokens"][m] for m in masks[1:]})
        status = store.status()
        return {
            "first": float(first[str(masks[0])]),
            "in_flight_answered": str(masks[1]) in in_flight,
            "same_prompt": after == prompt,
            "same_image":
                await game.rounds.fetch_current_image_bytes() == image,
            "kept_score": float(scores[str(masks[0])]),
            "won": won["won"],
            "leader": status["leader"] == f"127.0.0.1:{follower.port}",
            "failovers": status["failovers"],
            "within_grace": failover_s < store.failover_grace_s,
        }
    finally:
        await store.close()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_leader_kill_midround_promotes_follower_and_keeps_state(package,
                                                                pair):
    """Both packages' stores come through the same kill the same way."""
    got = asyncio.run(_leader_kill(package, *pair))
    assert got == {"first": 1.0, "in_flight_answered": True,
                   "same_prompt": True, "same_image": True,
                   "kept_score": 1.0, "won": 1, "leader": True,
                   "failovers": 1, "within_grace": True}


def test_failover_grace_is_two_leases_and_three_seconds():
    for lease in (0.5, 3.0):
        assert pstore.ReplicatedStore([1], lease_timeout_s=lease
                                      ).failover_grace_s == 2 * lease + 3
        assert pstore.ReplicatedStore([1], lease_timeout_s=lease
                                      ).failover_grace_s == \
            jstore.ReplicatedStore([1], lease_timeout_s=lease
                                   ).failover_grace_s


def test_follower_rejects_writes_until_promoted(pair):
    leader, follower = pair

    async def run():
        f = MantleStore(port=follower.port)
        with pytest.raises(RuntimeError, match="READONLY"):
            await f.set("x", "y")
        rs = pstore.ReplicatedStore([leader.port, follower.port],
                                    poll_interval_s=0.02,
                                    lease_timeout_s=LEASE_MS / 1000.0)
        await rs.start()
        await rs.set("seed", "1")
        assert await _caught_up(leader.port, follower.port)
        # promotion is refused while the replicated lease is live
        assert await f.repl_promote() is False
        holder, remaining = await f.repl_lease()
        assert holder == "A" and remaining > 0
        with pytest.raises(RuntimeError, match="READONLY"):
            await f.set("x", "y")
        await rs.close()
        leader.kill()
        leader.wait()
        # the lease lapses; then the follower takes leadership and writes
        deadline = time.monotonic() + 3 * LEASE_MS / 1000.0 + 2.0
        promoted = False
        while not promoted and time.monotonic() < deadline:
            promoted = await f.repl_promote()
            await asyncio.sleep(0.05)
        assert promoted
        await f.set("x", "y")
        assert await f.get("x") == b"y"
        assert await f.get("seed") == b"1"
        await f.close()

    asyncio.run(run())


def test_pump_fault_point_counts_and_recovers(pair):
    """``repl.pump`` raising twice counts two pump errors; shipping goes
    on after them and the follower catches up."""
    leader, follower = pair

    async def run():
        pchaos.configure("seed=3;repl.pump=raise:times=2")
        rs = pstore.ReplicatedStore([leader.port, follower.port],
                                    poll_interval_s=0.02,
                                    lease_timeout_s=LEASE_MS / 1000.0)
        before = metrics.counter_total("repl.pump_errors")
        try:
            await rs.start()
            await rs.set("k", "v")
            assert await _caught_up(leader.port, follower.port)
            assert metrics.counter_total("repl.pump_errors") - before == 2
            assert rs.status()["shipped"] > 0
        finally:
            pchaos.disarm()
            await rs.close()

    asyncio.run(run())


def test_close_lands_when_the_pump_swallows_a_cancel():
    """``close()`` re-delivers the cancel until the pump ends. The pump
    stub swallows the first CancelledError: it is started (one pass of
    the loop) before close(), so the cancel reaches its ``try`` (a task
    cancelled before it first runs never enters it, and would prove
    nothing)."""

    async def run():
        rs = pstore.ReplicatedStore([7070], pump=False)
        swallowed, entered = [0], asyncio.Event()

        async def stubborn_pump():
            while True:
                try:
                    entered.set()
                    await asyncio.sleep(3600)
                except asyncio.CancelledError:
                    if swallowed[0] == 0:
                        swallowed[0] += 1
                        continue
                    raise

        task = asyncio.get_running_loop().create_task(stubborn_pump())
        rs._pump_task = task
        await asyncio.sleep(0)
        assert entered.is_set()
        await asyncio.wait_for(rs.close(), timeout=5.0)
        assert swallowed[0] == 1
        assert task.done() and task.cancelled()
        assert rs._pump_task is None

    asyncio.run(run())


async def _burst_across_kill(package, leader, follower, players=16):
    """``players`` sessions guess at once, over and over, while the leader
    is killed; returns (answered, failures by exception type)."""
    config, content, game_mod, store_mod = PACKAGES[package]
    store = store_mod.ReplicatedStore([leader.port, follower.port],
                                      poll_interval_s=0.02,
                                      lease_timeout_s=LEASE_MS / 1000.0)
    try:
        await store.start()
        cfg = config.test_config()
        cfg = cfg.replace(game=dataclasses.replace(cfg.game,
                                                   time_per_prompt=60.0))
        game = game_mod.Game(cfg, store,
                             content.FakeContentBackend(image_size=32),
                             content.hash_embed, content.hash_similarity)
        await game.startup()
        masks = (await game.rounds.fetch_current_prompt())["masks"]
        answered, failures, stop = [0], {}, asyncio.Event()

        async def player(i):
            await game.init_client(f"p{i}")
            n = 0
            while not stop.is_set():
                n += 1
                try:
                    await game.compute_client_scores(
                        f"p{i}", {str(masks[0]): f"w{i}x{n}"})
                    answered[0] += 1
                except Exception as exc:
                    name = type(exc).__name__
                    failures[name] = failures.get(name, 0) + 1
                await asyncio.sleep(0.005)

        tasks = [asyncio.ensure_future(player(i)) for i in range(players)]
        await asyncio.sleep(0.3)
        leader.kill()
        leader.wait()
        deadline = time.monotonic() + store.failover_grace_s
        while store.status()["leader"] != f"127.0.0.1:{follower.port}" \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.3)
        stop.set()
        await asyncio.gather(*tasks)
        return answered[0], failures
    finally:
        await store.close()


def test_every_guess_in_flight_across_the_kill_is_answered(pair):
    """Sixteen sessions guess at once across the leader kill: every guess
    is answered. The commands queued on the dead leader's connection when
    a failed round trip closes it redial (a refused connection, so the
    store elects again) instead of writing to the closed connection."""
    answered, failures = asyncio.run(_burst_across_kill("port", *pair))
    assert answered > 0 and failures == {}
