"""The port's room fabric (``cassmantle_tpu_torch/fabric/``), the path of
one worker, held against the reference's (``cassmantle_tpu/fabric/``).

The same scripts run on both packages' ``MemoryStore`` and fakes
(``FakeContentBackend``, ``hash_embed``, ``hash_similarity``):
``NamespacedStore`` (every verb and the room-scoped lock, and the keys it
leaves in the shared store), ``room_prefix`` and ``room_ids``, the
directory's session -> room and room -> worker placement and its moves,
membership heartbeats under an injected clock (staleness, leave), the
cluster key's trace signatures and bearer token, and ``RoomFabric``:
startup of the default room, two rooms with their own content,
``rotate_room``, ``drain_room``, ``game_for`` of an unknown room, the
probe game apart from the rooms, the readiness block, the handoff with
no peers and the shutdown.
"""

import asyncio
import dataclasses

import pytest

import cassmantle_tpu.config as jconfig
import cassmantle_tpu.engine.content as jcontent
import cassmantle_tpu.engine.game as jgame
import cassmantle_tpu.engine.store as jstore
import cassmantle_tpu.fabric.directory as jdirectory
import cassmantle_tpu.fabric.membership as jmembership
import cassmantle_tpu.fabric.rooms as jrooms
import cassmantle_tpu_torch.config as pconfig
import cassmantle_tpu_torch.engine.content as pcontent
import cassmantle_tpu_torch.engine.game as pgame
import cassmantle_tpu_torch.engine.store as pstore
import cassmantle_tpu_torch.fabric.directory as pdirectory
import cassmantle_tpu_torch.fabric.membership as pmembership
import cassmantle_tpu_torch.fabric.rooms as prooms

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

REF = dict(config=jconfig, content=jcontent, game=jgame, store=jstore,
           directory=jdirectory, membership=jmembership, rooms=jrooms)
PORT = dict(config=pconfig, content=pcontent, game=pgame, store=pstore,
            directory=pdirectory, membership=pmembership, rooms=prooms)


def both(script):
    """(reference result, port result) of ``script(modules)``."""
    return script(REF), script(PORT)


def make_cfg(m, num_rooms=2):
    cfg = m["config"].test_config()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=30.0),
        fabric=dataclasses.replace(cfg.fabric, num_rooms=num_rooms))


def make_fabric(m, cfg, store=None, **kw):
    store = store or m["store"].MemoryStore()
    c = m["content"]

    def factory(room, room_store):
        return m["game"].Game(cfg, room_store,
                              c.FakeContentBackend(image_size=32),
                              c.hash_embed, c.hash_similarity)

    kw.setdefault("start_timers", False)
    kw.setdefault("heartbeat", False)
    return m["rooms"].RoomFabric(cfg, store, factory, **kw)


def _namespaced_script(m):
    async def run():
        base = m["store"].MemoryStore()
        a = m["rooms"].NamespacedStore(base, "room:a:")
        b = m["rooms"].NamespacedStore(base, "")
        out = []
        await a.set("k", "va")
        await b.set("k", "vb")
        out += [await a.get("k"), await b.get("k"), await a.exists("k"),
                await a.exists("nope")]
        await a.setex("t", 30.0, 1)
        out.append(round(await a.ttl("t")))
        await a.expire("k", 50.0)
        out.append(round(await a.ttl("k")))
        await a.hset("h", "f", "1")
        await a.hset("h", mapping={"g": "2", "x": "y"})
        out += [await a.hget("h", "f"), sorted((await a.hgetall("h")).items()),
                await a.hincrby("h", "f", 5)]
        await a.hdel("h", "x")
        out.append(sorted(await a.hgetall("h")))
        await a.sadd("s", "p", "q", "r")
        await a.srem("s", "q")
        out += [sorted(await a.smembers("s")), await a.sismember("s", "p"),
                await a.sismember("s", "q")]
        # the lock is the room's: a's lock does not exclude b's
        async with a.lock("L", timeout=5.0, blocking_timeout=0.1):
            async with b.lock("L", timeout=5.0, blocking_timeout=0.1):
                out.append("both held")
            try:
                async with a.lock("L", timeout=5.0, blocking_timeout=0.05):
                    out.append("twice")
            except m["store"].LockTimeout:
                out.append("excluded")
        await a.delete("k", "t")
        out += [await a.get("k"), await b.get("k")]
        await a.close()            # a view never closes the shared store
        out.append(await base.get("k"))
        out.append(sorted(k for k in base._data))
        return out

    return asyncio.run(run())


def test_namespaced_store_matches_reference():
    ref, port = both(_namespaced_script)
    assert port == ref
    assert "excluded" in port and "both held" in port


@pytest.mark.parametrize("num_rooms", [1, 3, 8])
def test_room_ids_and_prefixes_match_reference(num_rooms):
    ref, port = both(lambda m: (
        m["rooms"].room_ids(make_cfg(m, num_rooms)),
        [m["rooms"].room_prefix(r, "lobby")
         for r in m["rooms"].room_ids(make_cfg(m, num_rooms))]))
    assert port == ref
    assert port[1][0] == ""


def _directory_script(m):
    rooms = ["lobby"] + [f"room-{i}" for i in range(1, 12)]
    d = m["directory"].RoomDirectory(rooms, workers=["w-a"], vnodes=16)
    out = [[d.room_for_session(f"s{i}") for i in range(200)],
           d.placement(), d.rooms_owned_by("w-a"), d.has_room("room-3"),
           d.has_room("room-99")]
    moves = d.set_workers(["w-a", "w-b", "w-c"])
    out += [sorted(moves.items()), d.placement(), d.workers(),
            d.set_workers(["w-c", "w-b", "w-a"])]
    out.append(sorted(d.set_workers(["w-b"]).items()))
    out.append(m["directory"].RoomDirectory(rooms).worker_for_room("lobby"))
    return out


def test_directory_placement_matches_reference():
    ref, port = both(_directory_script)
    assert port == ref


def _membership_script(m):
    async def run():
        now = [1000.0]
        store = m["store"].MemoryStore()
        mine = m["membership"].ClusterMembership(
            store, "w-a", addr="http://127.0.0.1:1", ttl_s=6.0,
            clock=lambda: now[0])
        other = m["membership"].ClusterMembership(
            store, "w-b", addr="", ttl_s=6.0, clock=lambda: now[0])
        out = [await mine.heartbeat(2, extra={"shed": False, "btier": 0})]
        now[0] += 4.0
        out.append(await other.heartbeat(1))
        now[0] += 3.0          # w-a is 7 s old: stale
        out.append(await mine.refresh())
        out.append(await mine.table())
        out += [mine.live_workers(), mine.addr_of("w-b"),
                mine.addr_of("w-a")]
        await other.leave()
        out.append(await mine.refresh())
        return out

    return asyncio.run(run())


def test_membership_matches_reference():
    ref, port = both(_membership_script)
    assert port == ref


def _signature_script(m):
    async def run():
        store = m["store"].MemoryStore()
        await store.set("fabric:cluster_key", "k" * 64)
        cfg = make_cfg(m, 1)
        fabric = make_fabric(m, cfg, store=store, heartbeat=True,
                             worker_id="w-a")
        before = (fabric.sign_trace("tp"), fabric.cluster_token())
        await fabric._ensure_cluster_key()
        tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
        sig = fabric.sign_trace(tp)
        out = [before, sig, fabric.verify_trace_sig(tp, sig),
               fabric.verify_trace_sig(tp, "0" * 32),
               fabric.cluster_token(),
               fabric.verify_cluster_token(fabric.cluster_token()),
               fabric.verify_cluster_token("nope")]
        # a store without the key gets one minted, and converges on it
        fresh = make_fabric(m, cfg, heartbeat=True)
        await fresh._ensure_cluster_key()
        key = await fresh.store.get("fabric:cluster_key")
        out.append(len(key))
        return out

    return asyncio.run(run())


def test_cluster_signatures_match_reference():
    ref, port = both(_signature_script)
    assert port == ref
    assert port[0] == (None, None) and port[2] and not port[3]


def _scrub(status):
    status = dict(status)
    status["workers"] = sorted(status["workers"])
    return status


def _fabric_script(m):
    async def run():
        cfg = make_cfg(m, 2)
        fabric = make_fabric(m, cfg, worker_id="w-a")
        out = []
        await fabric.startup()
        out.append(_scrub(fabric.status()))
        lobby = await fabric.game_for("lobby")
        room1 = await fabric.game_for("room-1")
        pa = await lobby.rounds.fetch_current_prompt()
        pb = await room1.rounds.fetch_current_prompt()
        out += [pa, pb, pa["tokens"] != pb["tokens"]]
        try:
            await fabric.game_for("room-9")
        except KeyError as exc:
            out.append(("KeyError", str(exc)))
        out += [fabric.is_local("room-1"), fabric.owner_addr("room-1"),
                fabric.owned_rooms()]
        # rotation: the buffered round becomes current, the clock restarts
        await lobby.rounds.buffer_contents()
        nxt = await lobby.rounds.store.hget("prompt", "next")
        await fabric.rotate_room("lobby")
        out.append((await lobby.rounds.store.hget("prompt", "current"))
                   == nxt)
        out.append(await lobby.rounds.reset_flag())
        probe = fabric.probe_game()
        out += [probe is fabric.probe_game(), probe.store.prefix,
                sorted(fabric.status()["active"])]
        await fabric.drain_room("room-1")
        out.append(_scrub(fabric.status()))
        # handoff with no peers: draining, rooms released, idempotent
        await fabric.handoff()
        await fabric.handoff()
        out += [fabric.draining, _scrub(fabric.status())]
        await fabric.shutdown()
        return out

    return asyncio.run(run())


def test_room_fabric_matches_reference():
    ref, port = both(_fabric_script)
    assert port == ref
    assert port[3] is True         # two rooms, two prompts


def _legacy_wrap_script(m):
    async def run():
        cfg = make_cfg(m, 3)
        c = m["content"]
        game = m["game"].Game(cfg, m["store"].MemoryStore(),
                              c.FakeContentBackend(image_size=32),
                              c.hash_embed, c.hash_similarity)
        fabric = m["rooms"].RoomFabric.for_game(game, cfg,
                                                start_timers=False)
        await fabric.startup()
        out = [fabric.directory.rooms(), await fabric.game_for("lobby")
               is game, fabric.supervisor is game.supervisor,
               _scrub(fabric.status())]
        await fabric.shutdown()
        return out

    return asyncio.run(run())


def test_for_game_wrap_matches_reference():
    ref, port = both(_legacy_wrap_script)
    assert port == ref
    assert port[0] == ["lobby"] and port[1] and port[2]


def test_fabric_stops_its_services_at_shutdown():
    """The port's addition: a serving component handed to the fabric
    stops after the rooms drain."""
    stopped = []

    class Service:
        async def stop(self):
            stopped.append(True)

    cfg = make_cfg(PORT, 1)
    fabric = make_fabric(PORT, cfg)
    fabric.services.append(Service())

    async def run():
        await fabric.startup()
        await fabric.shutdown()

    asyncio.run(run())
    assert stopped == [True] and fabric.device is None
