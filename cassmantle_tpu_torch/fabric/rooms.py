"""Room fabric: per-room game engines over namespaced store views.

A copy of ``cassmantle_tpu/fabric/rooms.py``. A **room** is a whole game
(its clock, content, sessions and scores) under a per-room key prefix of
the shared store; :class:`RoomFabric` builds one
:class:`~cassmantle_tpu_torch.engine.game.Game` per room it owns on first
use (all sharing the worker's serving stack, so the rooms' rounds funnel
into the one device path), heartbeats membership, drains the rooms the
ring moves to a peer when membership changes, and on a graceful handoff
leaves, drains and waits (``FabricConfig.handoff_grace_s``) until every
live peer has heartbeated past the departure, i.e. adopted its rooms.
The **default room** maps to the empty prefix: a one-room fabric is the
classic game, key for key. The cluster key (``fabric:cluster_key`` in
the store) signs traceparents carried across a redirect and derives the
peers' bearer token. Serving components with an async ``stop()``
(``services``) stop at shutdown, after the rooms drain.

The fabric's own state (the room -> game map, startup tasks) is touched
only from the serving event loop; the thread-locked pieces are the
directory ring, the replication status snapshot and the membership
cache.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
from typing import Callable, Dict, List, Optional

from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.engine.game import Game
from cassmantle_tpu_torch.engine.store import StateStore
from cassmantle_tpu_torch.fabric.directory import RoomDirectory
from cassmantle_tpu_torch.fabric.membership import ClusterMembership
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("fabric.rooms")


class NamespacedStore(StateStore):
    """A per-room view of a shared store: every key (and lock name)
    carries the room prefix, so N rooms coexist in one store without
    the engine knowing. ``close`` is a no-op — the underlying store is
    shared and the fabric closes it exactly once at shutdown."""

    def __init__(self, store: StateStore, prefix: str) -> None:
        self._store = store
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return self.prefix + key

    async def set(self, key, value):
        return await self._store.set(self._k(key), value)

    async def get(self, key):
        return await self._store.get(self._k(key))

    async def setex(self, key, ttl, value):
        return await self._store.setex(self._k(key), ttl, value)

    async def delete(self, *keys):
        return await self._store.delete(*[self._k(k) for k in keys])

    async def exists(self, key):
        return await self._store.exists(self._k(key))

    async def expire(self, key, ttl):
        return await self._store.expire(self._k(key), ttl)

    async def ttl(self, key):
        return await self._store.ttl(self._k(key))

    async def hset(self, key, field=None, value=None, mapping=None):
        return await self._store.hset(self._k(key), field=field,
                                      value=value, mapping=mapping)

    async def hget(self, key, field):
        return await self._store.hget(self._k(key), field)

    async def hgetall(self, key):
        return await self._store.hgetall(self._k(key))

    async def hdel(self, key, *fields):
        return await self._store.hdel(self._k(key), *fields)

    async def hincrby(self, key, field, amount: int = 1):
        return await self._store.hincrby(self._k(key), field, amount)

    async def sadd(self, key, *members):
        return await self._store.sadd(self._k(key), *members)

    async def srem(self, key, *members):
        return await self._store.srem(self._k(key), *members)

    async def smembers(self, key):
        return await self._store.smembers(self._k(key))

    async def sismember(self, key, member):
        return await self._store.sismember(self._k(key), member)

    def lock(self, name: str, timeout: float = 120.0,
             blocking_timeout: float = 2.0):
        # room-scoped locks: each room's startup/buffer/promotion
        # lifecycle excludes per room, not globally
        return self._store.lock(self._k(name), timeout=timeout,
                                blocking_timeout=blocking_timeout)

    async def close(self) -> None:
        pass


def room_prefix(room: str, default_room: str) -> str:
    """Store key prefix for a room ('' = the legacy un-roomed keys)."""
    return "" if room == default_room else f"room:{room}:"


def room_ids(cfg: FrameworkConfig) -> List[str]:
    fabric = cfg.fabric
    return [fabric.default_room] + [
        f"room-{i}" for i in range(1, max(1, fabric.num_rooms))
    ]


class RoomFabric:
    """The per-worker fabric runtime: room→game map, membership
    heartbeats, ownership-change draining."""

    def __init__(
        self,
        cfg: FrameworkConfig,
        store: StateStore,
        game_factory: Callable[[str, StateStore], Game],
        *,
        worker_id: str = "worker-0",
        advertise_addr: str = "",
        start_timers: bool = True,
        heartbeat: bool = True,
        supervisor=None,
    ) -> None:
        self.cfg = cfg
        self.store = store
        self.game_factory = game_factory
        self.worker_id = worker_id
        self.start_timers = start_timers
        # ONE supervisor per worker, shared by every room's game (and
        # by the inference service behind them): /readyz fuses a single
        # worker-level verdict, not a per-room one
        if supervisor is None:
            from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor

            supervisor = ServingSupervisor()
        self.supervisor = supervisor
        self.supervisor.fabric_status = self.status
        self.default_room = cfg.fabric.default_room
        self.directory = RoomDirectory(
            room_ids(cfg), workers=[worker_id], vnodes=cfg.fabric.vnodes)
        self.membership = ClusterMembership(
            store, worker_id, addr=advertise_addr,
            ttl_s=cfg.fabric.membership_ttl_s)
        self._heartbeat_enabled = heartbeat
        self._cluster_key: Optional[bytes] = None
        self._games: Dict[str, Game] = {}
        self._startups: Dict[str, asyncio.Task] = {}
        self._hb_task: Optional[asyncio.Task] = None
        self._draining = False
        # canary probe engine: built lazily, NEVER in
        # _games — invisible to the directory ring, placement answers,
        # heartbeat room counts, and fabric.rooms_created
        self._probe_game: Optional[Game] = None
        self._legacy_game: Optional[Game] = None
        # serving components with an async stop() (an InferenceService's
        # queues, the drill scorer's): stopped at shutdown
        self.services: List[object] = []
        # the serving stack's device (server/app.py build_fabric); None
        # for a fake backend
        self.device = None

    # -- legacy wrap -------------------------------------------------------
    @classmethod
    def for_game(cls, game: Game, cfg: FrameworkConfig,
                 start_timers: bool = True) -> "RoomFabric":
        """Wrap one pre-built Game as a single-room fabric — the shim
        that keeps ``create_app(game, cfg)`` and every existing caller
        working unchanged (the game IS the default room). The wrap is
        pinned to ONE room regardless of ``cfg.fabric.num_rooms``:
        multi-room serving must come through a per-room game factory
        (build_fabric) — routing a second room id onto the one shared
        Game would re-run its startup and stack a second round clock."""
        import dataclasses

        cfg = cfg.replace(fabric=dataclasses.replace(
            cfg.fabric, num_rooms=1))
        fabric = cls(cfg, game.store, lambda room, store: game,
                     start_timers=start_timers, heartbeat=False,
                     supervisor=game.supervisor)
        fabric._games[fabric.default_room] = game
        # the wrap's factory ignores its store argument (it returns the
        # one pre-built game), so probe_game() must derive a separate
        # probe engine from this game's parts instead
        fabric._legacy_game = game
        return fabric

    # -- ownership ---------------------------------------------------------
    def is_local(self, room: str) -> bool:
        owner = self.directory.worker_for_room(room)
        return owner is None or owner == self.worker_id

    def owner_addr(self, room: str) -> Optional[str]:
        """Advertised address of the room's owner (None when unknown or
        local — callers redirect only on a real remote address)."""
        owner = self.directory.worker_for_room(room)
        if owner is None or owner == self.worker_id:
            return None
        return self.membership.addr_of(owner)

    def owned_rooms(self) -> List[str]:
        return self.directory.rooms_owned_by(self.worker_id)

    def peer_hosts(self) -> set:
        """Hostnames of every live member's advertised address (plus
        our own advertise) — one leg of the trust set for inbound
        cross-worker observability (server/app.py ``_is_cluster_peer``;
        exact-match only, so fleets advertising DNS names or NATed
        egress rely on the cluster-secret leg below instead).
        Membership rows come from the shared store, which cluster
        workers already trust for round state itself."""
        from urllib.parse import urlsplit

        addrs = [info.get("addr")
                 for info in self.membership.live_workers().values()]
        addrs.append(self.membership.addr)
        hosts = set()
        for addr in addrs:
            if not addr:
                continue
            try:
                host = urlsplit(addr).hostname
            except ValueError:
                continue
            if host:
                hosts.add(host)
        return hosts

    # -- cluster secret (cross-worker observability trust) -----------------
    # The store distributes one random secret per cluster: a cross-
    # worker 307 pins tracesig=HMAC(secret, traceparent) next to the
    # trace context, so the owner worker can honor a context carried
    # BACK by an untrusted client (the redirect channel — the bearer's
    # IP proves nothing), and peer fan-outs authenticate with a
    # secret-derived bearer token instead of IP matching (which breaks
    # under DNS-advertised addresses or NATed egress). Trust anchor =
    # the shared store, exactly the thing cluster workers already
    # trust for round state.
    CLUSTER_KEY_STORE_KEY = "fabric:cluster_key"

    async def _ensure_cluster_key(self) -> None:
        import secrets

        try:
            raw = await self.store.get(self.CLUSTER_KEY_STORE_KEY)
            if raw is None:
                await self.store.set(self.CLUSTER_KEY_STORE_KEY,
                                     secrets.token_hex(32))
                # re-read: two workers racing the first boot both keep
                # whichever write won (last-write store semantics)
                raw = await self.store.get(self.CLUSTER_KEY_STORE_KEY)
            self._cluster_key = raw
        except Exception:
            # READONLY follower mid-election / store hiccup: no key
            # means signature trust is simply unavailable this beat
            # (loopback/host legs still work); the next heartbeat
            # retries. Counted: a worker stuck without signature trust
            # for many beats is a real degradation a log line can't
            # alert on
            metrics.inc("fabric.cluster_key_failures")
            log.exception("cluster key fetch failed; retrying next beat")
            self._cluster_key = None

    def _hmac(self, payload: str) -> Optional[str]:
        import hashlib
        import hmac

        key = getattr(self, "_cluster_key", None)
        if not key:
            return None
        return hmac.new(key, payload.encode(), hashlib.sha256) \
            .hexdigest()[:32]

    def sign_trace(self, traceparent: str) -> Optional[str]:
        """The ``tracesig`` a redirect pins next to ``traceparent``
        (None while the key is unavailable)."""
        return self._hmac("trace:" + traceparent)

    def verify_trace_sig(self, traceparent: str, sig: str) -> bool:
        import hmac

        want = self.sign_trace(traceparent)
        return want is not None and hmac.compare_digest(want, sig)

    def cluster_token(self) -> Optional[str]:
        """The bearer token peer fan-outs send as ``X-Cluster-Auth``
        (a fixed derivation, NOT the key itself)."""
        return self._hmac("peer-auth")

    def verify_cluster_token(self, token: str) -> bool:
        import hmac

        want = self.cluster_token()
        return want is not None and hmac.compare_digest(want, token)

    # -- room lifecycle ----------------------------------------------------
    async def game_for(self, room: str) -> Game:
        """The room's engine, created + started on first use. Unknown
        rooms raise KeyError (the HTTP layer answers 404)."""
        if not self.directory.has_room(room):
            raise KeyError(room)
        game = self._games.get(room)
        if game is None:
            game = self._build_game(room)
        startup = self._startups.get(room)
        if startup is not None:
            # single-flight startup: concurrent first requests share one
            # content generation; shield keeps a canceled waiter (client
            # disconnect) from killing the shared startup
            await asyncio.shield(startup)
        return game

    def _build_game(self, room: str) -> Game:
        view = NamespacedStore(
            self.store, room_prefix(room, self.default_room))
        game = self.game_factory(room, view)
        # per-room deterministic seed stream: two rooms on one worker
        # must hold DIFFERENT prompts (acceptance, tests/test_fabric.py),
        # which starts with them picking different story seeds
        game.rounds.rng = random.Random(f"{room}:{self.cfg.seed}")
        self._games[room] = game
        metrics.inc("fabric.rooms_created")
        flight_recorder.record("fabric.room_created", room=room)

        async def _start() -> None:
            try:
                await game.startup()
                if self.start_timers:
                    game.start_timer()
            except BaseException:
                # failed startup must not cache a half-built room: drop
                # it so the next request retries from the store
                self._games.pop(room, None)
                raise
            finally:
                self._startups.pop(room, None)

        self._startups[room] = asyncio.get_running_loop().create_task(
            _start())
        return game

    def probe_game(self) -> Game:
        """The canary probe engine: a full Game over a
        ``probe:<worker_id>:``-prefixed store view, playing the exact
        serving surface players hit — but isolated on every axis that
        matters: its store keys never collide with any room prefix
        (rooms use ``room:<id>:`` or ''), it is absent from ``_games``
        (so the directory, placement answers, heartbeat room counts,
        and drain/handoff never see it), it runs no round clock or
        startup generation (the prober seeds known-answer content
        directly), and ``room=PROBE_ROOM`` swaps its engine metrics for
        the null sink. Lazily built once per worker."""
        from cassmantle_tpu_torch.engine.game import PROBE_ROOM

        if self._probe_game is not None:
            return self._probe_game
        view = NamespacedStore(self.store, f"probe:{self.worker_id}:")
        legacy = self._legacy_game
        if legacy is not None:
            # for_game wrap: its factory returns the ONE shared game
            # regardless of arguments, so derive the probe engine from
            # the wrapped game's serving parts
            game = Game(self.cfg, view, legacy.rounds.backend,
                        embed=legacy.rounds.embed,
                        similarity=legacy.scorer._similarity,
                        blur_fn=legacy.blur_fn,
                        supervisor=legacy.supervisor,
                        room=PROBE_ROOM)
        else:
            game = self.game_factory(PROBE_ROOM, view)
        game.rounds.rng = random.Random(f"{PROBE_ROOM}:{self.cfg.seed}")
        self._probe_game = game
        return game

    async def rotate_room(self, room: str) -> None:
        """Force the room onto fresh content now (promote + reset +
        clock restart) — the operator lever behind room lifecycle."""
        game = await self.game_for(room)
        await game.rounds.rollover()
        metrics.inc("fabric.room_rotations")
        flight_recorder.record("fabric.room_rotated", room=room)

    async def drain_room(self, room: str) -> None:
        """Stop serving a room locally (ownership moved / shutdown):
        its clock and buffer tasks stop, its state stays in the store
        for the adopting worker to resume."""
        game = self._games.pop(room, None)
        startup = self._startups.pop(room, None)
        if startup is not None:
            startup.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await startup
        if game is not None:
            await game.rounds.stop()
            metrics.inc("fabric.rooms_drained")
            flight_recorder.record("fabric.room_drained", room=room)

    # -- graceful handoff ----------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    async def handoff(self, grace_s: Optional[float] = None) -> None:
        """Graceful SIGTERM departure: make peers adopt this worker's
        rooms BEFORE the process dies, instead of after the membership
        staleness TTL notices the silence.

        Sequence: stop the heartbeat (it would re-announce us), leave
        the membership table, rebuild the LOCAL ring without ourselves
        (any request still answered for an ex-room 307s to its new
        owner — the operator-initiated drain case, where the listener
        is still up; under SIGTERM aiohttp has already closed it),
        drain the room engines (clocks stop; round/session state stays
        in the shared store for the adopters to resume), then wait —
        bounded by ``FabricConfig.handoff_grace_s`` — until every live
        peer has heartbeated PAST our departure (its beat re-reads
        membership and rebuilds its ring = adoption). /readyz reports
        ``draining`` for as long as this worker still answers probes,
        so load balancers stop admitting while in-flight requests
        finish under their deadlines. Idempotent; the server's SIGTERM
        hook (create_app on_shutdown) runs it before cleanup."""
        if self._draining:
            return
        self._draining = True
        t0 = asyncio.get_running_loop().time()
        rooms_held = len(self._games)
        metrics.inc("fabric.handoffs")
        flight_recorder.record("fabric.handoff_started",
                               worker=self.worker_id, rooms=rooms_held)
        if self._hb_task is not None:
            self._hb_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._hb_task
            self._hb_task = None
        if self._heartbeat_enabled:
            with contextlib.suppress(Exception):
                await self.membership.leave()
        # baseline each live peer's CURRENT stamp, read AFTER the leave
        # landed: a peer beat stamps itself BEFORE its membership
        # refresh, so a stamp that ADVANCES past this baseline implies
        # the refresh following it read a table without us — the ring
        # rebuild that adopts our rooms. Comparing a peer's stamp to
        # its OWN earlier stamp keeps this correct across hosts: an
        # absolute our-clock-vs-their-clock compare would let skew
        # either confirm adoption off a pre-leave beat or stall every
        # deploy for the full grace.
        baseline: Dict[str, float] = {}
        if self._heartbeat_enabled:
            try:
                table = await self.membership.table()
                baseline = {
                    w: float(row["info"].get("t", 0.0))
                    for w, row in table.items()
                    if w != self.worker_id and not row["stale"]
                }
            except Exception:
                baseline = {}
        # move the ring NOW: ownership answers flip to the survivors
        # while this worker can still serve the redirects
        peers = [w for w in self.directory.workers()
                 if w != self.worker_id]
        if peers:
            moves = self.directory.set_workers(peers)
            for room, (old, new) in moves.items():
                metrics.inc("fabric.room_moves")
                flight_recorder.record("fabric.room_move", room=room,
                                       src=old, dst=new)
        for room in list(self._games):
            await self.drain_room(room)
        if peers and self._heartbeat_enabled:
            await self._await_adoption(baseline, grace_s)
        duration = asyncio.get_running_loop().time() - t0
        metrics.observe("fabric.handoff_s", duration)
        flight_recorder.record("fabric.handoff_complete",
                               worker=self.worker_id, rooms=rooms_held,
                               duration_s=round(duration, 3))
        log.info("graceful handoff complete: %d room(s) released in "
                 "%.2fs", rooms_held, duration)

    async def _await_adoption(self, baseline: Dict[str, float],
                              grace_s: Optional[float]) -> None:
        """Block (bounded) until every live peer's heartbeat stamp has
        ADVANCED past its post-leave baseline — that beat rebuilt the
        peer's ring, i.e. our rooms are adopted. Each peer's stamp is
        compared only to its own earlier stamp (skew-safe across
        hosts); a peer with no baseline joined after we left and
        already holds the new ring. A peer that also left (its row is
        gone) or a store outage stops the wait: dying is the job here,
        waiting forever is not."""
        grace = (grace_s if grace_s is not None
                 else self.cfg.fabric.handoff_grace_s)
        deadline = asyncio.get_running_loop().time() + grace
        poll = min(0.1, max(0.02, self.cfg.fabric.heartbeat_s / 4.0))
        while asyncio.get_running_loop().time() < deadline:
            try:
                table = await self.membership.table()
            except Exception:
                return  # store unreachable: nothing left to confirm
            live = {w: row for w, row in table.items()
                    if w != self.worker_id and not row["stale"]}
            if not live:
                return  # peers left too (fleet-wide shutdown)
            if all(w not in baseline
                   or float(row["info"].get("t", 0.0)) > baseline[w]
                   for w, row in live.items()):
                return
            await asyncio.sleep(poll)
        log.warning("handoff grace (%.1fs) expired before every peer "
                    "re-heartbeated; exiting anyway", grace)

    # -- lifecycle ---------------------------------------------------------
    async def startup(self) -> None:
        """Announce membership, adopt owned rooms (the default room
        eagerly — legacy clients expect content at boot), start the
        heartbeat loop."""
        starter = getattr(self.store, "start", None)
        if callable(starter):
            # ReplicatedStore: find/elect the leader and start the
            # log-shipping pump on this worker's event loop
            await starter()
        if self._heartbeat_enabled:
            await self._ensure_cluster_key()
            try:
                live = await self.membership.heartbeat(len(self._games))
                self._apply_membership(live)
            except Exception:
                # best-effort like every later beat: a store hiccup (or
                # an injected heartbeat fault) on the FIRST beat must
                # not fail worker boot — the loop below re-announces
                # within one heartbeat_s
                log.exception("startup heartbeat failed; continuing")
                metrics.inc("fabric.heartbeat_failures")
        # preinstalled games (the for_game legacy wrap) start the way
        # create_app always started its one game
        for room, game in list(self._games.items()):
            if room not in self._startups:
                await game.startup()
                if self.start_timers:
                    game.start_timer()
        if self.is_local(self.default_room) \
                and self.default_room not in self._games:
            await self.game_for(self.default_room)
        if self._heartbeat_enabled:
            self._hb_task = asyncio.get_running_loop().create_task(
                self._heartbeat_loop())

    async def shutdown(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._hb_task
            self._hb_task = None
        if self._heartbeat_enabled:
            with contextlib.suppress(Exception):
                await self.membership.leave()
        for room in list(self._games):
            await self.drain_room(room)
        await self.store.close()
        for service in self.services:
            await service.stop()

    async def _heartbeat_loop(self) -> None:
        interval = self.cfg.fabric.heartbeat_s
        while True:
            await asyncio.sleep(interval)
            try:
                # EVERY beat re-reads the store key: a worker that lost
                # the first-boot set race (or cached a key the store
                # later replaced) must converge on the winning value,
                # not hold its loser forever and mint signatures no
                # peer verifies
                await self._ensure_cluster_key()
                # overload advertisement (serving/overload.py): peers
                # read shed/btier from our heartbeat before hedging
                # scorer work here (score.hedge_skipped_overloaded)
                from cassmantle_tpu_torch.serving.overload import peer_advert

                live = await self.membership.heartbeat(
                    len(self._games), extra=peer_advert())
                await self._handle_moves(self._apply_membership(live))
            except asyncio.CancelledError:
                raise
            except Exception:
                # membership is best-effort per tick: a store hiccup
                # must not kill the loop (the next beat retries)
                log.exception("membership heartbeat failed; continuing")
                metrics.inc("fabric.heartbeat_failures")

    def _apply_membership(self, live: Dict[str, dict]) -> Dict[str, tuple]:
        workers = set(live) | {self.worker_id}
        moves = self.directory.set_workers(sorted(workers))
        for room, (old, new) in moves.items():
            metrics.inc("fabric.room_moves")
            flight_recorder.record("fabric.room_move", room=room,
                                   src=old, dst=new)
        metrics.gauge("fabric.rooms_owned", float(len(self.owned_rooms())))
        return moves

    async def _handle_moves(self, moves: Dict[str, tuple]) -> None:
        for room, (old, new) in moves.items():
            if old == self.worker_id and new != self.worker_id \
                    and room in self._games:
                await self.drain_room(room)

    # -- status ------------------------------------------------------------
    def status(self) -> Dict[str, object]:
        """The `/readyz` fabric block: identity, placement, membership,
        replication. Sync by contract — reads only cached snapshots."""
        status: Dict[str, object] = {
            "worker": self.worker_id,
            "rooms": self.directory.placement(),
            "owned": self.owned_rooms(),
            "active": sorted(self._games),
            "workers": self.membership.live_workers(),
            "draining": self._draining,
        }
        repl_status = getattr(self.store, "status", None)
        if callable(repl_status):
            status["replication"] = repl_status()
        return status
