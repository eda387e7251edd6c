"""HTTP/WS API surface (aiohttp): the game server.

Port of ``cassmantle_tpu/server/app.py`` over a
:class:`~cassmantle_tpu_torch.fabric.rooms.RoomFabric`, served by the
port's ``InferenceService`` and ``Game``. Routes, with the reference's
bodies, status codes and headers:

- ``GET  /``               the game page (static/index.html)
- ``GET  /init``           a new session id in a cookie
- ``GET  /client/status``  {won, needInitialization}
- ``GET  /fetch/contents`` {image: base64 JPEG at the session's blur,
                            prompt, story}
- ``POST /compute_score``  {inputs: {mask_idx: guess}} -> scores; floor
                            scores marked ``X-Score-Degraded`` while the
                            scorer is dark and no peer answered a hedge
                            (``X-Score-Hedged`` where one did);
                            ``X-Queue-Wait`` and ``X-Service-Time``
                            from the batching queue
- ``WS   /clock``          1 Hz {time, reset, conns}
- ``GET  /metrics``        the JSON snapshot; Prometheus text under
                           ``Accept: text/plain``, OpenMetrics under
                           ``application/openmetrics-text``;
                           ``?scope=cluster`` merges every live member's
                           registry, ``?format=state`` is the peers'
                           wire form (loopback or cluster peers)
- ``GET  /debugz``         the flight recorder's tail, or one trace's
                           spans (``?trace=<X-Trace-Id>``;
                           ``&scope=cluster`` merges it across workers);
                           loopback or cluster peers
- ``POST /debug/trace``    a ``torch.profiler`` capture of N seconds
                           (``?seconds=N[&name=]``) under
                           ``CASSMANTLE_TRACE_ROOT``; loopback or the
                           cluster token, one at a time
- ``GET  /sloz``           the SLO burn-rate verdicts
- ``GET  /healthz``        liveness: store and the device probe
- ``GET  /readyz``         readiness: the supervisor's verdict, 503 and
                           Retry-After while degraded, with the SLO,
                           overload, device-telemetry and canary blocks
- ``GET  /wordlist``       the spellcheck lexicon, ETag-revalidated
- static mounts ``/static``, ``/data`` and ``/media``

Rate limits are the reference's (3/s, 2/s on the API routes, per client IP
and room). The background tasks are the process and device samplers, the
SLO loop that steps the brownout ladder (``CASSMANTLE_NO_SLO=1`` turns the
loop off), the canary prober (``obs/prober.py``: it plays the probe room
``?room=__probe__`` over this worker's own listener, ``self_addr``, and
feeds the ``probe_success`` / ``probe_latency`` objectives;
``CASSMANTLE_NO_PROBER=1`` leaves no probe artifact and ``/readyz``'s
canary block reads ``{"enabled": false}``), and, under
``CASSMANTLE_LEAK_SENTINEL=1``, the leak census (``utils/leak_sentinel.py``)
at the process sampler's cadence. ``python -m cassmantle_tpu_torch serve``
runs :func:`main`; it serves on the card unless ``--platform cpu`` or
``--fake`` asks for the host.

Many workers: every room-scoped route answers a room another worker owns
with a 307 to the owner's advertised address (``--advertise``), the
room, the session and a signed traceparent in the query; a worker whose
scorer is dark hedges the guesses to a healthy peer before it serves
floor scores; ``/metrics`` and ``/debugz`` federate over the live members.
The store is shared: one native node (``--store native[:port]``) or a
replicated set of them (``--store repl:host:port,...``).
``--workers N`` starts N - 1 more processes on the same port
(``SO_REUSEPORT``) over one such store, on the host only (``--fake`` or
``--platform cpu``): the card has one owning process. A card worker joins
a fleet of hosts through a replicated store and ``--advertise``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import hashlib
import json
import math
import os
import re
import socket
import tempfile
import time
import uuid
from typing import Optional

from aiohttp import WSMsgType, web

from cassmantle_tpu_torch import chaos
from cassmantle_tpu_torch.chaos import afault_point
from cassmantle_tpu_torch.config import FrameworkConfig, ObsConfig
from cassmantle_tpu_torch.engine.game import PROBE_ROOM, Game
from cassmantle_tpu_torch.fabric.rooms import RoomFabric
from cassmantle_tpu_torch.obs import (
    configure_observability,
    flight_recorder,
    tracer,
)
from cassmantle_tpu_torch.obs import device as device_obs
from cassmantle_tpu_torch.obs.device import DeviceMetrics
from cassmantle_tpu_torch.obs.process import ProcessMetrics
from cassmantle_tpu_torch.obs.prober import (
    CanaryProber,
    ensure_probe_round,
    prober_disabled,
)
from cassmantle_tpu_torch.obs.slo import SloEngine, default_objectives
from cassmantle_tpu_torch.obs.trace import (
    current_ctx,
    current_marks,
    format_traceparent,
    parse_traceparent,
)
from cassmantle_tpu_torch.serving import overload
from cassmantle_tpu_torch.serving.queue import OverloadShed
from cassmantle_tpu_torch.utils import leak_sentinel
from cassmantle_tpu_torch.utils.logging import (
    NULL_METRICS,
    get_logger,
    merge_states,
    metrics,
)

log = get_logger("app")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STATIC_DIR = os.path.join(_ROOT, "static")
DATA_DIR = os.path.join(_ROOT, "data")
MEDIA_DIR = os.path.join(_ROOT, "media")

_FABRIC = web.AppKey("fabric", RoomFabric)
_SLO = web.AppKey("slo_engine", SloEngine)
_PROCESS = web.AppKey("process_metrics", ProcessMetrics)
_DEVICE = web.AppKey("device_metrics", DeviceMetrics)
_OBS_CFG = web.AppKey("obs_cfg", ObsConfig)
# mutable holders (aiohttp freezes app keys at startup): the obs tasks,
# the canary prober (None under CASSMANTLE_NO_PROBER), the single flight
# of /debug/trace and the lazy ClientSession of the peer fan-outs
_OBS_TASKS = web.AppKey("obs_tasks", list)
_PEER_HTTP = web.AppKey("peer_http", dict)
_PROBER = web.AppKey("prober", dict)
_TRACE_STATE = web.AppKey("trace_state", dict)


def _env_flag_set(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def _cluster_obs_enabled() -> bool:
    """CASSMANTLE_NO_CLUSTER_OBS=1: inbound trace contexts are ignored
    and the cluster fan-outs answer worker-local."""
    return not _env_flag_set("CASSMANTLE_NO_CLUSTER_OBS")


def _client_ip(request: web.Request) -> str:
    peer = (request.transport.get_extra_info("peername")
            if request.transport else None)
    return peer[0] if peer else "?"


def _session_id(request: web.Request) -> Optional[str]:
    # the ?session= fallback keeps identity across a cross-worker redirect
    return request.cookies.get("session_id") or request.query.get("session")


def _explicit_room(request: web.Request) -> Optional[str]:
    return request.query.get("room") or request.headers.get("X-Room") \
        or request.cookies.get("room")


def _room_of(request: web.Request) -> str:
    """An explicit ?room= / X-Room / cookie wins; otherwise the session
    (or the client IP) hashes onto the room list."""
    explicit = _explicit_room(request)
    if explicit:
        return explicit
    fabric = request.app[_FABRIC]
    principal = _session_id(request) or _client_ip(request)
    return fabric.directory.room_for_session(principal)


def _check_room_ownership(request: web.Request, fabric: RoomFabric,
                          room: str) -> None:
    """The ownership gate of every room-scoped route: a room another
    worker owns answers 307 to the owner's advertised address; with no
    address the room serves here (the per-room store locks keep that
    safe). The Location carries the room and the session (cookies do not
    cross hosts) and the active trace context with its signature under
    the cluster key, so the owner continues this trace. A peer's scorer
    hedge (``X-Score-Hedge: 1`` from a cluster peer) serves here: its
    room's owner is the worker that hedged."""
    if request.headers.get("X-Score-Hedge") == "1" and \
            _is_cluster_peer(request, fabric):
        metrics.inc("score.hedge_served")
        return
    if fabric.is_local(room):
        return
    addr = fabric.owner_addr(room)
    if not addr:
        metrics.inc("fabric.foreign_serves")
        return
    metrics.inc("fabric.redirects")
    url = request.rel_url.update_query(room=room)
    session = _session_id(request)
    if session:
        url = url.update_query(session=session)
    ctx = current_ctx()
    if ctx is not None:
        tp = format_traceparent(ctx)
        url = url.update_query(traceparent=tp)
        sig = fabric.sign_trace(tp)
        if sig:
            url = url.update_query(tracesig=sig)
    raise web.HTTPTemporaryRedirect(location=addr.rstrip("/") + str(url))


async def _resolve_probe_game(request: web.Request, fabric: RoomFabric):
    """(PROBE_ROOM, the probe game) for a canary request: the probe room
    exists on every worker, is a 404 to anyone but a cluster peer (like
    any unknown room), and seeds its known-answer round on first use. The
    request's trace is marked ``probe``: the queues' adaptive admission
    lets it through untaught, and the tail sampler keeps it."""
    if not _is_cluster_peer(request, fabric):
        raise web.HTTPNotFound(text=f"unknown room {PROBE_ROOM!r}")
    game = fabric.probe_game()
    await ensure_probe_round(game)
    ctx = current_ctx()
    if ctx is not None:
        ctx.marks["probe"] = True
    tracer.mark_retain("probe")
    return PROBE_ROOM, game


async def _resolve_game(request: web.Request):
    """(room, game) for this request, after the ownership gate. The probe
    room is never redirected: a probe asks a given worker."""
    fabric = request.app[_FABRIC]
    if _explicit_room(request) == PROBE_ROOM:
        return await _resolve_probe_game(request, fabric)
    room = _room_of(request)
    if not fabric.directory.has_room(room):
        raise web.HTTPNotFound(text=f"unknown room {room!r}")
    _check_room_ownership(request, fabric, room)
    try:
        return room, await fabric.game_for(room)
    except KeyError:
        raise web.HTTPNotFound(text=f"unknown room {room!r}")


def _is_loopback(request: web.Request) -> bool:
    """Fail closed: an unresolvable peer is not local."""
    return request.remote in ("127.0.0.1", "::1")


def _is_cluster_peer(request: web.Request, fabric: RoomFabric) -> bool:
    """The trust gate of the operator surfaces and of inbound trace
    contexts: loopback, a live member's advertised host, or the
    cluster-secret token (``X-Cluster-Auth``)."""
    if _is_loopback(request):
        return True
    if request.remote in fabric.peer_hosts():
        return True
    token = request.headers.get("X-Cluster-Auth")
    return bool(token) and fabric.verify_cluster_token(token)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        response = web.Response()
    else:
        response = await handler(request)
    response.headers["Access-Control-Allow-Origin"] = "*"
    response.headers["Access-Control-Allow-Credentials"] = "true"
    response.headers["Access-Control-Allow-Methods"] = "GET, POST"
    response.headers["Access-Control-Allow-Headers"] = "*"
    return response


@web.middleware
async def tracing_middleware(request: web.Request, handler):
    """One root span per request; its trace id returns as ``X-Trace-Id``
    (``/debugz?trace=<id>``). The static mounts, the probe and scrape
    routes and ``/clock`` skip tracing: they would flush the trace ring
    of the player requests an operator triages. A ``traceparent`` header
    (or query parameter) continues a trace when it comes from loopback or
    a cluster peer, or as a query parameter with a valid ``tracesig``."""
    if request.path.startswith(("/static", "/data", "/media")) or \
            request.path in ("/healthz", "/readyz", "/metrics", "/debugz",
                             "/clock", "/sloz"):
        return await handler(request)
    fabric = request.app[_FABRIC]
    remote_ctx = None
    header_tp = request.headers.get("traceparent")
    query_tp = request.query.get("traceparent")
    if (header_tp or query_tp) and _cluster_obs_enabled():
        chosen = None
        sig = request.query.get("tracesig")
        if query_tp and sig and fabric.verify_trace_sig(query_tp, sig):
            # a signed query context wins: the signature binds it to this
            # hop, where a header is ambient client instrumentation
            chosen = query_tp
        elif _is_cluster_peer(request, fabric):
            chosen = header_tp or query_tp
        remote_ctx = parse_traceparent(chosen) if chosen else None
        metrics.inc("obs.trace_joins" if remote_ctx is not None
                    else "obs.trace_ctx_rejected")
    name = f"http.{request.method.lower()} {request.path}"
    with tracer.span(name, root=remote_ctx is None, parent=remote_ctx,
                     attrs={"worker": fabric.worker_id}) as span:
        try:
            response = await handler(request)
        except web.HTTPException as exc:
            span.attrs["status"] = exc.status
            exc.headers["X-Trace-Id"] = span.trace_id
            # tail retention: a shed (503) is kept; routine redirects and
            # 4xx are the healthy baseline
            if exc.status == 503:
                tracer.mark_retain("shed", span.ctx)
            elif exc.status < 500:
                tracer.mark_retain("baseline", span.ctx)
            raise
        except asyncio.CancelledError:
            raise
        except Exception:
            # a handler bug: answer the 500 here so it carries the trace id
            span.attrs["status"] = 500
            tracer.mark_retain("error", span.ctx)
            log.exception("unhandled error serving %s %s", request.method,
                          request.path)
            return web.Response(status=500, text="500 Internal Server Error",
                                headers={"X-Trace-Id": span.trace_id})
        span.attrs["status"] = response.status
        if response.status >= 500:
            tracer.mark_retain("error", span.ctx)
        if not response.prepared:
            response.headers["X-Trace-Id"] = span.trace_id
            tier = overload.current_tier()
            if tier:
                # while the brownout ladder degrades quality, every game
                # response says so
                response.headers["X-Quality-Degraded"] = f"tier-{tier}"
                tracer.mark_retain("degraded", span.ctx)
        return response


def make_ratelimit_middleware(cfg: FrameworkConfig):
    from cassmantle_tpu_torch.server.ratelimit import RateLimiter

    limiter = RateLimiter()
    api_routes = {"/init", "/client/status", "/fetch/contents",
                  "/compute_score"}

    @web.middleware
    async def ratelimit(request: web.Request, handler):
        rate = (cfg.game.rate_limit_api if request.path in api_routes
                else cfg.game.rate_limit_default)
        # (client IP, room): a noisy room drains only its own quota; only
        # rooms that exist count, so ?room= mints at most num_rooms buckets
        fabric = request.app[_FABRIC]
        explicit = _explicit_room(request)
        if explicit and fabric.directory.has_room(explicit):
            room = explicit
        else:
            who = _session_id(request) or _client_ip(request)
            room = fabric.directory.room_for_session(who)
        principal = (_client_ip(request), room)
        if not limiter.allow(principal, request.path, rate):
            metrics.inc("http.rate_limited")
            # Retry-After from this bucket's own refill time
            retry = limiter.retry_after_s(principal, request.path)
            raise web.HTTPTooManyRequests(
                text="rate limit exceeded",
                headers={"Retry-After": str(max(1, math.ceil(retry)))})
        return await handler(request)

    return ratelimit


async def handle_root(request: web.Request) -> web.StreamResponse:
    return web.FileResponse(os.path.join(STATIC_DIR, "index.html"))


async def handle_init(request: web.Request) -> web.Response:
    # a fresh session's room resolves from the new id, so the cookie pair
    # (session_id, room) stays self-consistent
    session_id = _session_id(request) or str(uuid.uuid4())
    fabric = request.app[_FABRIC]
    if _explicit_room(request) == PROBE_ROOM:
        # the canary's init: its session starts the known-answer round
        # unsolved; no cookies (the prober sends ?session=) and no
        # http.init, so player counters never see probes
        room, game = await _resolve_probe_game(request, fabric)
        await game.init_client(session_id)
        return web.json_response({"message": "Session initialized",
                                  "session_id": session_id, "room": room})
    room = _explicit_room(request) or \
        fabric.directory.room_for_session(session_id)
    if not fabric.directory.has_room(room):
        raise web.HTTPNotFound(text=f"unknown room {room!r}")
    # init on a non-owner redirects too: it must not start a second
    # engine (and a second round clock) of the room here
    _check_room_ownership(request, fabric, room)
    game = await fabric.game_for(room)
    await game.init_client(session_id)
    response = web.json_response({"message": "Session initialized",
                                  "session_id": session_id, "room": room})
    response.set_cookie("session_id", session_id)
    response.set_cookie("room", room)
    metrics.inc("http.init")
    return response


async def handle_status(request: web.Request) -> web.Response:
    _, game = await _resolve_game(request)
    return web.json_response(await game.client_status(_session_id(request)))


async def handle_fetch_contents(request: web.Request) -> web.Response:
    room, game = await _resolve_game(request)
    session = _session_id(request) or str(uuid.uuid4())
    await game.ensure_client(session)
    # the canary's timings stay out of the players' latency series
    registry = NULL_METRICS if room == PROBE_ROOM else metrics
    with registry.timer("http.fetch_contents_s"):
        image_b64 = await game.fetch_masked_image_b64(session)
        prompt = await game.fetch_prompt_json(session)
        story = await game.fetch_story()
    response = web.json_response({"image": image_b64, "prompt": prompt,
                                  "story": story})
    if not _session_id(request):
        response.set_cookie("session_id", session)
    return response


# A hedge dials at most this many peers, and a hedged request never hedges
# again: a sick cluster degrades after one bounded fan, it cannot storm.
SCORE_HEDGE_MAX_ATTEMPTS = 2


async def _hedge_score(request: web.Request, room: str, session: str,
                       payload: dict) -> Optional[dict]:
    """The scorer's failover across workers: with the local scorer dark,
    post the guesses to a healthy peer's /compute_score with the cluster
    token and ``X-Score-Hedge: 1`` (the peer serves the room there and
    never hedges again). Peers whose heartbeat advertises overload
    (admission shedding, a brownout tier) are skipped. Returns the peer's
    scores, or None when no peer answered (floor scores are the last
    resort)."""
    fabric = request.app[_FABRIC]
    token = fabric.cluster_token()
    if token is None:
        return None
    try:
        table = await fabric.membership.table()
    except Exception:
        # best effort: no table is no peer, and the floor serves
        return None
    peers = []
    for worker, row in sorted(table.items()):
        if worker == fabric.worker_id or row["stale"] or \
                not row["info"].get("addr"):
            continue
        if row["info"].get("shed") or row["info"].get("btier"):
            # hedging into a shedding or browned-out peer trades a local
            # floor score for a remote 503
            metrics.inc("score.hedge_skipped_overloaded")
            continue
        peers.append((worker, row["info"].get("addr")))
    http = _peer_session(request)
    for worker, addr in peers[:SCORE_HEDGE_MAX_ATTEMPTS]:
        metrics.inc("score.hedge_attempts")
        try:
            await afault_point("score.hedge", peer=worker)
            async with http.post(
                    addr.rstrip("/") + "/compute_score",
                    params={"room": room, "session": session},
                    json=payload,
                    headers={"X-Cluster-Auth": token,
                             "X-Score-Hedge": "1"}) as res:
                if res.status != 200:
                    # a degraded peer sheds the hedge with 503: try the
                    # next one, never loop back
                    metrics.inc("score.hedge_failures")
                    continue
                data = await res.json()
        except Exception:
            metrics.inc("score.hedge_failures")
            continue
        metrics.inc("score.hedge_success")
        flight_recorder.record("score.hedge", peer=worker, room=room)
        return data
    return None


async def handle_compute_score(request: web.Request) -> web.Response:
    room, game = await _resolve_game(request)
    supervisor = game.supervisor
    session = _session_id(request) or str(uuid.uuid4())
    try:
        data = await request.json()
        inputs = data["inputs"]
        assert isinstance(inputs, dict)
    except Exception:
        raise web.HTTPBadRequest(text="body must be {inputs: {idx: guess}}")
    if supervisor.shed_scores() or supervisor.device_unhealthy():
        # the local scorer is dark: a request that is itself a peer's
        # hedge sheds 503 (hedges never cascade); else hedge to a healthy
        # peer; else floor scores, marked
        if request.headers.get("X-Score-Hedge") == "1":
            metrics.inc("http.score_shed")
            raise web.HTTPServiceUnavailable(
                text="scoring degraded; retry shortly",
                headers={"Retry-After": str(int(supervisor.retry_after_s()))})
        hedged = await _hedge_score(request, room, session,
                                    {"inputs": inputs})
        if hedged is not None:
            response = web.json_response(hedged)
            response.headers["X-Score-Hedged"] = "1"
            return response
        metrics.inc("score.hedge_floor")
        flight_recorder.record("score.floor", room=room)
    await game.ensure_client(session)
    registry = NULL_METRICS if room == PROBE_ROOM else metrics
    try:
        with registry.timer("http.compute_score_s"):
            scores = await game.compute_client_scores(session, inputs)
    except OverloadShed as exc:
        # adaptive admission shed it: the limiter's computed Retry-After
        metrics.inc("overload.score_shed")
        raise web.HTTPServiceUnavailable(
            text="overloaded; retry later",
            headers={"Retry-After": str(max(1, math.ceil(exc.retry_after_s))),
                     "X-Overload-Shed": exc.reason})
    response = web.json_response(scores)
    if supervisor.shed_scores() or supervisor.device_unhealthy():
        response.headers["X-Score-Degraded"] = "floor"
    # the guess batch's coalescing wait and the batch it rode, from the
    # queue's marks (absent where no queue was touched)
    marks = current_marks()
    if marks and "queue_wait_s" in marks:
        response.headers["X-Queue-Wait"] = f"{marks['queue_wait_s']:.6f}"
        response.headers["X-Service-Time"] = f"{marks['service_s']:.6f}"
    return response


async def handle_clock(request: web.Request) -> web.WebSocketResponse:
    # room-scoped before the handshake: a redirect must still be a 307
    _, game = await _resolve_game(request)
    session = _session_id(request)
    ws = web.WebSocketResponse(heartbeat=30.0)
    await ws.prepare(request)
    log.info("client %s connected", session)
    metrics.inc("ws.connections")

    async def sender() -> None:
        # the first tick goes out at once
        while not ws.closed:
            if session:
                await game.sessions.add_client(session)
            await ws.send_json(await game.clock_payload())
            await asyncio.sleep(1.0)

    send_task = asyncio.ensure_future(sender())
    try:
        async for msg in ws:
            if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                break
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        send_task.cancel()
        try:
            await send_task
        except (asyncio.CancelledError, ConnectionResetError, Exception):
            pass
        log.info("client %s disconnected", session)
        if session:
            await game.sessions.remove_connection(session)
        metrics.inc("ws.disconnections")
    return ws


def _peer_session(request: web.Request):
    """The app's ClientSession for cluster fan-outs, made on first use (so
    it binds the serving loop) and closed at cleanup."""
    import aiohttp

    holder = request.app[_PEER_HTTP]
    if holder.get("session") is None:
        holder["session"] = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(
                total=request.app[_OBS_CFG].cluster_fanout_timeout_s))
    return holder["session"]


async def _peer_fanout(request: web.Request, path: str, params: dict):
    """One GET to every live member at once, this worker excluded:
    ``(worker, row)`` pairs, row ``{"status": "ok", "data": <JSON>}`` or a
    status that says why a peer is missing (``stale``, ``no_addr``,
    ``error``, ``http_<code>``). Requests carry the cluster token, so a
    peer's gate admits them whatever its membership addresses resolve
    to."""
    fabric = request.app[_FABRIC]
    session = _peer_session(request)
    headers = {}
    token = fabric.cluster_token()
    if token:
        headers["X-Cluster-Auth"] = token

    async def fetch(worker: str, addr: str):
        try:
            # a worker-scoped partition marks exactly that peer errored
            await afault_point("fabric.peer_http", peer=worker)
            async with session.get(addr.rstrip("/") + path, params=params,
                                   headers=headers) as res:
                if res.status != 200:
                    return worker, {"status": f"http_{res.status}"}
                data = await res.json()
            return worker, {"status": "ok", "data": data}
        except Exception as exc:
            metrics.inc("obs.federation_peer_errors")
            return worker, {"status": "error", "error": type(exc).__name__}

    results, fetches = [], []
    table = await fabric.membership.table()
    for worker, row in sorted(table.items()):
        if worker == fabric.worker_id:
            continue
        if row["stale"]:
            results.append((worker, {"status": "stale",
                                     "age_s": row["age_s"]}))
            continue
        addr = row["info"].get("addr")
        if not addr:
            results.append((worker, {"status": "no_addr"}))
            continue
        fetches.append(fetch(worker, addr))
    results.extend(await asyncio.gather(*fetches))
    return results


async def _federated_metrics(request: web.Request):
    """(merged registry, federation block): this worker's registry state
    and every reachable peer's, merged by ``merge_states`` (counters sum,
    gauges labeled by worker, histograms bucket by bucket). A
    ``federation.peer_up`` gauge per worker carries the view's coverage
    into every exposition."""
    fabric = request.app[_FABRIC]
    states = [(fabric.worker_id, metrics.dump_state())]
    federation = {fabric.worker_id: {"status": "self"}}
    for worker, row in await _peer_fanout(request, "/metrics",
                                          {"format": "state"}):
        state = row.get("data", {}).get("state") \
            if row["status"] == "ok" else None
        if state is not None:
            states.append((worker, state))
            federation[worker] = {"status": "ok"}
        elif row["status"] == "ok":
            # a 200 without the state payload: marked, never a 500
            federation[worker] = {"status": "bad_payload"}
        else:
            federation[worker] = row
    cluster_metrics = merge_states(states)
    for worker, row in federation.items():
        cluster_metrics.gauge(
            "federation.peer_up",
            1.0 if row["status"] in ("self", "ok") else 0.0,
            labels={"worker": worker})
    return cluster_metrics, federation


async def handle_metrics(request: web.Request) -> web.Response:
    """Content-negotiated: OpenMetrics or Prometheus text for a scraper,
    the JSON snapshot otherwise (``?exemplars=1`` adds exemplars).
    ``?scope=cluster`` federates every live member's registry into one
    view (unreachable peers marked in the ``federation`` block and the
    ``federation.peer_up`` gauge); ``?format=state`` is this worker's full
    registry state, the peers' wire form (always worker-local: a peer's
    request never fans out again). The two cluster forms answer loopback
    and cluster peers only: an open fan-out would amplify any client's
    request N-fold."""
    request.app[_PROCESS].sample()
    request.app[_DEVICE].sample()
    fabric = request.app[_FABRIC]
    fmt_state = request.query.get("format") == "state"
    cluster = request.query.get("scope") == "cluster"
    if (fmt_state or cluster) and not _is_cluster_peer(request, fabric):
        raise web.HTTPForbidden(
            text="cluster metrics: loopback or cluster peers only")
    if fmt_state:
        return web.json_response({"worker": fabric.worker_id,
                                  "state": metrics.dump_state()})
    federation = None
    registry = metrics
    if cluster:
        if _cluster_obs_enabled():
            registry, federation = await _federated_metrics(request)
        else:
            federation = {"disabled": True}
    accept = request.headers.get("Accept", "")
    if "application/openmetrics-text" in accept:
        return web.Response(
            body=registry.openmetrics().encode(),
            headers={"Content-Type": "application/openmetrics-text; "
                                     "version=1.0.0; charset=utf-8"})
    if "text/plain" in accept or "openmetrics" in accept:
        return web.Response(
            body=registry.prometheus().encode(),
            headers={"Content-Type":
                     "text/plain; version=0.0.4; charset=utf-8"})
    snap = registry.snapshot(
        exemplars=request.query.get("exemplars") == "1")
    if federation is not None:
        snap["federation"] = federation
    return web.json_response(snap)


async def handle_debugz(request: web.Request) -> web.Response:
    """The serving black box, for loopback and cluster peers:
    ``?trace=<id>`` returns one trace's spans (``&scope=cluster`` merges
    them across the live members: a request that was redirected left
    spans on two workers); otherwise the flight recorder's tail (``?n=``
    limits, ``?kind=`` filters by kind or ``prefix.``) with the
    recorder's and tracer's stats."""
    if not _is_cluster_peer(request, request.app[_FABRIC]):
        raise web.HTTPForbidden(text="loopback or cluster peers only")
    trace_id = request.query.get("trace")
    if trace_id:
        if request.query.get("scope") == "cluster" and \
                _cluster_obs_enabled():
            return await _cluster_trace(request, trace_id)
        spans = tracer.get_trace(trace_id)
        if spans is None:
            raise web.HTTPNotFound(
                text=f"trace {trace_id!r} not resident (bounded ring "
                     f"keeps {tracer.capacity} traces)")
        spans.sort(key=lambda s: s["start_ts"])
        return web.json_response({"trace_id": trace_id, "spans": spans})
    try:
        n = int(request.query.get("n", "200"))
    except ValueError:
        raise web.HTTPBadRequest(text="n must be an integer")
    return web.json_response({
        "events": flight_recorder.tail(n, kind=request.query.get("kind")),
        "recorder": flight_recorder.stats(),
        "tracer": tracer.stats(),
        "recent_traces": tracer.trace_ids()[-25:],
    })


async def _cluster_trace(request: web.Request,
                         trace_id: str) -> web.Response:
    """``/debugz?trace=<id>&scope=cluster``: this worker's spans of the
    trace and every live peer's (each answers its local lookup), deduped
    by span id, in time order, with a ``peers`` block: a peer without the
    trace is a ``miss``, a dark one is marked."""
    fabric = request.app[_FABRIC]
    merged = {s["span_id"]: s for s in (tracer.get_trace(trace_id) or [])}
    peers = {fabric.worker_id: {"status": "self", "spans": len(merged)}}
    for worker, row in await _peer_fanout(request, "/debugz",
                                          {"trace": trace_id}):
        if row["status"] == "ok":
            remote = row["data"].get("spans", [])
            for span in remote:
                merged.setdefault(span["span_id"], span)
            peers[worker] = {"status": "ok", "spans": len(remote)}
        elif row["status"] == "http_404":
            peers[worker] = {"status": "miss"}
        else:
            peers[worker] = row
    if not merged:
        raise web.HTTPNotFound(
            text=f"trace {trace_id!r} not resident on any reachable worker")
    spans = sorted(merged.values(), key=lambda s: s["start_ts"])
    return web.json_response({"trace_id": trace_id, "scope": "cluster",
                              "spans": spans, "peers": peers})


async def handle_sloz(request: web.Request) -> web.Response:
    """Every objective's state and burn rates, evaluated on read
    (rate-limited inside the engine)."""
    engine = request.app[_SLO]
    engine.evaluate()
    return web.json_response(engine.status())


async def _probe_store(fabric: RoomFabric) -> bool:
    try:
        await asyncio.wait_for(fabric.store.exists("healthz"), timeout=2.0)
        return True
    except Exception:
        return False


async def handle_healthz(request: web.Request) -> web.Response:
    """Liveness: the store and the device probe, concurrently, each under
    a deadline. The supervisor block rides along, but only the store and
    the device set the status code. Where the device probe is wired, the
    ``probe`` block names the device it ran on and the class of a failed
    verdict."""
    fabric = request.app[_FABRIC]
    supervisor = fabric.supervisor
    store_ok, device_ok = await asyncio.gather(
        _probe_store(fabric), supervisor.probe_device())
    ok = store_ok and device_ok is not False
    body = {
        "ok": ok,
        "store": store_ok,
        "device": device_ok is not False,
        "supervisor": supervisor.status(
            device_ok=device_ok, include_events=_is_loopback(request)),
    }
    dh = supervisor.device_health
    if dh is not None:
        body["probe"] = {"device": str(dh.device), "ok": device_ok,
                         "failure": dh.last_failure()}
    return web.json_response(body, status=200 if ok else 503)


async def handle_readyz(request: web.Request) -> web.Response:
    """Readiness: can this worker make fresh content and real scores now?
    The supervisor's verdict (breakers, watchdog, device probe, device
    loss) and the store; 503 with Retry-After while degraded or draining.
    The SLO, overload, device-telemetry and canary blocks are advisory."""
    fabric = request.app[_FABRIC]
    supervisor = fabric.supervisor
    store_ok, device_ok = await asyncio.gather(
        _probe_store(fabric), supervisor.probe_device())
    status = supervisor.status(device_ok=device_ok,
                               include_events=_is_loopback(request))
    status["store"] = store_ok
    ready = bool(status["ready"]) and store_ok
    if fabric.draining:
        ready = False
        status["state"] = "draining"
    status["ready"] = ready
    engine = request.app[_SLO]
    engine.evaluate()
    status["slo"] = engine.status()
    status["overload"] = overload.status_block()
    status["device_telemetry"] = request.app[_DEVICE].device_block()
    # the canary's last verdict per target: advisory, like the SLO block
    prober = request.app[_PROBER]["prober"]
    status["canary"] = (prober.status_block() if prober is not None
                        else {"enabled": False})
    if ready:
        return web.json_response(status)
    if status.get("state") != "draining":
        status["state"] = "degraded"
    return web.json_response(
        status, status=503,
        headers={"Retry-After": str(int(supervisor.retry_after_s()))})


def _profile_capture(log_dir: str, seconds: float) -> dict:
    """Record ``seconds`` of host and CUDA activity into Chrome traces
    under ``log_dir``, as consecutive windows whose every stop and write
    is bounded (``utils/profiling.py::capture``); returns the windows."""
    from cassmantle_tpu_torch.utils import profiling

    return profiling.capture(log_dir, seconds)


async def handle_debug_trace(request: web.Request) -> web.Response:
    """``POST /debug/trace?seconds=N[&name=subdir]``: N seconds (at most
    60) of host and device activity, live traffic included, recorded by
    ``torch.profiler`` into Chrome traces, one per window of a bounded
    freeze (``utils/profiling.py::capture``), under a fixed root
    (``CASSMANTLE_TRACE_ROOT``, else the temp dir); ``name`` picks one
    sanitized subdirectory, never a path. Loopback or the cluster token
    only (403). One capture at a time: a second answers 409 while one
    runs. The capture runs on a worker thread, off the event loop. A
    failed capture answers 500 and counts ``obs.profiler_capture_failures``;
    a finished one counts ``obs.profiler_captures``."""
    if not _is_cluster_peer(request, request.app[_FABRIC]):
        raise web.HTTPForbidden(text="loopback or cluster peers only")
    try:
        seconds = min(60.0, float(request.query.get("seconds", "5")))
    except ValueError:
        raise web.HTTPBadRequest(text="seconds must be a number")
    if not seconds >= 0.0:
        raise web.HTTPBadRequest(text="seconds must be >= 0")
    name = request.query.get("name", "capture")
    if not re.fullmatch(r"[A-Za-z0-9._-]{1,64}", name) or ".." in name:
        raise web.HTTPBadRequest(text="name must be [A-Za-z0-9._-]{1,64}")
    root = os.environ.get("CASSMANTLE_TRACE_ROOT", os.path.join(
        tempfile.gettempdir(), "cassmantle_trace"))
    log_dir = os.path.join(root, name)
    state = request.app[_TRACE_STATE]
    # checked and set before the first await: single flight
    if state["active"]:
        raise web.HTTPConflict(text="a trace capture is already running")
    state["active"] = True
    capture = asyncio.get_running_loop().run_in_executor(
        None, _profile_capture, log_dir, seconds)
    # free only when the profiler has stopped, even if this request is
    # cancelled first
    capture.add_done_callback(lambda _: state.update(active=False))
    try:
        await asyncio.shield(capture)
    except asyncio.CancelledError:
        raise
    except Exception as exc:
        metrics.inc("obs.profiler_capture_failures")
        log.exception("profiler capture failed")
        raise web.HTTPInternalServerError(
            text=f"trace capture failed: {type(exc).__name__}: {exc}")
    metrics.inc("obs.profiler_captures")
    return web.json_response({"trace_dir": log_dir, "seconds": seconds})


def prober_of(app: web.Application):
    """The app's canary prober (None under CASSMANTLE_NO_PROBER or before
    startup)."""
    return app[_PROBER]["prober"]


# (wordlist tuple, payload bytes, quoted ETag), keyed on the identity of
# load_wordlist()'s cached tuple: serialized and hashed once a lexicon
_WORDLIST_CACHE: Optional[tuple] = None


def _wordlist_payload() -> bytes:
    global _WORDLIST_CACHE
    from cassmantle_tpu_torch.engine.masking import STOPWORDS
    from cassmantle_tpu_torch.server.assets import load_wordlist

    words = load_wordlist()
    cache = _WORDLIST_CACHE
    if cache is not None and cache[0] is words:
        return cache[1]
    payload = json.dumps({"words": list(words),
                          "stopwords": sorted(STOPWORDS),
                          "min_len": 2}).encode()
    etag = '"' + hashlib.sha256(payload).hexdigest()[:16] + '"'
    _WORDLIST_CACHE = (words, payload, etag)
    return payload


async def handle_wordlist(request: web.Request) -> web.Response:
    """The lexicon and stopwords of the client's spellcheck, with a
    content-hash ETag and ``no-cache`` (revalidate; a weak or listed
    If-None-Match still gets its 304)."""
    payload = _wordlist_payload()
    etag = _WORDLIST_CACHE[2]
    headers = {"Cache-Control": "no-cache", "ETag": etag}
    inm = request.headers.get("If-None-Match", "")
    client_tags = {t.strip().removeprefix("W/")
                   for t in inm.split(",") if t.strip()}
    if etag in client_tags or inm.strip() == "*":
        return web.Response(status=304, headers=headers)
    return web.Response(body=payload, content_type="application/json",
                        headers=headers)


async def _leak_scan_loop(interval_s: float) -> None:
    while True:
        await asyncio.sleep(interval_s)
        leak_sentinel.scan()


async def _slo_loop(engine: SloEngine, interval_s: float) -> None:
    """Evaluate the SLOs every ``interval_s``; the brownout ladder listens
    to each pass. An evaluation bug is counted and logged, never fatal."""
    while True:
        await asyncio.sleep(interval_s)
        try:
            engine.evaluate()
        except Exception:
            metrics.inc("slo.eval_failures")
            log.exception("slo evaluation failed; continuing")


def create_app(game: "Game | RoomFabric", cfg: FrameworkConfig,
               start_timer: bool = True,
               device_health: bool = False,
               self_addr: Optional[str] = None) -> web.Application:
    """The aiohttp app over a Game (wrapped as a one-room fabric) or a
    RoomFabric. ``device_health``: probe the serving device
    (``utils/health.py``) on ``/healthz`` and ``/readyz``, with a probe's
    raise classified by the recovery manager. ``self_addr``: this
    worker's own HTTP address (``http://127.0.0.1:<port>``), which the
    canary prober plays through; without it the prober uses the fabric's
    advertised address, or probes nothing until one is set
    (``prober_of(app).self_addr``)."""
    configure_observability(cfg.obs)
    # CASSMANTLE_CHAOS wins over cfg.chaos.spec; disarmed otherwise
    chaos.configure_from_env(cfg.chaos)
    if isinstance(game, RoomFabric):
        fabric = game
        fabric.start_timers = start_timer
    else:
        fabric = RoomFabric.for_game(game, cfg, start_timers=start_timer)
    # ratelimit outside tracing: a client spamming to 429s mints no traces
    app = web.Application(middlewares=[
        cors_middleware, make_ratelimit_middleware(cfg), tracing_middleware])
    app[_FABRIC] = fabric
    app[_OBS_CFG] = cfg.obs
    app[_PEER_HTTP] = {"session": None}
    app[_OBS_TASKS] = []
    app[_PROBER] = {"prober": None}
    app[_TRACE_STATE] = {"active": False}
    app[_SLO] = SloEngine(default_objectives(cfg),
                          fast_window_s=cfg.obs.slo_fast_window_s,
                          slow_window_s=cfg.obs.slo_slow_window_s)
    # the ladder subscribes to every evaluation (CASSMANTLE_NO_BROWNOUT=1
    # pins tier 0)
    overload.configure_brownout(cfg, app[_SLO])
    app[_PROCESS] = ProcessMetrics()
    device = fabric.device
    # no serving device (a fake backend): no devices to report
    app[_DEVICE] = (DeviceMetrics(device=device) if device is not None
                    else DeviceMetrics(devices_fn=list))
    device_obs.install(app[_DEVICE])
    if device_health:
        from cassmantle_tpu_torch.utils.health import DeviceHealth

        dh = DeviceHealth(device=device if device is not None else "cuda")
        fabric.supervisor.device_health = dh
        recovery = fabric.supervisor.recovery
        if recovery is not None:
            # a probe's raise rides the device-loss classifier
            dh.on_probe_error = recovery.note_probe_exception
    app.router.add_get("/", handle_root)
    app.router.add_get("/init", handle_init)
    app.router.add_get("/client/status", handle_status)
    app.router.add_get("/fetch/contents", handle_fetch_contents)
    app.router.add_post("/compute_score", handle_compute_score)
    app.router.add_get("/clock", handle_clock)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/debugz", handle_debugz)
    app.router.add_get("/sloz", handle_sloz)
    app.router.add_get("/healthz", handle_healthz)
    app.router.add_get("/readyz", handle_readyz)
    app.router.add_get("/wordlist", handle_wordlist)
    app.router.add_post("/debug/trace", handle_debug_trace)
    for prefix, path in (("/static", STATIC_DIR), ("/data", DATA_DIR),
                         ("/media", MEDIA_DIR)):
        if os.path.isdir(path):
            app.router.add_static(prefix, path)

    async def on_startup(app_: web.Application) -> None:
        await fabric.startup()
        loop = asyncio.get_running_loop()
        interval = cfg.obs.process_sample_interval_s
        tasks = app_[_OBS_TASKS]
        tasks.append(loop.create_task(app_[_PROCESS].run(interval)))
        tasks.append(loop.create_task(app_[_DEVICE].run(interval)))
        if not _env_flag_set("CASSMANTLE_NO_SLO"):
            tasks.append(loop.create_task(
                _slo_loop(app_[_SLO], cfg.obs.slo_eval_interval_s)))
        # the canary plays the game through this worker's own listener;
        # under CASSMANTLE_NO_PROBER: no task, no metric, no store key
        if not prober_disabled():
            prober = CanaryProber(fabric, cfg, self_addr=self_addr)
            app_[_PROBER]["prober"] = prober
            tasks.append(loop.create_task(prober.run()))
        # opt-in leak census (CASSMANTLE_LEAK_SENTINEL=1), log-only, at
        # the process sampler's cadence: growth of the tracked threads and
        # tasks counts leaks.* and records leak.detected
        leak_sentinel.maybe_enable_from_env()
        if leak_sentinel.sentinel_active():
            tasks.append(loop.create_task(_leak_scan_loop(interval)))

    async def on_shutdown(app_: web.Application) -> None:
        # graceful handoff: leave membership and drain the rooms before
        # the process dies (the listeners are already closed here)
        try:
            await fabric.handoff()
        except Exception:
            log.exception("graceful handoff failed; shutting down anyway")

    async def on_cleanup(app_: web.Application) -> None:
        for task in app_[_OBS_TASKS]:
            task.cancel()
        for task in app_[_OBS_TASKS]:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        session = app_[_PEER_HTTP].get("session")
        if session is not None:
            await session.close()
        await fabric.shutdown()
        if device_obs.active() is app_[_DEVICE]:
            device_obs.install(None)

    app.on_startup.append(on_startup)
    app.on_shutdown.append(on_shutdown)
    app.on_cleanup.append(on_cleanup)
    return app


def _build_store(store_addr: Optional[str], cfg: FrameworkConfig):
    """The worker's store: a MemoryStore (one process); a MantleStore
    (``native[:port]``, one node that the workers share; default port
    7070); or a ReplicatedStore (``repl:host:port,host:port``, else
    CASSMANTLE_REPL_ENDPOINTS, else ``fabric.repl_endpoints``: a leader
    and followers with lease failover; CASSMANTLE_REPL_LEASE_MS and
    CASSMANTLE_REPL_POLL_MS override the lease and the pump's poll). A
    mistyped address raises ValueError and a native node that does not
    answer raises ConnectionError here; a replicated set with no
    promotable leader raises at startup, when the store elects one. None
    falls back to a per-process store: a fleet would split into separate
    games."""
    from cassmantle_tpu_torch.engine.store import MemoryStore, ReplicatedStore

    endpoints = os.environ.get("CASSMANTLE_REPL_ENDPOINTS", "")
    endpoints = tuple(e.strip() for e in endpoints.split(",") if e.strip()) \
        or tuple(cfg.fabric.repl_endpoints)
    if store_addr and store_addr.startswith("repl:"):
        endpoints = tuple(e.strip() for e in
                          store_addr[len("repl:"):].split(",") if e.strip())
        store_addr = None
    if endpoints:
        lease_ms = os.environ.get("CASSMANTLE_REPL_LEASE_MS")
        poll_ms = os.environ.get("CASSMANTLE_REPL_POLL_MS")
        return ReplicatedStore(
            list(endpoints),
            poll_interval_s=(float(poll_ms) / 1000.0 if poll_ms
                             else cfg.fabric.repl_poll_s),
            lease_timeout_s=(float(lease_ms) / 1000.0 if lease_ms
                             else cfg.fabric.repl_lease_s))
    if store_addr:
        m = re.fullmatch(r"native(?::(\d+))?", store_addr)
        if not m:
            raise ValueError(
                f"unknown store address {store_addr!r} (expected "
                f"'native[:port]' or 'repl:host:port,host:port')")
        from cassmantle_tpu_torch.native.client import MantleStore

        port = int(m.group(1) or 7070)
        try:
            socket.create_connection(("127.0.0.1", port), timeout=2.0).close()
        except OSError as exc:
            raise ConnectionError(
                f"store {store_addr!r}: no mantlestore answers on "
                f"127.0.0.1:{port} ({exc})") from exc
        return MantleStore(port=port)
    return MemoryStore()


@dataclasses.dataclass
class _Serving:
    """What every room's Game shares: one serving stack per worker."""

    backend: object
    embed: object
    similarity: object
    blur_fn: object
    pin_answers: object
    device: object = None          # the serving device; None: fake
    services: tuple = ()           # components with an async stop()


def _serving_components(cfg: FrameworkConfig, fake: bool,
                        weights_dir: Optional[str], supervisor,
                        device="cuda") -> _Serving:
    """The serving stack, built once a worker: the fake backend (hash
    embeddings and similarity; the drill scorer under
    ``fake_score_batch_ms``; the fake table under
    ``CASSMANTLE_FAKE_EMBED_TABLE=1``) or the port's InferenceService on
    ``device``."""
    if fake:
        from cassmantle_tpu_torch.engine.content import (
            FakeContentBackend,
            hash_embed,
            hash_similarity,
        )
        from cassmantle_tpu_torch.ops.embed_table import fake_table_enabled

        similarity, pin_answers, services = hash_similarity, None, ()
        if cfg.serving.fake_score_batch_ms > 0:
            from cassmantle_tpu_torch.serving.fake_scorer import (
                FakeQueuedScorer,
            )

            scorer = FakeQueuedScorer(cfg, supervisor)
            similarity, services = scorer.similarity, (scorer,)
        if fake_table_enabled():
            from cassmantle_tpu_torch.ops.embed_table import (
                TableFirstSimilarity,
                build_fake_table,
                pin_answers_hash,
            )

            table = build_fake_table()
            similarity = TableFirstSimilarity(table, similarity)
            pin_answers = functools.partial(pin_answers_hash, table)
        return _Serving(FakeContentBackend(image_size=256), hash_embed,
                        similarity, None, pin_answers, services=services)
    from cassmantle_tpu_torch.serving.service import InferenceService

    service = InferenceService(cfg, device=device, weights_dir=weights_dir,
                               supervisor=supervisor)
    return _Serving(service.content_backend, service.embed,
                    service.similarity, service.blur, service.pin_answers,
                    device=service.device, services=(service,))


def build_game(cfg: FrameworkConfig, fake: bool = False,
               weights_dir: Optional[str] = None,
               store_addr: Optional[str] = None, device="cuda") -> Game:
    """One Game over the fake backend or the port's InferenceService on
    ``device`` (default the card; raises without CUDA), on the store
    ``store_addr`` names (:func:`_build_store`). Multi-room serving goes
    through :func:`build_fabric`."""
    from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor

    supervisor = ServingSupervisor()
    store = _build_store(store_addr, cfg)
    s = _serving_components(cfg, fake, weights_dir, supervisor, device)
    return Game(cfg, store, s.backend, embed=s.embed,
                similarity=s.similarity, blur_fn=s.blur_fn,
                supervisor=supervisor, pin_answers=s.pin_answers)


def apply_fabric_env(cfg: FrameworkConfig) -> FrameworkConfig:
    """Fold CASSMANTLE_ROOM_COUNT into the config, so every reader of
    ``cfg.fabric`` sees one value."""
    rooms_env = os.environ.get("CASSMANTLE_ROOM_COUNT")
    if rooms_env:
        cfg = cfg.replace(fabric=dataclasses.replace(
            cfg.fabric, num_rooms=int(rooms_env)))
    return cfg


def build_fabric(cfg: FrameworkConfig, fake: bool = False,
                 weights_dir: Optional[str] = None,
                 store_addr: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 advertise_addr: Optional[str] = None,
                 device="cuda") -> RoomFabric:
    """The room fabric of one worker: its store (``store_addr``, see
    :func:`_build_store`), one serving stack on ``device`` (default the
    card; raises without CUDA) and per-room Games built on demand. Env
    overrides: CASSMANTLE_ROOM_COUNT, CASSMANTLE_ROOM_WORKER_ID,
    CASSMANTLE_ROOM_ADVERTISE, CASSMANTLE_REPL_ENDPOINTS,
    CASSMANTLE_REPL_LEASE_MS, CASSMANTLE_REPL_POLL_MS."""
    from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor

    cfg = apply_fabric_env(cfg)
    worker_id = (worker_id or os.environ.get("CASSMANTLE_ROOM_WORKER_ID")
                 or cfg.fabric.worker_id
                 or f"{os.uname().nodename}:{os.getpid()}")
    advertise_addr = (advertise_addr
                      or os.environ.get("CASSMANTLE_ROOM_ADVERTISE")
                      or cfg.fabric.advertise_addr)
    supervisor = ServingSupervisor()
    store = _build_store(store_addr, cfg)
    s = _serving_components(cfg, fake, weights_dir, supervisor, device)

    def game_factory(room: str, room_store) -> Game:
        # room= labels the game's engine series per room
        return Game(cfg, room_store, s.backend, embed=s.embed,
                    similarity=s.similarity, blur_fn=s.blur_fn,
                    supervisor=supervisor, room=room,
                    pin_answers=s.pin_answers)

    fabric = RoomFabric(cfg, store, game_factory, worker_id=worker_id,
                        advertise_addr=advertise_addr, supervisor=supervisor)
    fabric.device = s.device
    fabric.services.extend(s.services)
    return fabric


def _config_for(args) -> FrameworkConfig:
    """The serving config the flags name."""
    from cassmantle_tpu_torch import config as c

    cfg = {"sdxl": c.sdxl_config, "fast": c.fast_serving_config,
           "deepcache": c.deepcache_serving_config,
           "turbo": c.turbo_serving_config}.get(args.preset,
                                                c.FrameworkConfig)()
    if args.round_seconds:
        cfg = cfg.replace(game=dataclasses.replace(
            cfg.game, time_per_prompt=args.round_seconds))
    if args.lm == "mistral":
        cfg = cfg.replace(models=dataclasses.replace(
            cfg.models, mistral=c.MistralConfig()))
    if args.lm_int8:
        cfg = cfg.replace(models=dataclasses.replace(
            cfg.models, lm_int8=True))
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="cassmantle game server (PyTorch port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--fake", action="store_true",
                        help="deterministic fake content backend (no device)")
    parser.add_argument("--weights", default=None,
                        help="checkpoint directory (absent files: the seeded "
                             "init)")
    parser.add_argument("--round-seconds", type=float, default=None)
    parser.add_argument("--store", default=None,
                        help="'native[:port]' = one shared mantlestore node "
                             "(native/mantlestore.cc; "
                             "cassmantle_tpu_torch.native.client."
                             "spawn_server starts one); "
                             "'repl:host:port,host:port' = a replicated "
                             "set (leader writes, log shipping, lease "
                             "failover); default: this process's own "
                             "MemoryStore")
    parser.add_argument("--rooms", type=int, default=None,
                        help="concurrent game rooms (default 1)")
    parser.add_argument("--worker-id", default=None,
                        help="stable worker identity for room placement "
                             "(default host:pid)")
    parser.add_argument("--advertise", default=None,
                        help="address peers redirect this worker's rooms "
                             "to, e.g. http://10.0.0.3:8000 (unset: no "
                             "redirects to it; foreign rooms serve "
                             "locally)")
    parser.add_argument("--preset", default="sd15",
                        choices=("sd15", "sdxl", "fast", "deepcache",
                                 "turbo"),
                        help="sd15 = SD1.5-512 DDIM-50; sdxl = SDXL-base "
                             "1024; fast = DPM++(2M) at 25 steps; deepcache "
                             "= DDIM-50 with deep-feature reuse; turbo = "
                             "DPM++(2M) at 24 steps with DeepCache")
    parser.add_argument("--platform", default="auto",
                        choices=("auto", "cpu"),
                        help="auto = the CUDA card (raises without one); "
                             "cpu = the port's plain PyTorch path on the host")
    parser.add_argument("--lm", default="gpt2", choices=("gpt2", "mistral"),
                        help="the prompt LM: GPT-2 or a Mistral-7B-class "
                             "model")
    parser.add_argument("--lm-int8", action="store_true",
                        help="weights-only int8 prompt LM (loads "
                             "<family>.int8.safetensors from --weights when "
                             "it is there; see quantize-weights)")
    parser.add_argument("--workers", type=int, default=1,
                        help="worker processes sharing the port "
                             "(SO_REUSEPORT) and one --store (required "
                             "above 1): every worker runs the lock-guarded "
                             "round timer, exactly one generates a round")
    args = parser.parse_args(argv)
    if args.workers > 1:
        if not (args.store and args.store.startswith(("native", "repl:"))):
            parser.error("--workers > 1 requires --store native[:port] "
                         "or repl:... (a shared native store is the "
                         "coordination plane; per-process MemoryStores "
                         "would each run their own game)")
        if not (args.fake or args.platform == "cpu"):
            parser.error("--workers > 1 needs --fake or --platform cpu: "
                         "one card has one owning process (a card worker "
                         "joins a fleet through --store repl:... and "
                         "--advertise)")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = _config_for(args)
    if args.workers > 1:
        _run_workers(args, cfg)
    else:
        _run_worker(args, cfg)


def _run_workers(args, cfg: FrameworkConfig) -> None:
    """This process and ``args.workers - 1`` more serve one port. A
    watcher thread waits on every worker's sentinel at once and counts a
    worker that died of anything but SIGINT or SIGTERM
    (``server.worker_deaths``, a ``server.worker_death`` event). At exit
    the workers get SIGINT (their graceful handoff), 5 s, then SIGTERM."""
    import multiprocessing
    import signal
    import threading
    from multiprocessing.connection import wait as mp_wait

    # spawn, not fork: this process has imported torch, whose thread pools
    # and lazy CUDA state a forked child would inherit half-made; a
    # spawned worker starts a fresh interpreter and never touches CUDA
    # (--fake or --platform cpu)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run_worker, args=(args, cfg), daemon=True)
             for _ in range(args.workers - 1)]
    for p in procs:
        p.start()

    def watch() -> None:
        pending = {p.sentinel: p for p in procs}
        while pending:
            for sentinel in mp_wait(list(pending)):
                p = pending.pop(sentinel)
                p.join()
                if p.exitcode not in (0, None, -signal.SIGINT,
                                      -signal.SIGTERM):
                    log.error("worker pid=%s died with exit code %s",
                              p.pid, p.exitcode)
                    metrics.inc("server.worker_deaths")
                    flight_recorder.record("server.worker_death",
                                           pid=p.pid, exitcode=p.exitcode)

    threading.Thread(target=watch, name="worker-watch", daemon=True).start()
    try:
        _run_worker(args, cfg)
    finally:
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGINT)
        for p in procs:
            p.join(timeout=5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)


def _run_worker(args, cfg: FrameworkConfig) -> None:
    if args.rooms:
        cfg = cfg.replace(fabric=dataclasses.replace(
            cfg.fabric, num_rooms=args.rooms))
    cfg = apply_fabric_env(cfg)
    device = "cpu" if args.platform == "cpu" else "cuda"
    fabric = build_fabric(cfg, fake=args.fake, weights_dir=args.weights,
                          store_addr=args.store, worker_id=args.worker_id,
                          advertise_addr=args.advertise, device=device)
    # the canary plays through this worker's own listener, on loopback
    web.run_app(create_app(fabric, cfg, device_health=not args.fake,
                           self_addr=f"http://127.0.0.1:{args.port}"),
                host=args.host, port=args.port,
                reuse_port=args.workers > 1)


if __name__ == "__main__":
    main()
