"""The port's game server (``cassmantle_tpu_torch/server/app.py``) held
against the reference's (``cassmantle_tpu/server/app.py``).

One scripted HTTP session is played over each package's ``create_app``
on its own ``build_fabric(cfg, fake=True)`` (``FakeContentBackend``,
``hash_embed``, ``hash_similarity``; one room, the same seeds) through
``aiohttp.test_utils.TestClient``: every route the slice ports, the 400
path, an unknown room, the wordlist's 304, the degraded floor and the
hedge's 503, a ``traceparent`` continued and looked up at ``/debugz``,
both ``/metrics`` forms, the ``/clock`` websocket. Status codes, JSON
bodies and the headers the reference's own code sets must be equal,
apart from session ids, trace ids, clocks and the blocks that name the
backend (``device_telemetry``, the fabric's worker stamps). Both apps
run with ``CASSMANTLE_NO_PROBER=1``, so the script compares them without
probe traffic (the prober itself is held against the reference in
``test_torch_port_prober.py``). The script runs on the plain fake scorer, on the
drill scorer behind a real queue (``fake_score_batch_ms``: the
``X-Queue-Wait`` header) and behind the fake int8 table.

Beside it: the rate limiter's 429 over both apps, the serve command's
parsing and refusals, the no-card refusal, and one full-stack round over
the port's real ``InferenceService`` on the CPU at ``test_config()``.
"""

import asyncio
import base64
import dataclasses

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import cassmantle_tpu.config as jconfig
import cassmantle_tpu.server.app as japp
import cassmantle_tpu_torch.config as pconfig
import cassmantle_tpu_torch.server.app as papp
from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.serving import overload as poverload

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

PACKAGES = {"reference": (japp, jconfig), "port": (papp, pconfig)}
# the headers the reference's own code sets (aiohttp adds the rest)
APP_HEADERS = ("Access-Control-Allow-Origin",
               "Access-Control-Allow-Credentials",
               "Access-Control-Allow-Methods",
               "Access-Control-Allow-Headers", "X-Trace-Id", "Retry-After",
               "X-Score-Degraded", "X-Quality-Degraded", "X-Queue-Wait",
               "X-Service-Time", "X-Overload-Shed", "ETag", "Cache-Control",
               "Content-Type")
# their values differ run to run: compared by presence
VARYING = {"X-Trace-Id", "X-Queue-Wait", "X-Service-Time"}
TRACE = "0af7651916cd43dd8448eb211c80319c"


@pytest.fixture(autouse=True)
def _reset_globals(monkeypatch):
    """The tracer, registry, ladder and chaos plan are process globals of
    each package: every test starts from disarmed plans, and the port's
    from no ladder (each create_app configures its own; the reference has
    no reset)."""
    monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    for var in ("CASSMANTLE_NO_SLO", "CASSMANTLE_NO_BROWNOUT",
                "CASSMANTLE_CHAOS", "CASSMANTLE_FAKE_EMBED_TABLE",
                "CASSMANTLE_ROOM_COUNT", "CASSMANTLE_NO_TAIL_SAMPLING"):
        monkeypatch.delenv(var, raising=False)
    jchaos.disarm()
    pchaos.disarm()
    poverload.reset_brownout()
    yield
    jchaos.disarm()
    pchaos.disarm()
    poverload.reset_brownout()


def make_cfg(config, rate=1000.0, **serving):
    cfg = config.test_config()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=30.0,
                                 rate_limit_default=rate,
                                 rate_limit_api=rate),
        serving=dataclasses.replace(cfg.serving, **serving))


def _headers(res) -> dict:
    out = {}
    for name in APP_HEADERS:
        if name in res.headers:
            out[name] = (True if name in VARYING else res.headers[name])
    if "Retry-After" in out:
        out["Retry-After"] = int(out["Retry-After"]) >= 1
    return out


def _scrub_status(body: dict) -> dict:
    """A supervisor/readiness body without what names the backend or the
    clock."""
    body = dict(body)
    body.pop("device_telemetry", None)
    fabric = body.pop("fabric", None)
    if fabric is not None:
        body["fabric"] = {k: fabric[k] for k in ("rooms", "owned", "active",
                                                 "draining")}
        body["fabric_workers"] = sorted(fabric["workers"])
    if "overload" in body:
        body["overload"] = {k: v for k, v in body["overload"].items()
                            if k != "queues"}
    if "watchdog" in body:
        body["watchdog"] = {k: v for k, v in body["watchdog"].items()
                            if k != "degraded_for_s"}
    if "breakers" in body:
        body["breakers"] = {
            name: {k: v for k, v in b.items() if k != "retry_after_s"}
            for name, b in body["breakers"].items()}
    body.pop("events", None)
    if "slo" in body:
        body["slo"] = {n: o["state"]
                       for n, o in body["slo"]["objectives"].items()}
    if "supervisor" in body:
        body["supervisor"] = _scrub_status(body["supervisor"])
    return body


async def _play(which: str, variant: str, monkeypatch) -> list:
    """The scripted session over one package's app: a list of
    (step, status, app headers, normalized body)."""
    app_mod, config = PACKAGES[which]
    if variant == "table":
        monkeypatch.setenv("CASSMANTLE_FAKE_EMBED_TABLE", "1")
    cfg = make_cfg(config, fake_score_batch_ms=(2.0 if variant == "queued"
                                                else 0.0))
    fabric = app_mod.build_fabric(cfg, fake=True, worker_id="parity")
    app = app_mod.create_app(fabric, cfg, start_timer=False)
    client = TestClient(TestServer(app))
    await client.start_server()
    out = []

    async def step(name, method, path, norm=lambda b: b, **kw):
        res = await client.request(method, path, **kw)
        ctype = res.headers.get("Content-Type", "")
        if "json" in ctype:
            body = norm(await res.json())
        elif res.status >= 400 or "text/plain" in ctype:
            body = norm(await res.text())
        else:
            body = len(await res.read())
        out.append((name, res.status, _headers(res), body))
        return res

    try:
        await step("root", "GET", "/")
        await step("status_fresh", "GET", "/client/status")
        res = await step(
            "init", "GET", "/init",
            norm=lambda b: {k: v for k, v in b.items() if k != "session_id"})
        out.append(("init_cookies", sorted(res.cookies)))
        await step("status", "GET", "/client/status")
        game = await fabric.game_for(fabric.default_room)
        prompt = await game.rounds.fetch_current_prompt()
        masks = prompt["masks"]
        answers = {str(m): prompt["tokens"][m] for m in masks}
        await step("fetch", "GET", "/fetch/contents")
        await step("guess", "POST", "/compute_score",
                   json={"inputs": {str(masks[0]): "stormy",
                                    str(masks[1]): "zzqxv"}})
        await step("bad_body", "POST", "/compute_score", data=b"not json")
        await step("unknown_room", "GET", "/client/status",
                   params={"room": "nope"})
        await step("win", "POST", "/compute_score",
                   json={"inputs": answers})
        await step("fetch_won", "GET", "/fetch/contents",
                   norm=lambda b: {k: b[k] for k in ("prompt", "story")})
        res = await step("wordlist", "GET", "/wordlist")
        etag = res.headers["ETag"]
        await step("wordlist_304", "GET", "/wordlist",
                   headers={"If-None-Match": f'W/{etag}, "other"'})
        await step("healthz", "GET", "/healthz", norm=_scrub_status)
        await step("readyz", "GET", "/readyz", norm=_scrub_status)
        await step("sloz", "GET", "/sloz",
                   norm=lambda b: {n: o["state"] for n, o in
                                   b["objectives"].items()})
        # a traceparent from loopback continues its trace
        res = await step("traced", "GET", "/client/status", headers={
            "traceparent": f"00-{TRACE}-b7ad6b7169203331-01"})
        out.append(("trace_id", res.headers["X-Trace-Id"] == TRACE))
        await step("debugz_trace", "GET", "/debugz",
                   params={"trace": TRACE},
                   norm=lambda b: (b["trace_id"],
                                   sorted(s["name"] for s in b["spans"])))
        await step("debugz", "GET", "/debugz", norm=sorted)
        await step("debugz_missing", "GET", "/debugz",
                   params={"trace": "f" * 32})
        await step("metrics", "GET", "/metrics", norm=sorted)
        res = await step("metrics_text", "GET", "/metrics",
                         headers={"Accept": "text/plain"},
                         norm=lambda t: "cassmantle_http_init_total" in t)
        # the degraded ladder: floor scores, marked; a hedge sheds 503
        breaker = fabric.supervisor.score_breaker
        for _ in range(breaker.failure_threshold):
            breaker.record_failure()
        await step("floor", "POST", "/compute_score",
                   json={"inputs": {str(masks[0]): "word"}})
        await step("hedged", "POST", "/compute_score",
                   json={"inputs": {str(masks[0]): "word"}},
                   headers={"X-Score-Hedge": "1"})
        await step("readyz_degraded", "GET", "/readyz", norm=_scrub_status)
        breaker.record_success()
        await step("recovered", "POST", "/compute_score",
                   json={"inputs": {str(masks[0]): "word"}})
        ws = await client.ws_connect("/clock")
        msg = await asyncio.wait_for(ws.receive_json(), timeout=5.0)
        out.append(("clock", sorted(msg), msg["reset"], msg["conns"]))
        await ws.close()
    finally:
        await client.close()
    return out


@pytest.mark.parametrize("variant", ["hash", "queued", "table"])
def test_scripted_session_matches_reference(variant, monkeypatch):
    ref = asyncio.run(_play("reference", variant, monkeypatch))
    port = asyncio.run(_play("port", variant, monkeypatch))
    assert [s[0] for s in port] == [s[0] for s in ref]
    for r, p in zip(ref, port):
        assert p == r, f"step {r[0]}: port {p!r} != reference {r!r}"
    if variant == "queued":
        guess = next(s for s in port if s[0] == "guess")
        assert guess[2]["X-Queue-Wait"] and guess[2]["X-Service-Time"]


async def _rate_limited(which: str) -> list:
    app_mod, config = PACKAGES[which]
    cfg = make_cfg(config)
    cfg = cfg.replace(game=dataclasses.replace(cfg.game, rate_limit_api=2.0))
    app = app_mod.create_app(app_mod.build_fabric(cfg, fake=True,
                                                  worker_id="rl"),
                             cfg, start_timer=False)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = []
        for _ in range(5):
            res = await client.get("/client/status")
            out.append((res.status, res.headers.get("Retry-After")))
        # another route class has its own bucket
        res = await client.get("/wordlist")
        out.append((res.status, None))
        return out
    finally:
        await client.close()


def test_rate_limit_429_matches_reference():
    ref = asyncio.run(_rate_limited("reference"))
    port = asyncio.run(_rate_limited("port"))
    assert port == ref
    assert (429, "1") in port


@pytest.mark.parametrize("argv,match", [
    (["--workers", "2"], "requires --store native"),
    (["--workers", "2", "--store", "native"], "needs --fake or --platform"),
])
def test_serve_refuses_what_later_slices_bring(argv, match, capsys):
    """The reference's two refusals of many workers: without a shared
    store, and on the card (one card has one owning process)."""
    with pytest.raises(SystemExit) as exc:
        papp.parse_args(argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    ([], "FrameworkConfig"),
    (["--preset", "sdxl"], "sdxl_config"),
    (["--preset", "fast"], "fast_serving_config"),
    (["--preset", "deepcache"], "deepcache_serving_config"),
    (["--preset", "turbo"], "turbo_serving_config"),
])
def test_serve_presets_are_the_reference_configs(argv, want):
    """Each --preset builds the config the reference's server builds;
    --round-seconds and --lm mistral apply as there."""
    args = papp.parse_args(argv + ["--round-seconds", "7", "--lm",
                                   "mistral"])
    cfg = papp._config_for(args)
    ref = getattr(jconfig, want)()
    ref = ref.replace(
        game=dataclasses.replace(ref.game, time_per_prompt=7.0),
        models=dataclasses.replace(ref.models,
                                   mistral=jconfig.MistralConfig()))
    assert (args.host, args.port, args.platform, args.workers) == \
        ("0.0.0.0", 8000, "auto", 1)
    for section in ("sampler", "game"):
        for f in dataclasses.fields(getattr(cfg, section)):
            assert getattr(getattr(cfg, section), f.name) == \
                getattr(getattr(ref, section), f.name), (section, f.name)
    assert (cfg.models.clip_text_2 is None) == \
        (ref.models.clip_text_2 is None)
    assert cfg.models.mistral == pconfig.MistralConfig()


@pytest.mark.parametrize("build", ["main", "build_fabric", "build_game"])
def test_serving_without_a_card_raises(build, monkeypatch):
    """Without --platform cpu or --fake the server serves on the card: on
    a host without CUDA it raises, and never serves from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    served = []
    monkeypatch.setattr(papp.web, "run_app",
                        lambda *a, **kw: served.append(a))
    cfg = pconfig.test_config()
    call = {"main": lambda: papp.main(["--port", "0"]),
            "build_fabric": lambda: papp.build_fabric(cfg),
            "build_game": lambda: papp.build_game(cfg)}[build]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not served


def _unused_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("case", ["mistyped", "unreachable"])
def test_build_fabric_refuses_a_shared_store(case):
    """A store address the worker cannot use raises at boot, never serves
    from a per-process MemoryStore: a mistyped address (ValueError, as the
    reference's), a native node nobody listens for (ConnectionError)."""
    cfg = pconfig.test_config()
    if case == "mistyped":
        for addr in ("native:x", "redis://localhost:6379", "nativ"):
            with pytest.raises(ValueError, match="unknown store address"):
                papp.build_fabric(cfg, fake=True, store_addr=addr)
            with pytest.raises(ValueError, match="unknown store address"):
                japp._build_store(addr, jconfig.test_config())
    else:
        with pytest.raises(ConnectionError, match="no mantlestore answers"):
            papp.build_fabric(cfg, fake=True,
                              store_addr=f"native:{_unused_port()}")


def test_full_stack_real_backend_round():
    """HTTP -> engine -> the port's real serving stack on the CPU (the
    tiny CLIP -> DDIM -> VAE pipeline, GPT-2 decode, MiniLM scorer): a
    client initializes, fetches a generated round's JPEG at the
    configured size, scores an out-of-vocabulary guess through the score
    queue (the queue's headers ride the response), reads the probe's
    verdict on /healthz, and the service's queues stop with the app."""
    from PIL import Image
    import io

    cfg = make_cfg(pconfig)

    async def play():
        fabric = papp.build_fabric(cfg, device="cpu", worker_id="full")
        (service,) = fabric.services
        app = papp.create_app(fabric, cfg, start_timer=False,
                              device_health=True)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await client.get("/init")
            res = await client.get("/fetch/contents")
            data = await res.json()
            image = np.asarray(Image.open(io.BytesIO(
                base64.b64decode(data["image"]))))
            assert image.shape == (cfg.sampler.image_size,) * 2 + (3,)
            prompt = data["prompt"]
            assert prompt["tokens"] and len(prompt["masks"]) == 2
            res = await client.post(
                "/compute_score",
                json={"inputs": {str(prompt["masks"][0]): "zzqxv"}})
            assert res.status == 200
            assert "won" in await res.json()
            # out of the table: the guess rode the score queue
            assert float(res.headers["X-Queue-Wait"]) >= 0.0
            res = await client.get("/healthz")
            body = await res.json()
            assert res.status == 200 and body["device"] is True
            assert body["probe"] == {"device": "cpu", "ok": True,
                                     "failure": None}
            res = await client.get("/metrics")
            counters = (await res.json())["counters"]
            assert counters["pipeline.images"] >= 1
        finally:
            await client.close()
        # the app's cleanup stopped the service's queues
        assert service.score_queue._task is None
        assert service.prompt_queue._task is None

    asyncio.run(play())
