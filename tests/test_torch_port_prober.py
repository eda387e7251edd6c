"""The port's canary prober (``cassmantle_tpu_torch/obs/prober.py``) and
its server surface held against the reference's
(``cassmantle_tpu/obs/prober.py``, ``cassmantle_tpu/server/app.py``).

Each package's app runs on its own ``build_fabric(cfg, fake=True)`` at
``test_config()`` behind ``aiohttp.test_utils.TestServer`` with
``CASSMANTLE_NO_PROBER`` unset; the prober plays through the server's
own listener (its ``self_addr`` set once the server is up). Held equal:
the probe's content (sentence, masks, answers, image), the verdicts and
the ``/readyz`` canary block's keys on the plain hash scorer, the drill
scorer behind a real queue and the fake int8 table; a near guess scored
at the floor (every score dispatch failing under chaos) failing at leg
``score`` with its trace retained; the probe room's 404 to outsiders;
and F1: with the switch unset the two probe objectives carry probe
traffic at ``/sloz``, with it set no probe artifact exists.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import cassmantle_tpu.config as jconfig
import cassmantle_tpu.server.app as japp
import cassmantle_tpu_torch.config as pconfig
import cassmantle_tpu_torch.server.app as papp
from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu.engine.content import hash_embed as jhash_embed
from cassmantle_tpu.obs import prober as jprober
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.engine.content import hash_embed as phash_embed
from cassmantle_tpu_torch.engine.game import PROBE_ROOM
from cassmantle_tpu_torch.obs import flight_recorder
from cassmantle_tpu_torch.obs import prober as pprober
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.utils.logging import metrics

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

PACKAGES = {"reference": (japp, jconfig, jchaos),
            "port": (papp, pconfig, pchaos)}
VARIANTS = ("plain", "queued", "table")


@pytest.fixture(autouse=True)
def _reset_globals(monkeypatch):
    for var in ("CASSMANTLE_NO_PROBER", "CASSMANTLE_PROBE_INTERVAL_S",
                "CASSMANTLE_NO_SLO", "CASSMANTLE_NO_BROWNOUT",
                "CASSMANTLE_CHAOS", "CASSMANTLE_FAKE_EMBED_TABLE",
                "CASSMANTLE_NO_EMBED_TABLE", "CASSMANTLE_ROOM_COUNT",
                "CASSMANTLE_NO_TAIL_SAMPLING"):
        monkeypatch.delenv(var, raising=False)
    jchaos.disarm()
    pchaos.disarm()
    poverload.reset_brownout()
    yield
    jchaos.disarm()
    pchaos.disarm()
    poverload.reset_brownout()


def make_cfg(config, variant: str, monkeypatch):
    if variant == "table":
        monkeypatch.setenv("CASSMANTLE_FAKE_EMBED_TABLE", "1")
    cfg = config.test_config()
    return cfg.replace(
        game=dataclasses.replace(cfg.game, time_per_prompt=30.0,
                                 rate_limit_default=1000.0,
                                 rate_limit_api=1000.0),
        serving=dataclasses.replace(
            cfg.serving,
            fake_score_batch_ms=2.0 if variant == "queued" else 0.0))


async def _with_app(which: str, variant: str, monkeypatch, body):
    """``body(app, client, fabric, prober)`` against one package's app,
    its prober addressed at the test server."""
    app_mod = PACKAGES[which][0]
    cfg = make_cfg(PACKAGES[which][1], variant, monkeypatch)
    fabric = app_mod.build_fabric(cfg, fake=True, worker_id="canary")
    app = app_mod.create_app(fabric, cfg, start_timer=False)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        prober = app[app_mod._PROBER]["prober"]
        if prober is not None:
            prober.self_addr = str(client.make_url("")).rstrip("/")
        return await body(app, client, fabric, prober)
    finally:
        await client.close()


@pytest.mark.parametrize("embed", ["reference", "port"])
def test_probe_content_equals_reference(embed):
    """Sentence, masks, answers and image: equal for the same embed
    function, whichever package's hash embedding it is."""
    fn = jhash_embed if embed == "reference" else phash_embed
    games = [types.SimpleNamespace(rounds=types.SimpleNamespace(
        embed=fn, num_masked=2)) for _ in range(2)]
    want, got = jprober.probe_state(games[0]), pprober.probe_state(games[1])
    assert got == want
    assert pprober.probe_state(games[1]) is got          # kept on the game
    assert pprober.probe_answers(got) == jprober.probe_answers(want)
    assert len(pprober.probe_answers(got)) == 2
    np.testing.assert_array_equal(pprober.probe_image(),
                                  jprober.probe_image())
    for name in ("PROBE_SENTENCE", "PROBE_IMAGE_SIZE", "PROBE_COUNTDOWN_S",
                 "PROBE_NEAR_GUESS"):
        assert getattr(pprober, name) == getattr(jprober, name)


def _keys(verdict: dict) -> tuple:
    return tuple(sorted(verdict))


async def _probe_ok(app, client, fabric, prober):
    oov_before = metrics.counter_total("scorer.table_oov")
    verdicts = [await prober.probe_once() for _ in range(2)]
    readyz = await (await client.get("/readyz")).json()
    return {"verdicts": [(v["ok"], v["leg"], v["error"], v["target"],
                          _keys(v)) for v in verdicts],
            "canary_keys": _keys(readyz["canary"]),
            "canary": {k: readyz["canary"][k]
                       for k in ("enabled", "ok", "consecutive_failures")},
            "targets": {w: _keys(v)
                        for w, v in readyz["canary"]["targets"].items()},
            "table_oov": metrics.counter_total("scorer.table_oov")
            - oov_before}


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_full_probe_passes_like_the_reference(variant, monkeypatch):
    """Two probes through the real listener pass on both packages; the
    /readyz canary block and its per-target verdict carry the reference's
    keys. The near guess is out of the wordlist: the table passes it on
    (``scorer.table_oov``), and behind the queue it is dispatched."""
    ref = asyncio.run(_with_app("reference", variant, monkeypatch,
                                _probe_ok))
    batches = metrics.counter_total("score.batches")
    port = asyncio.run(_with_app("port", variant, monkeypatch, _probe_ok))
    assert {k: v for k, v in port.items() if k != "table_oov"} == \
        {k: v for k, v in ref.items() if k != "table_oov"}
    assert port["verdicts"][0][:3] == (True, None, None)
    assert port["canary"] == {"enabled": True, "ok": True,
                              "consecutive_failures": 0}
    assert list(port["targets"]) == ["canary"]
    if variant == "table":
        # the near guess is not in the wordlist: the table passes it on
        assert port["table_oov"] > 0
    if variant == "queued":
        assert metrics.counter_total("score.batches") > batches


async def _probe_fails(app, client, fabric, prober):
    failures = metrics.counter_total("probe.failures")
    seq0 = flight_recorder.tail(1)[-1]["seq"] if flight_recorder.tail(1) \
        else 0
    verdict = await prober.probe_once()
    res = await client.get("/debugz", params={"trace": verdict["trace"]})
    spans = (await res.json())["spans"] if res.status == 200 else []
    events = [e for e in flight_recorder.tail(200, kind="probe.fail")
              if e["seq"] > seq0]
    return {"leg": verdict["leg"], "ok": verdict["ok"],
            "failures": metrics.counter_total("probe.failures") - failures,
            "trace_status": res.status,
            "root": [s["name"] for s in spans if s["parent_id"] is None],
            "event_traces": [e.get("trace") for e in events],
            "trace": verdict["trace"], "error": verdict["error"]}


def test_a_near_guess_at_the_floor_fails_at_score_and_is_traced(
        monkeypatch):
    """Every score dispatch fails (``queue.dispatch`` raising on the score
    queue): the near guess scores the floor or the route fails, and the
    probe fails at leg ``score`` on both packages; the port counts it,
    records ``probe.fail`` with its trace, and /debugz returns that
    trace, rooted at ``probe.run``."""
    spec = "seed=3;queue.dispatch=raise:peer=score"

    async def armed(which):
        async def body(*args):
            PACKAGES[which][2].configure(spec)
            try:
                return await _probe_fails(*args)
            finally:
                PACKAGES[which][2].disarm()
        return await _with_app(which, "queued", monkeypatch, body)

    ref = asyncio.run(armed("reference"))
    port = asyncio.run(armed("port"))
    assert (port["ok"], port["leg"]) == (ref["ok"], ref["leg"]) == \
        (False, "score")
    assert port["failures"] == 1
    assert port["trace_status"] == ref["trace_status"] == 200
    assert port["root"] == ["probe.run"]
    assert port["trace"] in port["event_traces"]


async def _gate(app, client, fabric, prober):
    out = []
    token = fabric.cluster_token()
    for headers in ({}, {"X-Cluster-Auth": "not-the-token"},
                    {"X-Cluster-Auth": token}):
        for path in ("/init", "/client/status", "/fetch/contents"):
            res = await client.get(path, params={"room": PROBE_ROOM,
                                                 "session": "s"},
                                   headers=headers)
            out.append((path, bool(headers), res.status))
    return out


@pytest.mark.parametrize("which", ["reference", "port"])
def test_the_probe_room_is_a_404_to_outsiders(which, monkeypatch):
    """Seen from outside loopback, ``?room=__probe__`` answers 404 unless
    the cluster token comes with it; the port answers as the reference."""
    app_mod = PACKAGES[which][0]
    monkeypatch.setattr(app_mod, "_is_loopback", lambda request: False)
    got = asyncio.run(_with_app(which, "plain", monkeypatch, _gate))
    assert [s for *_, s in got] == [404] * 6 + [200] * 3
    if which == "port":
        monkeypatch.setattr(japp, "_is_loopback", lambda request: False)
        assert got == asyncio.run(_with_app("reference", "plain",
                                            monkeypatch, _gate))


async def _f1(app, client, fabric, prober):
    before = {"ok": metrics.counter_total("probe.ok"),
              "e2e": metrics.hist_totals("probe.e2e_s")}
    if prober is not None:
        # the app's own loop at its floor cadence, not probe_once
        await asyncio.sleep(2.2)
    sloz = await (await client.get("/sloz")).json()
    readyz = await (await client.get("/readyz")).json()
    keys = sorted(k for k in fabric.store._data if k.startswith("probe:"))
    return {"objectives": sorted(n for n in sloz["objectives"]
                                 if n.startswith("probe_")),
            "sloz": sloz["objectives"],
            "probes": metrics.counter_total("probe.ok") - before["ok"],
            "e2e_changed": metrics.hist_totals("probe.e2e_s")
            != before["e2e"],
            "canary": readyz["canary"], "prober": prober,
            "store_keys": keys}


def test_f1_the_objectives_and_the_prober_follow_one_switch(monkeypatch):
    """Unset: the app's prober loop (``CASSMANTLE_PROBE_INTERVAL_S=0.5``)
    probes through the listener, and /sloz's probe_success and
    probe_latency carry its traffic. Set: no prober, no probe metric
    moves, no probe objective, no ``probe:`` store key, and the canary
    block reads ``{"enabled": false}``: the reference's two states."""
    monkeypatch.setenv("CASSMANTLE_PROBE_INTERVAL_S", "0.5")
    on = asyncio.run(_with_app("port", "plain", monkeypatch, _f1))
    assert on["objectives"] == ["probe_latency", "probe_success"]
    assert on["probes"] >= 2 and on["e2e_changed"]
    assert on["canary"]["enabled"] and on["canary"]["ok"]
    monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    off = asyncio.run(_with_app("port", "plain", monkeypatch, _f1))
    ref_off = asyncio.run(_with_app("reference", "plain", monkeypatch, _f1))
    assert off["prober"] is None and off["objectives"] == []
    assert off["probes"] == 0 and not off["e2e_changed"]
    assert off["canary"] == ref_off["canary"] == {"enabled": False}
    assert sorted(off["sloz"]) == sorted(ref_off["sloz"])
    assert not off["store_keys"]
