"""The port's operator surfaces held against the reference's: the two
switches (``CASSMANTLE_NO_EMBED_TABLE``, ``CASSMANTLE_NO_ADAPTIVE_ADMISSION``),
the leak sentinel (``utils/leak_sentinel.py``), the stage timer
(``utils/profiling.py::block_timer``) and ``POST /debug/trace``.

- With each switch set, the port reverts as the reference reverts: the
  scorer ladder without its table rung (rows within 1e-5 of the
  reference's, bit-equal to the port with no table), no table scores and
  no pins, the fake worker's table-first similarity handing everything
  to its fallback; every queue on the static ``max_pending`` pair, its
  batches and outcomes the reference's.
- The port's sentinel, armed inside a test while the suite's own (the
  reference's, ``tests/conftest.py``) is armed, names the origin of a
  seeded thread leak and of a seeded task leak, stamps apart from the
  reference's, and puts back exactly what it wrapped.
- ``block_timer``: the histogram, the span and its attributes, the FLOPs
  and the gauge of a dispatch that completed, nothing of one that
  raised; the peak at 989 TFLOP/s unless ``CASSMANTLE_CHIP_TFLOPS`` says
  otherwise.
- ``POST /debug/trace`` on the CPU: 403, 400, 409, a trace written and
  counted, a failed capture a 500 and counted.
"""

import asyncio
import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import cassmantle_tpu.config as jconfig
import cassmantle_tpu.serving.overload as joverload
import cassmantle_tpu.serving.queue as jqueue
import cassmantle_tpu.server.app as japp
import cassmantle_tpu_torch.config as pconfig
import cassmantle_tpu_torch.server.app as papp
import cassmantle_tpu_torch.serving.overload as poverload
import cassmantle_tpu_torch.serving.queue as pqueue
from cassmantle_tpu.engine.content import hash_similarity as jhash_sim
from cassmantle_tpu.models.minilm import MiniLMEncoder as JMiniLM
from cassmantle_tpu.ops import embed_table as jet
from cassmantle_tpu.ops.scorer import EmbeddingScorer as JScorer
from cassmantle_tpu_torch.engine.content import hash_similarity as phash_sim
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.obs.trace import tracer
from cassmantle_tpu_torch.ops import embed_table as pet
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.serving.fake_scorer import FakeQueuedScorer
from cassmantle_tpu_torch.utils import leak_sentinel as psentinel
from cassmantle_tpu_torch.utils.logging import metrics
from cassmantle_tpu_torch.utils.profiling import block_timer

from _torch_port_common import jax_params

WORDS = ["lighthouse", "comet", "harbor", "orchard", "caravan", "teal",
         "amber", "glacier"]
OOV = ["a quiet harbor", "zqxv"]


# -- CASSMANTLE_NO_EMBED_TABLE ---------------------------------------------

@pytest.fixture(scope="module")
def scorers():
    """(reference, port) scorers on one seeded MiniLM tree, each with the
    table of the same rows."""
    jm = jconfig.test_config().models.minilm
    ref = JScorer(jm, batch_buckets=(8, 64), table=None)
    ids = jnp.zeros((1, ref.seq_len), jnp.int32)
    ref.params = jax_params(JMiniLM(jm), 51, ids, ids)
    port = EmbeddingScorer(pconfig.test_config().models.minilm, "cpu",
                           batch_buckets=(8, 64),
                           state_dict=from_jax("minilm", ref.params))
    rows = ref.embed(WORDS)
    ref.table = jet.EmbedTable.from_embeddings(WORDS, rows)
    port.arm_table(pet.EmbedTable.from_embeddings(WORDS, rows))
    return ref, port


def test_no_embed_table_reverts_the_ladder_as_the_reference(scorers,
                                                           monkeypatch):
    ref, port = scorers
    texts = WORDS + OOV
    pairs = [(g, a) for g in WORDS[:3] + OOV for a in WORDS[3:5]]
    assert port.table_scores(pairs) is not None          # armed
    monkeypatch.setenv("CASSMANTLE_NO_EMBED_TABLE", "1")
    hits = metrics.counter_total("scorer.table_hits")
    got, want = port.embed(texts), ref.embed(texts)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert metrics.counter_total("scorer.table_hits") == hits
    np.testing.assert_allclose(port.similarity(pairs),
                               ref.similarity(pairs), atol=1e-5, rtol=0)
    assert port.table_scores(pairs) is None and \
        ref.table_scores(pairs) is None
    assert port.pin_answers(["crimson"]) == ref.pin_answers(["crimson"]) == 0
    assert not port.table.contains("crimson")
    # bit for bit the port's ladder with no table at all
    table, port.table = port.table, None
    try:
        port.clear_embed_cache()
        np.testing.assert_array_equal(port.embed(texts), got)
    finally:
        port.table = table


def test_no_embed_table_sends_the_fake_ladder_to_its_fallback(monkeypatch):
    """The --fake worker's table-first similarity: with the switch set,
    every pair goes to the fallback, as the reference's does."""
    words = ["lighthouse", "harbor", "comet"]
    rows = np.random.default_rng(3).standard_normal((3, 32)).astype(
        np.float32)
    pairs = [("lighthouse", "harbor"), ("comet", "zqxv")]
    monkeypatch.setenv("CASSMANTLE_NO_EMBED_TABLE", "1")
    served = metrics.counter_total("overload.table_served")
    got = asyncio.run(pet.TableFirstSimilarity(
        pet.EmbedTable.from_embeddings(words, rows), phash_sim)(pairs))
    want = asyncio.run(jet.TableFirstSimilarity(
        jet.EmbedTable.from_embeddings(words, rows), jhash_sim)(pairs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, asyncio.run(phash_sim(pairs)))
    assert metrics.counter_total("overload.table_served") == served


# -- CASSMANTLE_NO_ADAPTIVE_ADMISSION ----------------------------------------

PACKAGES = {"reference": (joverload, jqueue, jconfig),
            "port": (poverload, pqueue, pconfig)}


def _admission_script(which: str):
    """A queue built as the services build theirs, its limiter from
    ``make_admission``: 12 interactive and background items against a
    max_pending of 6 behind a slow first batch; (limiter, batches,
    outcomes)."""
    overload, queue, config = PACKAGES[which]
    cfg = config.test_config()
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, max_pending=6, admission_min_pending=2))
    limiter = overload.make_admission(f"sw_{which}", cfg)
    batches = []

    def handler(batch):
        batches.append(list(batch))
        if len(batches) == 1:
            threading.Event().wait(0.1)
        return list(batch)

    async def run():
        q = queue.BatchingQueue(handler, max_batch=2, max_delay_ms=1,
                                max_pending=6, admission=limiter)
        tasks = []
        for i in range(12):
            tasks.append(asyncio.ensure_future(q.submit(
                f"x{i}", priority="background" if i % 3 else
                "interactive")))
            await asyncio.sleep(0)
        await asyncio.wait(tasks)
        await q.stop()
        return [type(t.exception()).__name__ if t.exception() else
                t.result() for t in tasks]

    return limiter, batches, asyncio.run(run())


def test_no_adaptive_admission_reverts_to_the_static_pair(monkeypatch):
    monkeypatch.setenv("CASSMANTLE_NO_ADAPTIVE_ADMISSION", "1")
    ref = _admission_script("reference")
    port = _admission_script("port")
    assert port[0] is None and ref[0] is None
    assert port[1:] == ref[1:]
    assert "QueueFull" in port[2]                 # the static wall held
    assert "sw_port" not in poverload.status_block()["queues"]
    scorer = FakeQueuedScorer(pconfig.test_config())
    try:
        assert scorer.queue.admission is None
    finally:
        asyncio.run(scorer.stop())
    monkeypatch.delenv("CASSMANTLE_NO_ADAPTIVE_ADMISSION")
    assert poverload.make_admission("sw_on", pconfig.test_config()) \
        is not None


# -- the leak sentinel -------------------------------------------------------

def _spawn_blocked(release: threading.Event) -> threading.Thread:
    t = threading.Thread(target=release.wait, name="seeded-leak",
                         daemon=True)
    t.start()
    return t


def test_the_port_sentinel_names_a_seeded_thread_leak():
    """Armed on top of the suite's sentinel: the seeded thread is named
    with its origin here, stamped apart from the suite's stamp, and
    disarming puts back the suite's wrapper itself."""
    import threading as th

    outer_start = th.Thread.start
    psentinel.reset()
    psentinel.enable_sentinel()
    release = threading.Event()
    try:
        snap = psentinel.snapshot()
        thread = _spawn_blocked(release)
        leaks = psentinel.verify(snap, raise_on_leak=False, fd_policy="off")
        with pytest.raises(psentinel.LeakError, match="_spawn_blocked"):
            psentinel.verify(snap, fd_policy="off")
    finally:
        psentinel.disable_sentinel()
        release.set()
    thread.join(5)
    assert th.Thread.start is outer_start
    assert len(leaks) == 1 and "seeded-leak" in leaks[0]
    assert "test_torch_port_opsurface.py" in leaks[0]
    assert getattr(thread, "_port_leak_seq", 0) > 0
    if getattr(outer_start, "__name__", "") == "_wrapped_thread_start":
        # the suite's sentinel stamped it too, under its own name
        assert getattr(thread, "_leak_seq", 0) > 0
    assert psentinel.verify(snap, fd_policy="off") == []


def test_the_port_sentinel_names_a_seeded_task_leak():
    psentinel.reset()
    psentinel.enable_sentinel()
    try:
        async def run():
            snap = psentinel.snapshot()
            task = asyncio.get_running_loop().create_task(
                asyncio.sleep(3600), name="seeded-task")
            await asyncio.sleep(0)
            leaks = psentinel.verify(snap, raise_on_leak=False,
                                     fd_policy="off")
            census = psentinel.scan()
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            return leaks, census, psentinel.verify(snap, fd_policy="off")

        grew = metrics.counter_total("leaks.tasks")
        leaks, census, after = asyncio.run(run())
    finally:
        psentinel.disable_sentinel()
        psentinel.reset()
    assert len(leaks) == 1 and "seeded-task" in leaks[0]
    assert "test_torch_port_opsurface.py" in leaks[0] and "in run" in \
        leaks[0]
    assert census["tasks"] >= 1 and after == []
    assert metrics.counter_total("leaks.tasks") > grew


# -- block_timer -------------------------------------------------------------

def test_block_timer_writes_the_histogram_span_and_attribution():
    products = costmodel.Products(bf16=2e12, int8=1e12)
    labels = {"pipeline": "optest"}
    before = metrics.counter_total("request.device_flops")
    hist = metrics.hist_totals("optest.stage_s")
    with tracer.span("optest.root", root=True) as root:
        tracer.mark_retain("test", root.ctx)
        with block_timer("optest.stage_s", flops_est=lambda: products,
                         pipeline="optest"):
            threading.Event().wait(0.02)
    spans = {s["name"]: s for s in tracer.get_trace(root.trace_id)}
    attrs = spans["optest.stage_s"]["attrs"]
    assert attrs["device_synced"] and attrs["flops_est"] == 3e12
    assert attrs["flops_int8"] == 1e12
    elapsed = spans["optest.stage_s"]["duration_s"]
    want = (2e12 / 989e12 + 1e12 / 1979e12) / elapsed
    assert attrs["mxu_utilization"] == pytest.approx(want, rel=1e-4)
    assert metrics.counter_total("request.device_flops") == before + 3e12
    gauge = metrics.snapshot()["gauges"]
    key = next(k for k in gauge if k.startswith("pipeline.mxu_utilization")
               and "optest" in k)
    assert gauge[key] == pytest.approx(want, rel=1e-4)
    got = metrics.hist_totals("optest.stage_s")
    assert got[2] == (hist[2] if hist else 0) + 1
    assert labels


def test_block_timer_attributes_nothing_for_a_dispatch_that_raised():
    before = metrics.counter_total("request.device_flops")
    with pytest.raises(RuntimeError):
        with block_timer("optest.raised_s", flops_est=1e12,
                         pipeline="optest_raised"):
            raise RuntimeError("the dispatch failed")
    assert metrics.counter_total("request.device_flops") == before
    assert not any("optest_raised" in k
                   for k in metrics.snapshot()["gauges"])
    assert metrics.hist_totals("optest.raised_s")[2] >= 1


def test_trace_writes_a_capture_naming_the_annotated_range(tmp_path):
    """``trace(dir)`` records a ``torch.profiler`` trace there, and an
    ``annotate`` range inside it is named in the trace's events."""
    import torch

    from cassmantle_tpu_torch.utils.profiling import annotate, trace

    held = metrics.hist_totals("graphs.held_off_s")
    with trace(str(tmp_path)) as path:
        with annotate("optest_range"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files == [os.path.basename(path)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "optest_range" in names
    # graph launches were held off for the start and the stop only
    assert metrics.hist_totals("graphs.held_off_s")[2] == \
        (held[2] if held else 0) + 2
    with trace(None) as path:               # no directory: a no-op
        assert path is None


def test_the_peak_is_the_h100s_and_follows_the_override(monkeypatch):
    monkeypatch.delenv("CASSMANTLE_CHIP_TFLOPS", raising=False)
    assert costmodel.chip_peak_flops() == 989e12
    assert costmodel.chip_peak_flops("int8") == 1979e12
    assert costmodel.chip_peak_flops("fp32") == 67e12
    monkeypatch.setenv("CASSMANTLE_CHIP_TFLOPS", "494.5")
    assert costmodel.chip_peak_flops() == pytest.approx(494.5e12)
    assert costmodel.chip_peak_flops("int8") == pytest.approx(989.5e12)
    monkeypatch.setenv("CASSMANTLE_CHIP_TFLOPS", "not-a-number")
    assert costmodel.chip_peak_flops() == 989e12


# -- POST /debug/trace -------------------------------------------------------

async def _trace_app(which, body, monkeypatch):
    app_mod, config = {"reference": (japp, jconfig),
                       "port": (papp, pconfig)}[which]
    cfg = config.test_config()
    cfg = cfg.replace(game=dataclasses.replace(
        cfg.game, rate_limit_default=1000.0, rate_limit_api=1000.0))
    fabric = app_mod.build_fabric(cfg, fake=True, worker_id="trace")
    app = app_mod.create_app(fabric, cfg, start_timer=False)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await body(client)
    finally:
        await client.close()


@pytest.fixture
def trace_env(monkeypatch, tmp_path):
    monkeypatch.setenv("CASSMANTLE_NO_PROBER", "1")
    monkeypatch.setenv("CASSMANTLE_TRACE_ROOT", str(tmp_path))
    return tmp_path


async def _gates(client):
    out = []
    for params in ({"seconds": "abc"}, {"seconds": "0", "name": "../x"},
                   {"seconds": "0", "name": "a/b"},
                   {"seconds": "0", "name": "x" * 65}):
        res = await client.post("/debug/trace", params=params)
        out.append(res.status)
    return out


def test_debug_trace_refuses_like_the_reference(trace_env, monkeypatch):
    assert asyncio.run(_trace_app("port", _gates, monkeypatch)) == \
        asyncio.run(_trace_app("reference", _gates, monkeypatch)) == \
        [400] * 4
    for mod in (papp, japp):
        monkeypatch.setattr(mod, "_is_loopback", lambda request: False)

    async def outsider(client):
        return (await client.post("/debug/trace",
                                  params={"seconds": "0"})).status

    assert asyncio.run(_trace_app("port", outsider, monkeypatch)) == \
        asyncio.run(_trace_app("reference", outsider, monkeypatch)) == 403


def test_debug_trace_captures_once_at_a_time(trace_env, monkeypatch):
    async def body(client):
        first = asyncio.ensure_future(client.post(
            "/debug/trace", params={"seconds": "0.5", "name": "cap"}))
        state = client.server.app[papp._TRACE_STATE]
        for _ in range(500):                 # the first capture is running
            if state["active"]:
                break
            await asyncio.sleep(0.01)
        second = await client.post("/debug/trace", params={"seconds": "0"})
        res = await first
        return second.status, res.status, await res.json()

    captures = metrics.counter_total("obs.profiler_captures")
    busy, status, reply = asyncio.run(_trace_app("port", body, monkeypatch))
    assert (busy, status) == (409, 200)
    assert reply == {"trace_dir": os.path.join(str(trace_env), "cap"),
                     "seconds": 0.5}
    # one file per window of the capture (utils/profiling.py::capture)
    files = [f for f in os.listdir(reply["trace_dir"])
             if f.endswith(".json")]
    assert len(files) >= 1
    for name in files:
        with open(os.path.join(reply["trace_dir"], name)) as f:
            assert "traceEvents" in json.load(f)
    assert metrics.counter_total("obs.profiler_captures") == captures + 1


def test_a_failed_capture_is_a_500_and_counted(trace_env, monkeypatch):
    def broken(log_dir, seconds):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(papp, "_profile_capture", broken)

    async def body(client):
        res = await client.post("/debug/trace", params={"seconds": "0"})
        again = await client.post("/debug/trace", params={"seconds": "0"})
        return res.status, again.status

    failures = metrics.counter_total("obs.profiler_capture_failures")
    captures = metrics.counter_total("obs.profiler_captures")
    assert asyncio.run(_trace_app("port", body, monkeypatch)) == (500, 500)
    assert metrics.counter_total("obs.profiler_capture_failures") == \
        failures + 2
    assert metrics.counter_total("obs.profiler_captures") == captures
