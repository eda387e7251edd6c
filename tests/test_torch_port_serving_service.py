"""The port's ``InferenceService`` on the CPU at ``test_config()``: the
serving seam's behaviour through its async surface.

- 64 concurrent one-pair ``similarity`` calls coalesce into one score
  batch and one device dispatch, each score within 1e-5 of one direct
  ``scorer.similarity`` call; rung 0 (the int8 table, answers pinned)
  serves in-vocabulary pairs with no queue batch at all.
- Concurrent rounds' decodes coalesce into one prompt-queue batch; a row
  the integrity sentinel rejects fails alone and its round falls back to
  the in-backend decode.
- The integrity drill: a poisoned member of a score batch floors its own
  request only.
- The device-loss drill: a chaos ``device.lost`` at the scorer flips the
  supervisor to ``device_lost``, the rebuild reloads every pipeline's
  parameters in place (same tensors, same values) and warms under
  ``no_new_captures``, and the supervisor returns to healthy; a rebuild
  that keeps failing (a sticky CUDA error) ends in permanent loss.
- Fault 1: two threads calling ``Text2ImagePipeline.generate`` at once
  never run the UNet at the same time (the dispatch lock).
"""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from cassmantle_tpu_torch import chaos
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.ops import embed_table as et
from cassmantle_tpu_torch.ops import graphs
from cassmantle_tpu_torch.serving.integrity import OutputInvalid
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.service import InferenceService
from cassmantle_tpu_torch.utils import locks
from cassmantle_tpu_torch.utils.logging import metrics

from _torch_port_common import EagerStep

WORDS = ["lighthouse", "comet", "harbor", "orchard", "teal", "amber",
         "glacier", "canyon", "violet", "archive", "silver", "ember"]
SEEDS = ["The Night the Trains Sang", "A Winter Without Clocks",
         "Salt Roads and Silver Rivers"]


@pytest.fixture
def svc():
    service = InferenceService(port_test_config(), device="cpu", table=None)
    yield service
    chaos.disarm()
    asyncio.run(service.stop())


def _count(name):
    return metrics.counter_total(name)


def test_concurrent_guesses_coalesce_into_one_dispatch(svc):
    pairs = [(f"guess{i} zq", "lighthouse") for i in range(64)]

    async def run():
        return await asyncio.gather(*(svc.similarity([p]) for p in pairs))

    batches, dispatches = _count("score.batches"), _count("scorer.dispatches")
    got = np.concatenate(asyncio.run(run()))
    assert _count("score.batches") == batches + 1
    assert _count("scorer.dispatches") == dispatches + 1
    np.testing.assert_allclose(got, svc.scorer.similarity(pairs), atol=1e-5,
                               rtol=0)


def test_rung_zero_serves_without_the_queue(svc):
    """In-vocabulary guesses against pinned answers: served from the int8
    table with no score batch; the table hits count both sides."""
    words = WORDS + ["nightfall"]
    rows = svc.scorer.embed(words)
    svc.scorer.arm_table(et.EmbedTable.from_embeddings(WORDS, rows[:-1]))
    assert svc.pin_answers(["nightfall", "comet"]) == 1
    pairs = [(g, "nightfall") for g in WORDS]

    async def run():
        return await asyncio.gather(*(svc.similarity([p]) for p in pairs))

    batches = _count("score.batches")
    hits, served = _count("scorer.table_hits"), _count(
        "overload.table_served")
    got = np.concatenate(asyncio.run(run()))
    assert _count("score.batches") == batches
    assert _count("scorer.table_hits") == hits + 2 * len(pairs)
    assert _count("overload.table_served") == served + len(pairs)
    fp32 = rows[:-1] @ rows[-1]
    assert np.abs(got - fp32).max() < 1e-2
    # a pair with an out-of-vocabulary side still takes the queue
    mixed = asyncio.run(svc.similarity([("comet", "nightfall"),
                                        ("zq harbor", "nightfall")]))
    assert _count("score.batches") == batches + 1
    assert mixed[0] == pytest.approx(got[1], abs=1e-6)


def test_concurrent_rounds_coalesce_their_decodes(svc, monkeypatch):
    """Three rounds at once: one prompt-queue batch of the three seeds;
    each round is given the text a lone decode of the same batch makes,
    and its image is the one a lone ``t2i.generate`` of the styled
    prompt and image seed it drew makes."""
    backend = svc.backend
    calls, given = [], {}
    real_batch = backend.prompt_gen.generate_batch
    real_sync = backend.generate_sync

    def recording_batch(seeds, *a, **kw):
        calls.append(list(seeds))
        return real_batch(seeds, *a, **kw)

    def recording_sync(seed, is_seed=True, text=None):
        given[seed] = text
        return real_sync(seed, is_seed, text)

    monkeypatch.setattr(backend.prompt_gen, "generate_batch",
                        recording_batch)
    monkeypatch.setattr(backend, "generate_sync", recording_sync)

    async def run():
        return await asyncio.gather(*(svc.content_backend.generate(s, True)
                                      for s in SEEDS))

    rounds = asyncio.run(run())
    assert len(calls) == 1 and sorted(calls[0]) == sorted(SEEDS)
    lone = dict(zip(calls[0], real_batch(calls[0])))
    assert given == lone
    assert sorted(rc.image_seed for rc in rounds) == [1, 2, 3]
    for rc in rounds:
        again = backend.t2i.generate([rc.image_prompt], seed=rc.image_seed)
        np.testing.assert_array_equal(rc.image, again[0])


def test_invalid_decode_row_falls_back_to_the_backend(svc):
    invalid = _count("pipeline.output_invalid")
    chaos.configure("seed=4;device.poison=raise:peer=prompt,times=1")
    rc = asyncio.run(svc.generate_content(SEEDS[0]))
    assert _count("pipeline.output_invalid") == invalid + 1
    assert rc.prompt_text.strip()
    with pytest.raises(OutputInvalid):
        chaos.configure("seed=4;device.poison=raise:peer=prompt,times=1")
        svc.backend.prompt_gen.generate(SEEDS[0])


def test_poisoned_member_floors_its_request_only(svc):
    pairs = [(f"drill{i} zq", "harbor") for i in range(8)]
    direct = svc.scorer.similarity(pairs)
    for i in range(8):                 # forget them: they must re-embed
        svc.scorer._embed_cache.pop(pairs[i][0], None)
    chaos.configure("seed=5;device.poison=raise:peer=scorer,times=1")

    async def run():
        return await asyncio.gather(*(svc.similarity([p]) for p in pairs))

    got = np.concatenate(asyncio.run(run()))
    floored = np.nonzero(got == 0.0)[0]
    assert len(floored) == 1, got
    keep = np.ones(8, bool)
    keep[floored] = False
    np.testing.assert_allclose(got[keep], direct[keep], atol=1e-5, rtol=0)


def test_device_loss_drill_recovers_in_place(svc):
    t2i = svc.backend.t2i
    prompt = ["A watercolor style piece depicting: a drill."]
    before = t2i.generate(prompt, seed=3)
    ptrs = [t.data_ptr() for t in t2i.param_tensors()]
    with torch.no_grad():              # what a dead device leaves behind
        t2i.unet.conv_in.weight.add_(1.0)
    captures = graphs.capture_count()
    chaos.configure("seed=6;device.lost=raise:peer=scorer,times=1")
    with pytest.raises(chaos.ChaosInjected):
        asyncio.run(svc.similarity([("lost zq", "harbor")]))
    assert svc.supervisor.status()["state"] in ("device_lost", "ok")
    svc.recovery.join(timeout=30.0)
    status = svc.supervisor.status()
    assert status["state"] == "ok" and svc.supervisor.device_lost is None
    assert _count("device.recoveries") >= 1
    assert [t.data_ptr() for t in t2i.param_tensors()] == ptrs
    with graphs.no_new_captures():
        after = t2i.generate(prompt, seed=3)
    np.testing.assert_array_equal(after, before)
    assert graphs.capture_count() == captures
    # the healthy service scores again
    assert np.isfinite(asyncio.run(svc.similarity([("back zq", "harbor")])))


def test_sticky_loss_ends_in_permanent_device_lost(svc, monkeypatch):
    """A rebuild that fails on every attempt (a sticky CUDA error leaves
    the context unusable) exhausts the attempts: permanent loss, and the
    queues fail fast."""
    def sticky():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(svc.scorer, "reload_params", sticky)
    svc.recovery.backoff_s = 0.0
    assert svc.recovery.note_dispatch_exception(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    svc.recovery.join(timeout=30.0)
    assert svc.recovery.permanent
    assert svc.supervisor.status()["state"] == "device_lost"
    floor = asyncio.run(svc.similarity([("after zq", "harbor")]))
    np.testing.assert_array_equal(floor, [0.0])


def test_no_new_captures_catches_a_capture(monkeypatch):
    """The capture sentinel: a CapturedStep made inside the block raises
    at its end (EagerStep stands in for the CUDA graph)."""
    before = graphs.capture_count()
    with graphs.no_new_captures():
        pass
    with pytest.raises(graphs.NewCaptureError, match="1 CUDA graph"):
        with graphs.no_new_captures():
            EagerStep(lambda: None)
    assert graphs.capture_count() == before + 1


def test_no_new_captures_counts_its_own_thread_only():
    """Another thread's capture inside the block (a cold round capturing
    its first graph in the executor) is not the block's: no raise; the
    process-wide count still sees it."""
    before = graphs.capture_count()
    with graphs.no_new_captures():
        other = threading.Thread(target=EagerStep, args=(lambda: None,))
        other.start()
        other.join()
    assert graphs.capture_count() == before + 1


def test_recovery_warm_survives_a_capture_on_another_thread(svc,
                                                           monkeypatch):
    """A capture on another thread while the recovery warms does not fail
    the recovery; the warm replays the prompt LM's last decode (same
    tokens) and a capture on the warm's own thread does fail it."""
    gen = svc.backend.prompt_gen
    first = gen.decode_ids_batch(SEEDS[:2])
    replays = []
    real_decode = gen._decode

    def decode(*args):
        replays.append(real_decode(*args))
        return replays[-1]

    monkeypatch.setattr(gen, "_decode", decode)
    real_embed = svc.scorer.embed

    def embed_while_another_thread_captures(texts):
        other = threading.Thread(target=EagerStep, args=(lambda: None,))
        other.start()
        other.join()
        return real_embed(texts)

    monkeypatch.setattr(svc.scorer, "embed",
                        embed_while_another_thread_captures)
    svc.warm_after_recovery()
    assert len(replays) == 1
    np.testing.assert_array_equal(replays[0][0], first[0])
    np.testing.assert_array_equal(replays[0][1], first[1])

    def embed_and_capture_here(texts):
        EagerStep(lambda: None)
        return real_embed(texts)

    monkeypatch.setattr(svc.scorer, "embed", embed_and_capture_here)
    with pytest.raises(graphs.NewCaptureError):
        svc.warm_after_recovery()


def test_concurrent_generates_never_overlap_the_unet():
    """Fault 1: the dispatch lock serializes a pipeline's device work.
    Two threads generate at once; the UNet's forwards (entry and exit
    recorded, each held a few ms) never interleave."""
    cfg = port_test_config()
    pipe = Text2ImagePipeline(cfg.replace(sampler=dataclasses.replace(
        cfg.sampler, num_steps=3)), device="cpu")
    events = []
    real = pipe.unet.forward

    def recording(*a, **kw):
        events.append(("enter", threading.get_ident()))
        time.sleep(0.005)
        try:
            return real(*a, **kw)
        finally:
            events.append(("exit", threading.get_ident()))

    pipe.unet.forward = recording
    barrier = threading.Barrier(2)
    errors = []

    def worker(seed):
        try:
            barrier.wait()
            pipe.generate(["a lighthouse at dusk"], seed=seed)
        except Exception as exc:       # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(events) == 2 * 2 * 3
    for i in range(0, len(events), 2):
        (kind_a, who_a), (kind_b, who_b) = events[i], events[i + 1]
        assert (kind_a, kind_b) == ("enter", "exit") and who_a == who_b, \
            events


def test_the_seam_keeps_the_lock_hierarchy(svc):
    """With the lock sentinel raising, concurrent guesses, rounds and a
    device-loss drill take every lock of the seam (the pipelines' dispatch
    locks, the dispatch worker, the supervisor, the breakers, the
    limiters, the chaos plan) in the hierarchy's order."""
    locks.reset_observations()
    locks.enable_sentinel(raise_on_violation=True)
    violations = _count("locks.order_violations")
    try:
        async def run():
            guesses = [svc.similarity([(f"rank{i} zq", "harbor")])
                       for i in range(16)]
            rounds = [svc.content_backend.generate(s, True)
                      for s in SEEDS[:2]]
            return await asyncio.gather(*guesses, *rounds)

        asyncio.run(run())
        chaos.configure("seed=7;device.lost=raise:peer=scorer,times=1")
        with pytest.raises(chaos.ChaosInjected):
            asyncio.run(svc.similarity([("rank lost zq", "harbor")]))
        svc.recovery.join(timeout=30.0)
        assert svc.supervisor.status()["state"] == "ok"
    finally:
        locks.disable_sentinel()
        locks.reset_observations()
    assert _count("locks.order_violations") == violations


def test_a_dropped_service_is_freed():
    """The idle dispatch thread holds nothing of the last batch it ran:
    a service that was stopped and dropped is collected, its models with
    it (a server that rebuilds its service, or one preset after another,
    would otherwise keep the previous models on the card)."""
    import gc
    import weakref

    service = InferenceService(port_test_config(), device="cpu", table=None)
    asyncio.run(service.similarity([("freed zq", "harbor")]))
    unet = weakref.ref(service.backend.t2i.unet)
    asyncio.run(service.stop())
    del service
    gc.collect()
    assert unet() is None
