"""The game engine of the port against the reference, on the CPU: each
script runs once on each package's modules and the transcripts must be
equal.

- ``engine/store.py``: keys, TTLs under a fake clock, hashes (with the
  ``strtoll`` counter reads and the wrong-type discipline), sets, lock
  exclusion, acquire timeout, self-expiry, the overrun and
  expired-in-hold hazard counts, snapshot and restore.
- ``engine/pos.py`` and ``engine/masking.py``: per-token maskability,
  register drift, candidates and the selected masks (``hash_embed``) over
  the gold corpus and drifted prose; ``engine/scoring.py``'s scores and
  reveal curve.
- ``engine/game.py`` over ``rounds``, ``sessions``, ``reserve`` and
  ``content``: the same scripted game on both packages'
  ``FakeContentBackend`` and ``hash_similarity``, the store under a fake
  clock and the rounds' rng seeded: startup, sessions, wrong, partial and
  winning guesses, prompt JSON, masked images (JPEG base64), the clock
  payload, a buffered promotion, the coarse-blur brownout tier, a
  rotation from the reserve while the content breaker is open, and the
  store's contents after each phase.
- ``eval/masking_agreement.py``: the report on ``data/pos_gold.txt``.
- ``utils/codec.py`` and ``server/assets.py``: equal JPEG bytes and
  pixels, equal seeds, styles and vocabulary.
"""

import asyncio
import base64
import dataclasses
import pickle
import random
import types

import numpy as np
import pytest

from cassmantle_tpu import config as jconfig
from cassmantle_tpu.engine import content as jcontent
from cassmantle_tpu.engine import game as jgame
from cassmantle_tpu.engine import masking as jmasking
from cassmantle_tpu.engine import pos as jpos
from cassmantle_tpu.engine import scoring as jscoring
from cassmantle_tpu.engine import store as jstore
from cassmantle_tpu.eval import masking_agreement as jagree
from cassmantle_tpu.server import assets as jassets
from cassmantle_tpu.serving import overload as joverload
from cassmantle_tpu.utils import codec as jcodec
from cassmantle_tpu.utils.logging import metrics as jmetrics
from cassmantle_tpu.utils.text import tokenize_words as jtokenize
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.engine import content as pcontent
from cassmantle_tpu_torch.engine import game as pgame
from cassmantle_tpu_torch.engine import masking as pmasking
from cassmantle_tpu_torch.engine import pos as ppos
from cassmantle_tpu_torch.engine import scoring as pscoring
from cassmantle_tpu_torch.engine import store as pstore
from cassmantle_tpu_torch.eval import masking_agreement as pagree
from cassmantle_tpu_torch.server import assets as passets
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.utils import codec as pcodec
from cassmantle_tpu_torch.utils.logging import metrics as pmetrics
from cassmantle_tpu_torch.utils.text import tokenize_words as ptokenize

PACKAGES = {
    "reference": types.SimpleNamespace(
        config=jconfig, content=jcontent, game=jgame, masking=jmasking,
        pos=jpos, scoring=jscoring, store=jstore, agree=jagree,
        assets=jassets, overload=joverload, codec=jcodec, metrics=jmetrics,
        tokenize=jtokenize),
    "port": types.SimpleNamespace(
        config=pconfig, content=pcontent, game=pgame, masking=pmasking,
        pos=ppos, scoring=pscoring, store=pstore, agree=pagree,
        assets=passets, overload=poverload, codec=pcodec, metrics=pmetrics,
        tokenize=ptokenize),
}


def both(script):
    """(reference transcript, port transcript) of ``script(package)``."""
    return tuple(script(PACKAGES[name]) for name in ("reference", "port"))


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


# -- the store ----------------------------------------------------------------

def _store_script(m, tmp_path):
    clock = FakeClock()
    store = m.store.MemoryStore(clock=clock)
    count = m.metrics.counter_total
    out = []

    async def run():
        await store.set("a", "x")
        await store.setex("b", 5.0, 12)
        out.append((await store.get("a"), await store.get("b"),
                    await store.ttl("a"), await store.ttl("b"),
                    await store.ttl("zz"), await store.exists("b")))
        clock.t += 5.0
        out.append((await store.get("b"), await store.exists("b")))
        await store.hset("h", mapping={"n": " -7x", "f": 1.5})
        await store.hset("h", "g", b"raw")
        out.append((await store.hincrby("h", "n", 3),
                    await store.hincrby("h", "new", -2),
                    await store.hgetall("h"), await store.hget("h", "f")))
        await store.hdel("h", "f", "absent")
        await store.expire("h", 2.0)
        out.append((await store.hgetall("h"), await store.ttl("h")))
        await store.sadd("s", "p", "q", "r")
        await store.srem("s", "q")
        out.append((sorted(await store.smembers("s")),
                    await store.sismember("s", "p"),
                    await store.sismember("s", "q")))
        # wrong-type discipline: reads miss, writes replace
        out.append((await store.hget("a", "x"), await store.smembers("h"),
                    await store.get("s")))
        await store.sadd("a", "m")
        out.append((sorted(await store.smembers("a")), await store.get("a")))
        # locks: exclusion, acquire timeout, self-expiry, hazards
        order = []

        async def holder(name):
            async with store.lock("L", timeout=10.0,
                                  blocking_timeout=1.0):
                order.append(f"in {name}")
                await asyncio.sleep(0.02)
                order.append(f"out {name}")

        await asyncio.gather(holder("1"), holder("2"))
        out.append(order)
        # an acquire timeout runs on the store's own clock: a real one
        timeouts, real = 0, m.store.MemoryStore()
        async with real.lock("M", timeout=10.0, blocking_timeout=0.1):
            try:
                async with real.lock("M", timeout=10.0,
                                     blocking_timeout=0.05):
                    pass
            except m.store.LockTimeout:
                timeouts += 1
        out.append(timeouts)
        over, expired = (count("store.lock_overrun"),
                         count("store.lock_expired_in_hold"))
        async with store.lock("N", timeout=1.0, blocking_timeout=0.1):
            clock.t += 2.0                  # held past its TTL
        async with store.lock("O", timeout=1.0, blocking_timeout=0.1):
            clock.t += 2.0
            async with store.lock("O", timeout=1.0, blocking_timeout=0.1):
                pass                        # the expired lock is retaken
        out.append((count("store.lock_overrun") - over,
                    count("store.lock_expired_in_hold") - expired))
        await store.setex("keep", 30.0, "k")
        # the hash "h" expired untouched: the reference's snapshot raises
        # while its comprehension drops it (the port drops expired keys
        # first: test_snapshot_drops_keys_that_expired_untouched); read
        # it here so both snapshot the same live state
        out.append(await store.exists("h"))
        path = str(tmp_path / f"{m.store.__name__}.pkl")
        store.snapshot(path)
        clock.t += 10.0
        fresh = m.store.MemoryStore(clock=clock)
        fresh.restore(path)
        out.append((await fresh.get("keep"), await fresh.ttl("keep"),
                    await fresh.hgetall("h"), await fresh.get("b")))

    asyncio.run(run())
    return out


def test_store_matches_reference(tmp_path):
    ref, port = both(lambda m: _store_script(m, tmp_path))
    assert port == ref
    assert ref[-4] == 1 and ref[-3] == (1, 1)


def test_snapshot_drops_keys_that_expired_untouched(tmp_path):
    """A key whose TTL ran out with no read since: the port's snapshot
    leaves it out (the reference's raises RuntimeError: dictionary
    changed size during iteration)."""
    clock = FakeClock()

    async def run(m):
        store = m.store.MemoryStore(clock=clock)
        await store.setex("gone", 1.0, "x")
        await store.setex("kept", 60.0, "y")
        await store.hset("h", mapping={"f": 1})
        clock.t += 2.0
        path = str(tmp_path / f"{m.store.__name__}.snap")
        store.snapshot(path)
        fresh = m.store.MemoryStore(clock=clock)
        fresh.restore(path)
        return (await fresh.get("gone"), await fresh.get("kept"),
                await fresh.hgetall("h"))

    with pytest.raises(RuntimeError, match="changed size"):
        asyncio.run(run(PACKAGES["reference"]))
    assert asyncio.run(run(PACKAGES["port"])) == (None, b"y", {"f": b"1"})


# -- POS, masking and scoring --------------------------------------------------

DRIFTED = [
    "The light fades as the tide returns to the harbor.",
    "Gather the fallen branches and light the lantern before dusk.",
    "Birds sing over the market while the old clock ticks.",
    "a the of",
    "Rain rain rain rain.",
]


def _gold_texts():
    return [" ".join(tok for tok, _ in pairs)
            for pairs in jagree.load_gold()][:60] + DRIFTED


def _masking_script(m):
    out = []
    for text in _gold_texts():
        tokens = m.tokenize(text)
        out.append((
            [m.pos.is_maskable(tokens, i) for i in range(len(tokens))],
            m.pos.register_drift(tokens), m.pos.register_evidence(tokens),
            m.masking.candidate_indices(tokens),
            m.masking.conservative_candidate_indices(tokens),
            [m.masking.select_masks(tokens, m.content.hash_embed, n)
             for n in (1, 2, 3)],
            m.masking.build_prompt_state(text, m.content.hash_embed)))
    out.append(sorted(m.masking.STOPWORDS))
    return out


def test_masking_and_pos_match_reference():
    ref, port = both(_masking_script)
    assert port == ref


def _scoring_script(m):
    calls = []

    async def similarity(pairs):
        calls.append(list(pairs))
        return await m.content.hash_similarity(pairs)

    scorer = m.scoring.GuessScorer(similarity, min_score=0.01)
    pairs = {"1": {"input": "Comet", "answer": "comet"},
             "3": {"input": "lantern", "answer": "harbor"},
             "5": {"input": " glacier ", "answer": "canyon"},
             "7": {"input": "x", "answer": "x "}}
    scores = asyncio.run(scorer.score_pairs(pairs))
    emb = m.content.hash_embed(["comet", "harbor", "Comet"])
    curve = [m.scoring.score_to_blur(s, 0.0, 15.0)
             for s in np.linspace(-0.5, 1.5, 41)]
    return scores, calls, emb.tolist(), curve


def test_scoring_matches_reference():
    ref, port = both(_scoring_script)
    assert port == ref
    assert len(ref[1]) == 1                 # one batched similarity call


# -- the game ------------------------------------------------------------------

def _store_contents(store):
    """A comparable view of a MemoryStore: keys, values (reserve blobs
    unpickled), TTLs; the per-generation uuids dropped."""
    out = {}
    for key in sorted(store._data):
        if not store._alive(key):
            continue
        value = store._data[key]
        if isinstance(value, dict):
            value = {f: (pickle.loads(v) if key == "reserve:rounds" else v)
                     for f, v in sorted(value.items())
                     if f not in ("next_gen", "promoted_gen")}
        elif isinstance(value, set):
            value = sorted(value)
        out[key] = (value, store._deadlines.get(key))
    return out


def _game_script(m, monkeypatch):
    base = m.config.test_config()
    cfg = base.replace(game=dataclasses.replace(base.game,
                                                reserve_capacity=3))
    clock = FakeClock()
    store = m.store.MemoryStore(clock=clock)
    backend = m.content.FakeContentBackend(image_size=32)
    game = m.game.Game(cfg, store, backend, m.content.hash_embed,
                       m.content.hash_similarity)
    game.rounds.rng = random.Random(3)
    monkeypatch.setattr(m.overload, "_LADDER", None)
    out = []

    async def session_view(sid):
        return (await game.fetch_prompt_json(sid),
                await game.client_status(sid),
                await game._reveal_radius(sid),
                await game.fetch_masked_image_b64(sid))

    async def run():
        await game.startup()
        out.append(("startup", _store_contents(store)))
        prompt = await game.rounds.fetch_current_prompt()
        tokens, masks = prompt["tokens"], prompt["masks"]
        for sid in ("s1", "s2", "s3"):
            await game.init_client(sid)
        out.append(await game.compute_client_scores(
            "s1", {str(masks[0]): "lighthouse", str(masks[1]): "zz"}))
        out.append(await game.compute_client_scores(
            "s2", {str(masks[0]): tokens[masks[0]].upper(),
                   "999": "stale"}))
        out.append(await game.compute_client_scores(
            "s3", {str(i): tokens[i] for i in masks}))
        out.append(await game.compute_client_scores("s1", {"999": "x"}))
        for sid in ("s1", "s2", "s3", "fresh"):
            out.append(await session_view(sid))
        clock.t += 0.5
        out.append(await game.clock_payload())
        await game.rounds.start_countdown()
        clock.t += 1.25
        out.append(await game.clock_payload())
        # a buffered promotion: sessions reset, the next round's masks
        await game.rounds.buffer_contents()
        out.append(("buffered", _store_contents(store)))
        await game.rounds.rollover()
        out.append(("promoted", _store_contents(store)))
        for sid in ("s1", "s3"):
            out.append(await session_view(sid))
        # the coarse-blur tier: buckets of 2 px, rounding up; the next
        # buffered round at half size
        ladder = m.overload.BrownoutLadder(m.overload.DEFAULT_TIERS,
                                           clock=clock)
        with ladder._lock:
            ladder._tier = 5
        monkeypatch.setattr(m.overload, "_LADDER", ladder)
        out.append(await session_view("s1"))
        out.append(sorted(game._image_cache))
        await game.rounds.buffer_contents()
        next_image = await store.hget("image", "next")
        out.append(m.codec.decode_jpeg(next_image).shape)
        monkeypatch.setattr(m.overload, "_LADDER", None)
        await game.rounds.rollover()
        # generation dark: the breaker open, promotion rotates the reserve
        breaker = game.supervisor.content_breaker
        for _ in range(breaker.failure_threshold):
            breaker.record_failure()
        await game.rounds.buffer_contents()
        await game.rounds.rollover()
        out.append(("reserve", _store_contents(store)))
        out.append(await session_view("s2"))
        out.append(await game.fetch_story())
        out.append(backend.calls)

    asyncio.run(run())
    return out


def test_game_matches_reference(monkeypatch):
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    ref, port = both(lambda m: _game_script(m, monkeypatch))
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, i
    # the script reached the win, the half-size tier round and the reserve
    assert ref[2]["won"] == 1
    assert (16, 16, 3) in ref
    assert ref[-1] == 3          # dark: the open breaker never dials


# -- masking agreement, codec, assets ------------------------------------------

def test_masking_agreement_report_matches_reference():
    ref, port = both(lambda m: m.agree.evaluate(m.content.hash_embed))
    assert port == ref
    assert ref["mask_agreement"] >= 0.8


def test_codec_matches_reference():
    rng = np.random.default_rng(5)
    image = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
    ref, port = both(lambda m: (m.codec.encode_jpeg(image),
                                m.codec.encode_jpeg(image, quality=60),
                                m.codec.image_to_base64(image)))
    assert port == ref
    for data in ref[:2]:
        np.testing.assert_array_equal(pcodec.decode_jpeg(data),
                                      jcodec.decode_jpeg(data))
    assert base64.b64decode(port[2]) == ref[0]


def test_assets_match_reference():
    ref, port = both(lambda m: (m.assets.load_seeds(),
                                m.assets.load_styles(),
                                m.assets.load_wordlist()))
    assert port == ref
    assert len(ref[2]) > 1000
