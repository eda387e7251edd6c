"""A ``Game`` served by the port's ``InferenceService`` on the CPU at
``test_config()`` sizes, as the reference's round drill wires it: the
service's queued content backend, ``embed``, ``similarity``, ``blur`` and
``pin_answers``, and one supervisor shared by the service (built with
``supervisor=``) and the game. Through startup, a guess on each scoring
rung (rung 0, the int8 table, with the round's answers pinned at
startup; and the device rung), a masked image, a promotion through the
round timer, and the coarse-blur brownout tier: the next buffered round
at half size, counted in ``pipeline.brownout_images``, and the reveal
radius on 2 px buckets, rounded up.

Scores: a game score is the direct ``similarity`` of its pair clamped to
[min_score, 0.999] (exact matches 1.0): within 1e-6 of the service's own
call on the device rung, and within 1e-2 of the fp32 device embeddings
on rung 0, as the serving tests hold them.
"""

import asyncio
import base64
import io
import random

import numpy as np
import pytest
from PIL import Image

from cassmantle_tpu_torch.config import test_config as tiny_config
from cassmantle_tpu_torch.engine.game import Game
from cassmantle_tpu_torch.engine.store import MemoryStore
from cassmantle_tpu_torch.serving import overload
from cassmantle_tpu_torch.serving.service import InferenceService
from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor
from cassmantle_tpu_torch.utils.logging import metrics

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)

TABLE_WORDS = ["lighthouse", "caravan", "comet", "orchard", "harbor",
               "amber", "violet", "glacier", "station", "canyon"]


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _clamp(sim: float, min_score: float) -> float:
    return max(min_score, min(float(sim), 0.999))


def test_game_served_by_the_port(tmp_path, monkeypatch):
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    overload.reset_brownout()
    cfg = tiny_config()
    size, min_score = cfg.sampler.image_size, cfg.game.min_score
    supervisor = ServingSupervisor()
    svc = InferenceService(cfg, device="cpu", table=None,
                           supervisor=supervisor)
    table, _ = svc.scorer.build_table(TABLE_WORDS,
                                      path=str(tmp_path / "table.npz"))
    svc.scorer.arm_table(table)
    game = Game(cfg, MemoryStore(), svc.content_backend, svc.embed,
                svc.similarity, blur_fn=svc.blur, supervisor=supervisor,
                pin_answers=svc.pin_answers)
    game.rounds.rng = random.Random(0)
    assert game.supervisor is svc.supervisor
    assert game.rounds.breaker is supervisor.content_breaker
    count = metrics.counter_total

    async def play():
        await game.startup()
        prompt = await game.rounds.fetch_current_prompt()
        tokens, masks = prompt["tokens"], prompt["masks"]
        answers = [tokens[i].lower() for i in masks]
        # the answers were pinned when the round became current
        assert all(table.contains(a) for a in answers)
        await game.init_client("p")
        view = await game.fetch_prompt_json("p")
        assert all(view["tokens"][i] == "*" for i in masks)
        # rung 0 on the first mask (a table word that is not an answer:
        # an exact match never reaches the scorer), the device rung on the
        # second
        word = next(w for w in TABLE_WORDS if w not in answers)
        guesses = {str(masks[0]): word, str(masks[1]): "zq-unknown-word"}
        hits, batches = count("scorer.table_hits"), count("score.batches")
        result = await game.compute_client_scores("p", guesses)
        # the first pair's two words and the second pair's answer
        assert count("scorer.table_hits") - hits == 3
        assert count("score.batches") - batches == 1
        device = await svc.similarity([("zq-unknown-word", answers[1])])
        assert float(result[str(masks[1])]) == pytest.approx(
            _clamp(device[0], min_score), abs=1e-6)
        emb = svc.scorer._embed_device([word, answers[0]])[0]
        assert float(result[str(masks[0])]) == pytest.approx(
            _clamp(emb[0] @ emb[1], min_score), abs=1e-2)
        image = _decode(await game.fetch_masked_image_b64("p"))
        assert image.shape == (size, size, 3)

        # one promotion through the round timer (2 s rounds, buffered at
        # 70%): the sessions reset and the masks follow the new text
        promoted = count("rounds.promoted")
        timer = game.start_timer(tick=0.05)
        for _ in range(400):
            if count("rounds.promoted") > promoted:
                break
            await asyncio.sleep(0.05)
        await game.rounds.stop()
        assert count("rounds.promoted") == promoted + 1 and timer.done()
        after = await game.rounds.fetch_current_prompt()
        assert after["tokens"] != tokens
        assert all(0 <= i < len(after["tokens"]) for i in after["masks"])
        scores = await game.sessions.fetch_scores("p")
        assert scores["attempts"] == "0" and float(scores["max"]) == min_score

        # the coarse-blur tier: 2 px buckets rounding up, the next
        # buffered round at half size through the tier's variant
        ladder = overload.BrownoutLadder(overload.DEFAULT_TIERS)
        with ladder._lock:
            ladder._tier = 5
        monkeypatch.setattr(overload, "_LADDER", ladder)
        radius = await game._reveal_radius("p")
        image = _decode(await game.fetch_masked_image_b64("p"))
        assert image.shape == (size, size, 3)
        (bucket,) = game._image_cache
        assert bucket % 2.0 == 0 and radius <= bucket < radius + 2.0
        degraded = count("pipeline.brownout_images")
        await game.rounds.buffer_contents()
        assert count("pipeline.brownout_images") - degraded == 1
        raw = await game.store.hget("image", "next")
        assert _decode(base64.b64encode(raw)).shape == (size // 2,
                                                        size // 2, 3)
        await svc.stop()

    asyncio.run(play())
