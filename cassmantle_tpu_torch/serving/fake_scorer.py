"""Drill scorer: hash similarity behind a real BatchingQueue.

A copy of ``cassmantle_tpu/serving/fake_scorer.py``. The fake backend's
instant hash scorer can never be overloaded; this one puts the same
deterministic similarity behind a real
:class:`~cassmantle_tpu_torch.serving.queue.BatchingQueue` whose handler
holds the dispatch thread ``ServingConfig.fake_score_batch_ms`` a batch,
so a ``--fake`` worker exercises the real admission, priority and
Retry-After machinery. No device.
"""

from __future__ import annotations

import time

import numpy as np

from cassmantle_tpu_torch.serving.overload import make_admission
from cassmantle_tpu_torch.serving.queue import (
    BatchingQueue,
    DeadlineExceeded,
    OverloadShed,
    QueueFull,
)
from cassmantle_tpu_torch.utils.logging import get_logger

log = get_logger("fake_scorer")


class FakeQueuedScorer:
    """Wired by ``server.app._serving_components`` when
    ``ServingConfig.fake_score_batch_ms`` > 0 on a --fake worker."""

    def __init__(self, cfg, supervisor=None) -> None:
        from cassmantle_tpu_torch.engine.content import hash_embed

        batch_s = cfg.serving.fake_score_batch_ms / 1000.0
        max_batch = max(cfg.serving.score_batch_sizes)

        def handler(pairs):
            time.sleep(batch_s)      # the simulated device dispatch
            guesses = hash_embed([g for g, _ in pairs])
            answers = hash_embed([a for _, a in pairs])
            return np.sum(guesses * answers, axis=-1)

        self.queue: BatchingQueue = BatchingQueue(
            handler=handler,
            max_batch=max_batch,
            max_delay_ms=cfg.serving.max_queue_delay_ms,
            max_pending=cfg.serving.max_pending,
            name="score",
            default_deadline_s=cfg.serving.submit_deadline_s,
            hang_timeout_s=cfg.serving.dispatch_hang_s,
            supervisor=supervisor,
            degraded_max_pending=cfg.serving.degraded_max_pending,
            admission=make_admission("score", cfg),
            background_every=cfg.serving.background_every_batches,
        )

    def _retry_after_s(self) -> float:
        adm = self.queue.admission
        return (adm.retry_after_s(self.queue.depth())
                if adm is not None else 1.0)

    async def similarity(self, pairs) -> np.ndarray:
        import asyncio

        pairs = list(pairs)
        try:
            results = await asyncio.gather(
                *(self.queue.submit(p) for p in pairs))
        except OverloadShed:
            raise                    # HTTP answers 503 + Retry-After
        except DeadlineExceeded as exc:
            # a queued item that expired anyway IS overload: convert so
            # the player sees a computed Retry-After, not a 500
            raise OverloadShed("score", reason="deadline",
                               retry_after_s=self._retry_after_s()
                               ) from exc
        except QueueFull:
            return np.zeros((len(pairs),), dtype=np.float32)
        return np.asarray(results, dtype=np.float32)

    async def stop(self) -> None:
        await self.queue.stop()
