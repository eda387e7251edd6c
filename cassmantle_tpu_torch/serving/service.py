"""Inference service: the pipelines and batching queues behind the game's
injection points (embed, similarity, blur, the content backend).

Port of ``cassmantle_tpu/serving/service.py::InferenceService``
(``:55-357``) and ``_QueuedContentBackend``:

- guess scoring rides the score :class:`BatchingQueue`: concurrent
  ``await similarity(pairs)`` calls from many players coalesce into one
  bucketed MiniLM dispatch. Rung 0, the int8 wordlist table, answers
  pairs whose words it holds before any queue (:meth:`similarity`); the
  score breaker guards the rest;
- concurrent rounds' prompt decodes ride the prompt queue at background
  priority and coalesce into one batch of up to 8 rows
  (``PromptGenerator.BATCH_BUCKETS``); a queue failure degrades to the
  backend's own decode. Interactive scoring dispatches ahead of them
  under adaptive admission (``serving/overload.py``);
- one :class:`ServingSupervisor` owns the breakers, the dispatch
  watchdog and the ``device_lost`` state; dispatch exceptions are
  classified by the :class:`DeviceRecoveryManager`, whose single-flight
  rebuild reloads every pipeline's parameters in place and warms under
  ``no_new_captures`` (a scorer dispatch and a replay of the prompt
  LM's last decode);
- the integrity sentinels fail only the bad members of a batch.

The image pipeline follows the config: SD1.5 by default, SDXL under
``sdxl_config()`` (``TorchContentBackend``). It serves over ``mesh``, by
default :func:`default_serving_mesh`: batch data parallel over every
card when the host has more than one, meshless on one card (the scorer
and the prompt LM serve on the mesh's first card). Queue failures follow the
reference's degradations (floor scores, ``OverloadShed`` for a 503 with
Retry-After, the in-backend decode); nothing falls back to the CPU.
"""

from __future__ import annotations

import asyncio
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cassmantle_tpu_torch.config import FrameworkConfig, MeshConfig
from cassmantle_tpu_torch.obs.device import note_dispatch
from cassmantle_tpu_torch.ops.blur import device_blur
from cassmantle_tpu_torch.ops.embed_table import EmbedTable
from cassmantle_tpu_torch.ops.graphs import no_new_captures
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.parallel.mesh import Mesh, make_mesh
from cassmantle_tpu_torch.serving import integrity
from cassmantle_tpu_torch.serving.device_recovery import (
    DeviceRecoveryManager,
)
from cassmantle_tpu_torch.serving.integrity import OutputInvalid
from cassmantle_tpu_torch.serving.overload import (
    PRIORITY_BACKGROUND,
    make_admission,
    note_table_served,
)
from cassmantle_tpu_torch.engine.rounds import RoundContent
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    TorchContentBackend,
)
from cassmantle_tpu_torch.serving.queue import (
    BatchingQueue,
    DeadlineExceeded,
    DispatchTimeout,
    OverloadShed,
    QueueFull,
)
from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device
from cassmantle_tpu_torch.utils.logging import get_logger

log = get_logger("service")


def default_serving_mesh(cfg: FrameworkConfig, device: DeviceLike = "cuda"
                         ) -> Optional[Mesh]:
    """Batch-DP mesh over every card when more than one is visible (the
    reference's v5e-8 serving layout, here over a host's cards); None on
    one card, and for a service asked onto the CPU."""
    if resolve_device(device).type != "cuda" or torch.cuda.device_count() <= 1:
        return None
    mesh = make_mesh(MeshConfig(dp=-1))
    log.info("serving mesh: dp=%d", mesh.shape["dp"])
    return mesh


class InferenceService:
    """``table``: ``"auto"`` builds (or loads from the cache) the int8
    table of the game's wordlist with the service's own scorer; an
    :class:`EmbedTable` is used as given; None serves without rung 0.
    ``weights_dir``: the checkpoints and vocabularies every model loads
    from (``models/weights.py::CHECKPOINT_FILES``; absent ones: the
    seeded init), as the reference's ``InferenceService(cfg,
    weights_dir=...)``. ``supervisor``: the one a served ``Game`` shares
    (its content breaker guards round generation while the queues report
    to it), as the reference's server passes one in; None builds the
    service's own. ``mesh``: the image pipeline's device mesh (None: the
    :func:`default_serving_mesh`); ``backend``: a caller-built
    :class:`TorchContentBackend` (its pipelines are served as given), as
    the reference's arguments of those names."""

    def __init__(self, cfg: FrameworkConfig, device: DeviceLike = "cuda",
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 weights_dir: Optional[str] = None,
                 table: Union[str, EmbedTable, None] = "auto",
                 supervisor: Optional[ServingSupervisor] = None,
                 mesh: Optional[Mesh] = None,
                 backend: Optional[TorchContentBackend] = None) -> None:
        if mesh is None and backend is None:
            mesh = default_serving_mesh(cfg, device)
        if mesh is not None:
            device = mesh.home
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        sd = state_dicts or {}
        self.supervisor = supervisor or ServingSupervisor()
        self.scorer = EmbeddingScorer(
            cfg.models.minilm, self.device,
            batch_buckets=cfg.serving.score_batch_sizes,
            state_dict=sd.get("minilm"), seed=cfg.seed,
            weights_dir=weights_dir)
        self.table_stats: Optional[dict] = None
        if table == "auto":
            table, self.table_stats = self.scorer.build_table()
        self.scorer.arm_table(table)
        self.backend = backend or TorchContentBackend(
            cfg, self.device, state_dicts=sd, weights_dir=weights_dir,
            mesh=mesh)
        # the image pipeline's staged server reports stage progress and
        # quarantines to the same supervisor as the queues
        self.backend.t2i.supervisor = self.supervisor
        self._warm_count = 0
        self.recovery = DeviceRecoveryManager(
            supervisor=self.supervisor,
            rebuild=self.rebuild_device_state,
            warm=self.warm_after_recovery)
        self.supervisor.recovery = self.recovery
        s = cfg.serving
        queue_kw = dict(
            max_delay_ms=s.max_queue_delay_ms, max_pending=s.max_pending,
            default_deadline_s=s.submit_deadline_s,
            hang_timeout_s=s.dispatch_hang_s, supervisor=self.supervisor,
            degraded_max_pending=s.degraded_max_pending,
            background_every=s.background_every_batches,
            on_dispatch_error=self.recovery.note_dispatch_exception)
        self.score_queue: BatchingQueue = BatchingQueue(
            handler=self._score_batch, max_batch=max(s.score_batch_sizes),
            name="score", admission=make_admission("score", cfg),
            **queue_kw)
        # concurrent rounds coalesce their LM decodes into one batch
        self.prompt_queue: BatchingQueue = BatchingQueue(
            handler=self._prompt_batch,
            max_batch=max(PromptGenerator.BATCH_BUCKETS), name="prompt",
            admission=make_admission("prompt", cfg), **queue_kw)

    def _pipelines(self):
        return self.backend.t2i, self.backend.prompt_gen

    # -- handlers (on the dispatch thread) ---------------------------------
    def _score_batch(self, pairs: Sequence[Tuple[str, str]]):
        """The score queue's handler: pairs whose embedding came back
        non-finite (NaN similarity, never cached) fail alone with a
        retriable ``OutputInvalid``; the batch's other pairs resolve."""
        sims = self.scorer.similarity(list(pairs))
        note_dispatch("scorer")
        if integrity.integrity_disabled():
            return sims
        bad = ~np.isfinite(np.asarray(sims))
        if not bad.any():
            return sims
        return [OutputInvalid("scorer", "similarity", [i]) if bad[i]
                else sims[i] for i in range(len(sims))]

    def _prompt_batch(self, seeds: Sequence[str]):
        """The prompt queue's handler: rows the sentinel rejected come
        back as ``OutputInvalid`` and fail alone."""
        return self.backend.prompt_gen.generate_batch(list(seeds))

    # -- the game's injection points -----------------------------------------
    def embed(self, words: Sequence[str]) -> np.ndarray:
        return self.scorer.embed(list(words))

    def pin_answers(self, words: Sequence[str]) -> int:
        """Round promotion: pin the answers into the int8 table, so every
        in-vocabulary guess against them is rung-0-servable."""
        return self.scorer.pin_answers(list(words))

    async def similarity(self, pairs: Sequence[Tuple[str, str]]
                         ) -> np.ndarray:
        """[(guess, answer)] -> cosine per pair. Rung 0: pairs the int8
        table covers complete here as host dot products, with no queue,
        admission or breaker (``overload.table_served``); the rest ride
        the queued ladder."""
        pairs = list(pairs)
        table = self.scorer.table_scores(pairs)
        if table is not None:
            scores, served = table
            if served.all():
                note_table_served(len(pairs))
                return scores
            if served.any():
                rest_idx = [i for i, ok in enumerate(served) if not ok]
                note_table_served(len(pairs) - len(rest_idx))
                rest = await self._queued_similarity(
                    [pairs[i] for i in rest_idx])
                for j, i in enumerate(rest_idx):
                    scores[i] = rest[j]
                return scores
        return await self._queued_similarity(pairs)

    async def _queued_similarity(self, pairs) -> np.ndarray:
        """Each pair rides the batching queue. While the score breaker is
        open, floor scores at once; backpressure gives floor scores;
        ``OverloadShed`` propagates (a 503 with Retry-After); deadlines,
        the watchdog and invalid output count toward the breaker and give
        floor scores; anything else is classified for device loss and
        raised."""
        pairs = list(pairs)
        breaker = self.supervisor.score_breaker
        if not breaker.allow():
            log.warning("score breaker open; floor scores for %d pairs",
                        len(pairs))
            return np.zeros((len(pairs),), dtype=np.float32)
        try:
            results = await asyncio.gather(
                *(self.score_queue.submit(p) for p in pairs))
        except OverloadShed:
            raise
        except QueueFull:
            log.warning("score queue full; floor scores for %d pairs",
                        len(pairs))
            return np.zeros((len(pairs),), dtype=np.float32)
        except (DeadlineExceeded, DispatchTimeout) as exc:
            breaker.record_failure()
            log.warning("score dispatch failed (%s); floor scores for %d "
                        "pairs", type(exc).__name__, len(pairs))
            return np.zeros((len(pairs),), dtype=np.float32)
        except OutputInvalid as exc:
            breaker.record_failure()
            log.warning("invalid scorer output (%s); floor scores for %d "
                        "pairs", exc, len(pairs))
            return np.zeros((len(pairs),), dtype=np.float32)
        except Exception as exc:
            breaker.record_failure()
            self.recovery.note_dispatch_exception(exc)
            raise
        breaker.record_success()
        return np.asarray(results, dtype=np.float32)

    def blur(self, image: np.ndarray, radius: float) -> np.ndarray:
        return device_blur(image, radius, self.device)

    async def generate_content(self, seed: str, is_seed: bool = True
                               ) -> RoundContent:
        """One round, its text decode through the prompt queue at
        background priority (N concurrent rounds: one N-row decode), its
        image in the executor (``TorchContentBackend.generate``). A queue
        failure degrades to the backend's own decode."""
        text = None
        try:
            text = await self.prompt_queue.submit(
                seed, priority=PRIORITY_BACKGROUND)
        except (QueueFull, DeadlineExceeded, DispatchTimeout,
                OutputInvalid) as exc:
            log.warning("prompt queue failed (%s); decoding %r in-backend",
                        type(exc).__name__, seed[:40])
        try:
            return await self.backend.generate(seed, is_seed, text=text)
        except Exception as exc:
            # the image path dispatches outside the queues: classify here
            self.recovery.note_dispatch_exception(exc)
            raise

    @property
    def content_backend(self) -> "_QueuedContentBackend":
        """The content backend the game should own: the same pipelines,
        with ``generate`` coalescing decodes through the prompt queue."""
        return _QueuedContentBackend(self)

    # -- device-loss rebuild -------------------------------------------------
    def rebuild_device_state(self) -> None:
        """One rebuild attempt (on the recovery thread): every pipeline's
        and the scorer's models are built again on the device and copied
        into the served parameters in place; the image pipeline's staged
        server is dropped, to restart on the next generate. Raises on
        failure (a sticky CUDA error fails every attempt); the manager
        owns the retries."""
        for pipe in self._pipelines():
            pipe.reload_params()
        self.scorer.reload_params()

    def warm_after_recovery(self) -> None:
        """One real dispatch through the scorer (eager: it owns no graph)
        and the prompt LM's last decode again, which replays the graphs
        it captured, under ``no_new_captures``: a rebuild must leave
        every graph valid. A fresh word each time keeps the LRU from
        answering instead."""
        self._warm_count += 1
        with no_new_captures():
            self.scorer.embed([f"recovery warm {self._warm_count}"])
            self.backend.prompt_gen.replay_last_decode()

    async def stop(self) -> None:
        await self.score_queue.stop()
        await self.prompt_queue.stop()
        # the staged server's threads hold the image pipeline
        await asyncio.get_running_loop().run_in_executor(
            None, self.backend.t2i.drop_staged)


class _QueuedContentBackend:
    """Content backend whose ``generate`` is
    :meth:`InferenceService.generate_content`; other attributes are the
    inner backend's (``t2i``, ``prompt_gen``, ...)."""

    def __init__(self, service: InferenceService) -> None:
        self._service = service
        self.inner = service.backend

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def generate(self, seed: str, is_seed: bool = True
                       ) -> RoundContent:
        return await self._service.generate_content(seed, is_seed)
