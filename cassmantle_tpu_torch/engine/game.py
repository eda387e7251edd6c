"""Game facade: the engine API the HTTP layer talks to.

A copy of ``cassmantle_tpu/engine/game.py``. It composes sessions, rounds
and scoring over one state store: ``init_client``, ``client_status``,
``fetch_prompt_json``, ``compute_client_scores``,
``fetch_masked_image(_b64)``, ``fetch_story`` and the clock. Served by
the port, a Game takes the ``InferenceService``'s ``content_backend``,
``embed``, ``similarity``, ``blur`` (``ops/blur.py`` on the card, never
the host PIL fallback), ``supervisor`` and ``pin_answers``. The reveal
radius snaps onto the brownout ladder's blur buckets
(``serving/overload.py::quantize_blur_radius``), and each (round image,
bucket) renders once, single-flight.
"""

from __future__ import annotations

import asyncio
import zlib
from typing import Callable, Dict, Optional

import numpy as np

from cassmantle_tpu_torch.config import FrameworkConfig
from cassmantle_tpu_torch.engine.masking import EmbedFn
from cassmantle_tpu_torch.engine.reserve import RoundReserve
from cassmantle_tpu_torch.engine.rounds import ContentBackend, RoundManager
from cassmantle_tpu_torch.engine.scoring import GuessScorer, SimilarityFn, score_to_blur
from cassmantle_tpu_torch.engine.sessions import SessionManager
from cassmantle_tpu_torch.engine.store import StateStore
from cassmantle_tpu_torch.obs.trace import tracer
from cassmantle_tpu_torch.server.assets import load_seeds
from cassmantle_tpu_torch.serving.supervisor import ServingSupervisor
from cassmantle_tpu_torch.utils.logging import NULL_METRICS, metrics
from cassmantle_tpu_torch.utils.text import format_clock

# (image uint8 HWC, blur_radius) -> blurred uint8 HWC
BlurFn = Callable[[np.ndarray, float], np.ndarray]

# The synthetic-canary probe room. A game built for this
# room plays the full engine surface but emits NO engine metrics:
# probe traffic must never pollute game.guesses, cache-hit ratios, or
# latency histograms that feed capacity estimation and SLO burn.
PROBE_ROOM = "__probe__"


def _pil_blur(image: np.ndarray, radius: float) -> np.ndarray:
    """Host fallback blur; served games inject the device blur op."""
    from PIL import Image, ImageFilter

    if radius <= 0:
        return image
    pil = Image.fromarray(image).filter(ImageFilter.GaussianBlur(radius))
    return np.asarray(pil)


class Game:
    def __init__(
        self,
        cfg: FrameworkConfig,
        store: StateStore,
        backend: ContentBackend,
        embed: EmbedFn,
        similarity: SimilarityFn,
        blur_fn: Optional[BlurFn] = None,
        supervisor: Optional[ServingSupervisor] = None,
        room: Optional[str] = None,
        pin_answers=None,
    ) -> None:
        game_cfg = cfg.game
        self.cfg = cfg
        self.store = store
        # per-room metric labels: a fabric-built
        # game labels its engine series with its room so N rooms on one
        # worker stay distinguishable series instead of blending into
        # one. None (legacy single-game callers) keeps every series'
        # exact historical unlabeled key.
        self.room = room
        self._metric_labels: Optional[Dict[str, str]] = (
            {"room": room} if room else None
        )
        # probe-room games swap the registry for a no-op sink: canary
        # traffic exercises the real code paths without contributing a
        # single engine series
        self._metrics = NULL_METRICS if room == PROBE_ROOM else metrics
        # the degradation control plane: a served game shares one
        # supervisor with the InferenceService; standalone/fake games get
        # their own
        self.supervisor = supervisor or ServingSupervisor()
        self.reserve = (
            RoundReserve(store, capacity=game_cfg.reserve_capacity)
            if game_cfg.reserve_capacity > 0 else None
        )
        self.sessions = SessionManager(
            store, game_cfg.min_score, game_cfg.time_per_prompt
        )
        self.scorer = GuessScorer(similarity, game_cfg.min_score)
        self.rounds = RoundManager(
            store,
            backend,
            embed,
            seeds=self._load_seeds(),
            time_per_prompt=game_cfg.time_per_prompt,
            buffer_at_fraction=game_cfg.buffer_at_fraction,
            num_masked=game_cfg.num_masked,
            episodes_per_story=game_cfg.episodes_per_story,
            lock_timeout=game_cfg.lock_timeout,
            acquire_timeout=game_cfg.acquire_timeout,
            on_promote=self._reset_sessions,
            # answer pin hook (ops/embed_table.py): a served game wires
            # InferenceService.pin_answers; None keeps rounds pin-free
            on_answers=pin_answers,
            reserve=self.reserve,
            breaker=self.supervisor.content_breaker,
            metric_labels=self._metric_labels,
        )
        self.blur_fn = blur_fn or _pil_blur
        # blur bucket -> base64 JPEG, all for one round image identified
        # by _image_cache_key (int version, or a byte fingerprint tuple
        # for legacy stores)
        self._image_cache: Dict[float, str] = {}
        self._image_cache_key: object = None
        # bucket -> in-flight render task (single-flight misses)
        self._image_renders: Dict[float, asyncio.Task] = {}

    def _load_seeds(self) -> list:
        return load_seeds()

    async def _reset_sessions(self) -> None:
        await self.sessions.reset_all(await self.rounds.current_masks())

    # -- lifecycle --------------------------------------------------------
    async def startup(self) -> None:
        await self.rounds.startup()

    def start_timer(self, tick: float = 1.0) -> asyncio.Task:
        return self.rounds.start(tick)

    async def shutdown(self) -> None:
        await self.rounds.stop()
        await self.store.close()

    # -- client API -------------------------------------------------------
    async def init_client(self, session: str) -> None:
        await self.sessions.init_client(
            session, await self.rounds.current_masks()
        )

    async def client_status(self, session: Optional[str]) -> Dict[str, object]:
        if not session or not await self.sessions.exists(session):
            return {"needInitialization": True}
        scores = await self.sessions.fetch_scores(session)
        return {
            "won": int(scores.get("won", 0) or 0),
            "needInitialization": False,
        }

    async def ensure_client(self, session: str) -> None:
        if not await self.sessions.exists(session):
            await self.init_client(session)

    async def _reveal_radius(self, session: str) -> float:
        """The one place the score -> blur-radius curve is applied."""
        scores = await self.sessions.fetch_scores(session)
        best = float(scores.get("max", self.cfg.game.min_score))
        return score_to_blur(
            best, self.cfg.game.min_blur, self.cfg.game.max_blur
        )

    async def fetch_masked_image(self, session: str) -> np.ndarray:
        """Per-session progressive reveal (server.py:129-133)."""
        radius = await self._reveal_radius(session)
        image = await self.rounds.fetch_current_image()

        def render() -> np.ndarray:
            # same off-loop rule as _render_bucket: blur is CPU/device
            # work that must not stall the event loop (to_thread copies
            # contextvars, so the span lands in the request trace)
            with tracer.span("game.blur"), \
                    self._metrics.timer("game.blur_s",
                                        labels=self._metric_labels):
                return self.blur_fn(image, radius)

        return await asyncio.to_thread(render)

    async def fetch_masked_image_b64(self, session: str) -> str:
        """The hot-request form of the reveal: blur radii quantize to
        0.5-px buckets and each (round image, bucket) renders ONCE —
        later requests reuse the cached base64 JPEG. The reference
        decoded, blurred (PIL), and re-encoded per request; with ≤31 buckets a round's entire blur
        ladder amortizes to 31 renders regardless of player count.

        Invalidation keys on the round's monotonic image version
        (rounds.py bumps it after every current-image write), so cache
        hits cost a few store bytes, not the full JPEG — and promotions
        by OTHER workers through a shared store invalidate too. The
        version is read BEFORE the bytes and re-read AFTER rendering:
        versions bump only after bytes land, so equality across the
        render proves the bytes belonged to that version — a render
        that straddles a promotion is served but never cached. Misses
        are single-flight per bucket: the reset-flag refetch stampede
        (every client at once, right after invalidation) coalesces to
        one decode+blur+encode. (Version 0 = legacy store: fall back to
        fingerprinting the bytes.)"""
        radius = await self._reveal_radius(session)
        # blur-ladder quantum: 0.5 px normally; a brownout tier
        # coarsens it (serving/overload.py) so a degraded round renders
        # FEWER distinct decode+blur+encode buckets — coarse buckets
        # round UP, so degradation only ever adds blur (lazy import:
        # the engine stays importable without serving)
        from cassmantle_tpu_torch.serving.overload import quantize_blur_radius

        bucket = quantize_blur_radius(radius)
        ver: object = await self.rounds.current_image_version()
        legacy_raw: Optional[bytes] = None
        if ver == 0:
            legacy_raw = await self.rounds.fetch_current_image_bytes()
            ver = (len(legacy_raw), zlib.crc32(legacy_raw))
        if ver != self._image_cache_key:
            self._image_cache_key = ver
            self._image_cache.clear()
            self._image_renders = {}
        cached = self._image_cache.get(bucket)
        if cached is not None:
            self._metrics.inc("game.image_cache_hits",
                              labels=self._metric_labels)
            return cached
        task = self._image_renders.get(bucket)
        if task is not None:
            self._metrics.inc("game.image_cache_hits",
                              labels=self._metric_labels)
        else:
            self._metrics.inc("game.image_cache_misses",
                              labels=self._metric_labels)
            # the render runs as its OWN task: a waiter's cancellation
            # (client disconnect) must not cancel the shared render or
            # propagate to the other coalesced waiters
            task = asyncio.get_running_loop().create_task(
                self._render_bucket(bucket, ver, legacy_raw)
            )
            self._image_renders[bucket] = task

            def _cleanup(t: asyncio.Task, b=bucket) -> None:
                if self._image_renders.get(b) is t:
                    del self._image_renders[b]
                if not t.cancelled():
                    t.exception()   # mark retrieved (waiters re-raise it)

            task.add_done_callback(_cleanup)
        return await asyncio.shield(task)

    async def _render_bucket(self, bucket: float, ver: object,
                             raw: Optional[bytes]) -> str:
        from cassmantle_tpu_torch.utils.codec import decode_jpeg, image_to_base64

        if raw is None:
            raw = await self.rounds.fetch_current_image_bytes()

        def render() -> str:
            # CPU-bound decode+blur+encode runs OFF the event loop: a
            # bucket miss must not stall the 1 Hz WS clock pushes or
            # concurrent requests for the tens of ms it takes (PIL and
            # JPEG codecs release the GIL; the device blur op just blocks
            # this worker thread on device dispatch)
            image = decode_jpeg(raw)
            with tracer.span("game.blur"), \
                    self._metrics.timer("game.blur_s",
                                        labels=self._metric_labels):
                blurred = self.blur_fn(image, bucket)
            return image_to_base64(np.asarray(blurred))

        encoded = await asyncio.to_thread(render)
        # cache only if the version is provably still current: bumps
        # happen after bytes land, so unchanged version == our bytes
        # belong to it (isinstance check skips the re-read for legacy
        # fingerprint keys, which are derived from the bytes anyway)
        if not isinstance(ver, int) or \
                ver == await self.rounds.current_image_version():
            if ver == self._image_cache_key:
                self._image_cache[bucket] = encoded
        return encoded

    async def fetch_prompt_json(self, session: str) -> Dict[str, object]:
        """Client-visible prompt state (server.py:96-123): solved masks are
        flagged -1 + listed in ``correct``; unsolved mask tokens are '*'."""
        prompt = await self.rounds.fetch_current_prompt()
        await self.ensure_client(session)
        scores = await self.sessions.fetch_scores(session)
        attempts = int(scores.get("attempts", 0) or 0)
        prompt = {
            "tokens": list(prompt["tokens"]),
            "masks": list(prompt["masks"]),
            "correct": [],
        }
        if int(scores.get("won", 0) or 0) == 1:
            prompt["masks"] = []
        else:
            for i, mask in enumerate(list(prompt["masks"])):
                score = scores.get(str(mask))
                if score is not None and float(score) == 1.0:
                    prompt["masks"][i] = -1
                    prompt["correct"].append(mask)
                else:
                    prompt["tokens"][mask] = "*"
        prompt["scores"] = scores
        prompt["attempts"] = attempts
        return prompt

    async def fetch_story(self) -> Dict[str, str]:
        return await self.rounds.fetch_story()

    async def compute_client_scores(
        self, session: str, inputs: Dict[str, str]
    ) -> Dict[str, object]:
        """Guess path (server.py:63-76): score inputs against the masked
        answer tokens, update the session, bump attempts."""
        await self.ensure_client(session)
        prompt = await self.rounds.fetch_current_prompt()
        tokens = prompt["tokens"]
        valid_masks = {str(m) for m in prompt["masks"]}
        pairs = {}
        for mask_idx, guess in inputs.items():
            if str(mask_idx) not in valid_masks:
                continue  # stale or hostile input; reference would KeyError
            pairs[str(mask_idx)] = {
                "input": str(guess),
                "answer": tokens[int(mask_idx)],
            }
        if not pairs:
            return {"won": 0}
        with tracer.span("game.score", attrs={"pairs": len(pairs)}), \
                self._metrics.timer("game.score_s",
                                    labels=self._metric_labels):
            scores = await self.scorer.score_pairs(pairs)
        result = await self.sessions.set_scores(session, scores)
        await self.sessions.increment_attempt(session)
        self._metrics.inc("game.guesses", len(pairs),
                          labels=self._metric_labels)
        return result

    # -- clock / presence -------------------------------------------------
    async def fetch_clock(self) -> str:
        return format_clock(await self.rounds.remaining())

    async def clock_payload(self) -> Dict[str, object]:
        """One WS /clock tick (main.py:61-67)."""
        return {
            "time": await self.fetch_clock(),
            "reset": await self.rounds.reset_flag(),
            "conns": await self.sessions.player_count(),
        }
