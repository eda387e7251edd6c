"""Round lifecycle: story line, content double-buffer, global clock.

A copy of ``cassmantle_tpu/engine/rounds.py``:

- the countdown is a store key with a TTL; reading the clock = reading the
  TTL;
- at ``buffer_at_fraction`` of the round, the *next* round's content is
  generated into a buffer;
- at 0, the buffer is atomically promoted, sessions reset, the clock
  restarts, and a 1 s ``reset`` flag tells clients to refetch;
- every story runs ``episodes_per_story`` episodes, each episode's prompt
  continuing from the previous one, then a fresh seed starts a new story;
- generation and promotion run under store locks with skip-don't-crash
  semantics: an empty buffer first falls back to the store-backed round
  reserve (engine/reserve.py), and only an empty reserve replays the
  current round.

Generation sits behind the :class:`ContentBackend` protocol (the port's
``InferenceService.content_backend`` when served, a deterministic fake in
tests), guarded by the supervisor's content circuit breaker.
:class:`RoundContent` is the one class the engine and the serving backend
share (``serving/pipeline.py`` imports it from here).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from cassmantle_tpu_torch.chaos import afault_point
from cassmantle_tpu_torch.engine.masking import EmbedFn, build_prompt_state
from cassmantle_tpu_torch.engine.reserve import RoundReserve
from cassmantle_tpu_torch.engine.store import LockTimeout, StateStore
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import tracer
from cassmantle_tpu_torch.serving.integrity import OutputInvalid
from cassmantle_tpu_torch.utils.circuit import CircuitBreaker, CircuitOpen
from cassmantle_tpu_torch.utils.codec import decode_jpeg, encode_jpeg
from cassmantle_tpu_torch.utils.logging import get_logger, metrics
from cassmantle_tpu_torch.utils.retry import linear_backoff, retry_async

log = get_logger("rounds")

PROMPT_KEY = "prompt"
IMAGE_KEY = "image"
STORY_KEY = "story"
COUNTDOWN_KEY = "countdown"
RESET_KEY = "reset"


@dataclasses.dataclass
class RoundContent:
    """One round's generated content."""

    prompt_text: str          # the two-sentence episode text
    image: np.ndarray         # uint8 HWC RGB
    # what the round drew for its image: the styled prompt and the seed
    image_prompt: str = ""
    image_seed: int = 0


class ContentBackend:
    """Produces round content. ``seed`` is the story-so-far (or a fresh
    title when ``is_seed``); returns the episode text + rendered image."""

    async def generate(self, seed: str, is_seed: bool) -> RoundContent:
        raise NotImplementedError


class RoundManager:
    def __init__(
        self,
        store: StateStore,
        backend: ContentBackend,
        embed: EmbedFn,
        *,
        seeds: Sequence[str],
        time_per_prompt: float = 900.0,
        buffer_at_fraction: float = 0.7,
        num_masked: int = 2,
        episodes_per_story: int = 20,
        lock_timeout: float = 120.0,
        acquire_timeout: float = 2.0,
        max_retries: int = 5,
        retry_backoff_s: float = 2.0,
        rng: Optional[random.Random] = None,
        on_promote: Optional[Callable[[], object]] = None,
        on_answers: Optional[Callable[[Sequence[str]], object]] = None,
        reserve: Optional[RoundReserve] = None,
        breaker: Optional[CircuitBreaker] = None,
        metric_labels: Optional[Dict[str, str]] = None,
    ) -> None:
        self.store = store
        self.backend = backend
        self.embed = embed
        self.seeds = list(seeds)
        self.time_per_prompt = time_per_prompt
        self.buffer_at_fraction = buffer_at_fraction
        self.num_masked = num_masked
        self.episodes_per_story = episodes_per_story
        self.lock_timeout = lock_timeout
        self.acquire_timeout = acquire_timeout
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.rng = rng or random.Random()
        # async callback run after each promotion (the game layer resets
        # sessions there, mirroring server.py:168).
        self.on_promote = on_promote
        # sync hook fed the new round's masked answer words whenever a
        # round becomes current (startup, promotion, reserve rotation):
        # the serving layer pins them into the scorer's int8 embed
        # table off the guess path (ops/embed_table.py)
        self.on_answers = on_answers
        # supervision seam: archive every generated round into
        # the reserve ring; fail generation fast while the breaker is
        # open so a dark device costs nothing per round and promotion
        # rotates reserve content instead of replaying.
        self.reserve = reserve
        self.breaker = breaker
        # per-room series labels: None = the exact
        # historical unlabeled keys (legacy single-game callers)
        self.metric_labels = metric_labels
        self._timer_task: Optional[asyncio.Task] = None
        self._buffer_task: Optional[asyncio.Task] = None

    # -- story ------------------------------------------------------------
    def select_seed(self) -> str:
        return self.rng.choice(self.seeds)

    async def init_story(self, title: str) -> None:
        await self.store.hset(STORY_KEY, mapping={"title": title, "episode": 0})

    async def fetch_story(self) -> Dict[str, str]:
        raw = await self.store.hgetall(STORY_KEY)
        return {k: v.decode() for k, v in raw.items()}

    async def _next_seed(self) -> tuple:
        """(is_seed, seed): continue the story or start a new one
        (reference ``random_seed``, backend.py:137-150)."""
        eps_raw = await self.store.hget(STORY_KEY, "episode")
        episodes = int(eps_raw or 0)
        if episodes < self.episodes_per_story:
            prev = await self.store.hget(PROMPT_KEY, "seed")
            if prev is not None:
                return False, prev.decode()
        return True, self.select_seed()

    async def _attempt_generate(self, seed: str, is_seed: bool) -> RoundContent:
        """One guarded backend call: fail fast while the breaker is open
        (no device dial, no backoff burn), and record every attempt's
        outcome so repeated failures trip it."""
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpen(self.breaker.name)
        try:
            # generation fault point, INSIDE the guarded attempt: an
            # injected failure counts toward the breaker and rides the
            # same retry/reserve degradation a real dark device does
            # (the chaos port of tests/test_fault_injection.py's
            # FlakyBackend/DeadBackend monkeypatching)
            await afault_point("round.generate")
            # a ROOT trace per generation attempt: round generation is
            # background work with no HTTP request to inherit from, and
            # the pipeline's stage spans (prompt decode, t2i) need an
            # ambient trace to land in
            with tracer.span("round.generate", root=True,
                             attrs={"is_seed": is_seed}):
                content = await self.backend.generate(seed, is_seed)
        except OutputInvalid as exc:
            # the integrity sentinel rejected device output:
            # retriable like any attempt failure, but counted apart so a
            # sick device is distinguishable from queue pressure in the
            # round-generation failure mix
            metrics.inc("rounds.generate_invalid",
                        labels=self.metric_labels)
            log.warning("round generation rejected invalid output: %s",
                        exc)
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()
        return content

    async def _generate(self, seed: str, is_seed: bool) -> RoundContent:
        """Generation with regeneration-retry (reference retries failed API
        calls ≤5x, utils.py:43-61; here failed device generations retry the
        same way before the round falls back to a replay). Callers hold
        startup/buffer locks, so total retry time is deadline-bounded
        below the lock timeout — the lock can't lapse mid-retry and let a
        second worker interleave writes into the same slot. A breaker
        rejection aborts the retry loop outright: backing off against an
        open breaker is pure wasted lock time."""
        return await retry_async(
            lambda: self._attempt_generate(seed, is_seed),
            max_retries=self.max_retries,
            backoff=linear_backoff(self.retry_backoff_s),
            name="generate",
            deadline_s=0.8 * self.lock_timeout,
            give_up_on=(CircuitOpen,),
        )

    # -- content helpers --------------------------------------------------
    async def _store_content(self, slot: str, content: RoundContent) -> None:
        prompt_state = build_prompt_state(
            content.prompt_text, self.embed, self.num_masked
        )
        state_json = json.dumps(prompt_state)
        jpeg = encode_jpeg(content.image)
        await self.store.hset(PROMPT_KEY, "seed", content.prompt_text)
        await self.store.hset(PROMPT_KEY, slot, state_json)
        await self.store.hset(IMAGE_KEY, slot, jpeg)
        if slot == "next":
            # generation id for idempotent promotion: a
            # worker killed between the current-slot writes and the
            # buffer cleanup must not let the NEXT promote re-run the
            # whole promotion (double episode bump) — promote_buffer
            # compares this id against the last promoted one
            import uuid as _uuid

            await self.store.hset(PROMPT_KEY, "next_gen",
                                  _uuid.uuid4().hex)
        if slot == "current":
            await self._bump_image_version()
            await self._notify_answers(prompt_state)
        if self.reserve is not None:
            # archive exactly the bytes a promotion writes; a reserve
            # hiccup must never fail the generation that just succeeded
            try:
                await self.reserve.archive(
                    content.prompt_text, state_json, jpeg)
            except Exception:
                log.exception("reserve archive failed")
                metrics.inc("reserve.archive_failures")

    async def _notify_answers(self, prompt_state) -> None:
        """Feed the round's masked answer words to ``on_answers``
        (production: InferenceService.pin_answers → the scorer's int8
        table) so answers are embedded and pinned at promotion time,
        not on the first guess. The hook is sync and may device-embed,
        so it runs on a worker thread; any failure is swallowed
        (``rounds.answer_pin_failures``) — pinning is an optimization,
        never round-lifecycle-critical."""
        if self.on_answers is None or prompt_state is None:
            return
        try:
            if isinstance(prompt_state, bytes):
                prompt_state = json.loads(prompt_state.decode())
            elif isinstance(prompt_state, str):
                prompt_state = json.loads(prompt_state)
            tokens = prompt_state["tokens"]
            answers = [str(tokens[int(i)]) for i in prompt_state["masks"]]
            await asyncio.to_thread(self.on_answers, answers)
        except Exception:
            log.exception("answer pin hook failed")
            metrics.inc("rounds.answer_pin_failures",
                        labels=self.metric_labels)

    async def _bump_image_version(self) -> None:
        """Monotonic counter, bumped AFTER every current-image write (so
        a version implies its bytes are already in place) — readers use
        it as a cheap cross-worker cache-invalidation key instead of
        fetching and fingerprinting the full JPEG per request.

        The counter starts at a RANDOM offset: after a store flush the
        count would otherwise restart at 1 and collide with a version a
        worker already cached for the pre-flush round, serving stale
        images until the next promotion."""
        if await self.store.hget(IMAGE_KEY, "version") is None:
            await self.store.hset(
                IMAGE_KEY, "version",
                str(self.rng.getrandbits(48)),
            )
        await self.store.hincrby(IMAGE_KEY, "version", 1)

    async def current_image_version(self) -> int:
        """0 means a store written before versioning (legacy/fresh)."""
        raw = await self.store.hget(IMAGE_KEY, "version")
        return int(raw) if raw is not None else 0

    async def fetch_current_prompt(self) -> Dict[str, object]:
        raw = await self.store.hget(PROMPT_KEY, "current")
        assert raw is not None, "no current prompt available"
        return json.loads(raw.decode())

    async def fetch_current_image_bytes(self) -> bytes:
        raw = await self.store.hget(IMAGE_KEY, "current")
        assert raw is not None, "no current image available"
        return raw

    async def fetch_current_image(self) -> np.ndarray:
        return decode_jpeg(await self.fetch_current_image_bytes())

    async def current_masks(self) -> list:
        return list((await self.fetch_current_prompt())["masks"])

    # -- lifecycle --------------------------------------------------------
    async def startup(self) -> None:
        """Generate initial content unless a live round survives in the
        store (resume-on-restart, backend.py:93-97)."""
        await self.store.hset(PROMPT_KEY, "status", "idle")
        await self.store.hset(IMAGE_KEY, "status", "idle")
        try:
            async with self.store.lock(
                "startup_lock", timeout=self.lock_timeout,
                blocking_timeout=self.acquire_timeout,
            ):
                if await self.store.hget(PROMPT_KEY, "current") is not None \
                        and await self.store.hget(IMAGE_KEY, "current") is not None:
                    log.info("resuming in-flight round from store")
                    await self._notify_answers(
                        await self.store.hget(PROMPT_KEY, "current"))
                    return
                title = self.select_seed()
                await self.init_story(title)
                with metrics.timer("round.generate_s",
                                   labels=self.metric_labels):
                    content = await self._generate(title, is_seed=True)
                await self._store_content("current", content)
                await self.store.hincrby(STORY_KEY, "episode", 1)
                metrics.inc("rounds.generated", labels=self.metric_labels)
                log.info("content initialization complete")
        except LockTimeout:
            log.info("startup lock held elsewhere; waiting for content")

    async def buffer_contents(self) -> None:
        """Pre-generate next round into the buffer (backend.py:152-202)."""
        try:
            async with self.store.lock(
                "buffer_lock", timeout=self.lock_timeout,
                blocking_timeout=self.acquire_timeout,
            ):
                if await self.store.hget(PROMPT_KEY, "next") is not None:
                    return
                is_seed, seed = await self._next_seed()
                if is_seed:
                    log.info("restarting storyline")
                    await self.store.hset(STORY_KEY, "next", seed)
                with metrics.timer("round.generate_s",
                                   labels=self.metric_labels):
                    content = await self._generate(seed, is_seed)
                await self._store_content("next", content)
                metrics.inc("rounds.buffered", labels=self.metric_labels)
                log.info("content buffering complete")
        except LockTimeout:
            log.info("buffer lock held elsewhere; skipping")
        except Exception as exc:
            log.exception("buffering failed; old round will replay")
            metrics.inc("rounds.buffer_failures", labels=self.metric_labels)
            flight_recorder.record("round.buffer_failed",
                                   error=type(exc).__name__)

    async def promote_buffer(self) -> None:
        """Swap next→current if a buffer exists (backend.py:204-238)."""
        try:
            async with self.store.lock(
                "promotion_lock", timeout=self.lock_timeout,
                blocking_timeout=self.acquire_timeout,
            ):
                prompt_next = await self.store.hget(PROMPT_KEY, "next")
                image_next = await self.store.hget(IMAGE_KEY, "next")
                next_gen = await self.store.hget(PROMPT_KEY, "next_gen")
                promoted = await self.store.hget(PROMPT_KEY,
                                                 "promoted_gen")
                if next_gen is not None and next_gen == promoted:
                    # this buffer ALREADY promoted its current slots: a
                    # worker died after the current writes + marker but
                    # before the tail. FINISH the interrupted tail
                    # instead of re-promoting — clients must see the
                    # new image version (a skipped bump would pin the
                    # old round's cached image against the new prompt
                    # all round), a pending storyline restart must
                    # land, and the episode advances ONCE. The only
                    # repeatable piece is the version bump (a crash
                    # after it but before the hdel re-bumps: one extra
                    # cache invalidation, never a stale serve); story
                    # and episode sit after the hdel, so this branch is
                    # their first and only run.
                    await self._bump_image_version()
                    await self.store.hdel(PROMPT_KEY, "next",
                                          "next_gen")
                    await self.store.hdel(IMAGE_KEY, "next")
                    next_story = await self.store.hget(STORY_KEY,
                                                       "next")
                    if next_story is not None:
                        await self.init_story(next_story.decode())
                        await self.store.hdel(STORY_KEY, "next")
                    await self.store.hincrby(STORY_KEY, "episode", 1)
                    metrics.inc("rounds.promote_dedup",
                                labels=self.metric_labels)
                    flight_recorder.record("round.promote_dedup")
                    log.warning("buffer was already promoted by a "
                                "crashed worker; finished its cleanup "
                                "without re-promoting")
                    await self._notify_answers(
                        await self.store.hget(PROMPT_KEY, "current"))
                    return
                if prompt_next is None or image_next is None:
                    # generation is dark (breaker open / buffer failed):
                    # rotate a reserve round so players get a FRESH
                    # puzzle; replay only when the reserve is empty too
                    if await self._promote_from_reserve():
                        return
                    log.warning("no buffered content; replaying round")
                    metrics.inc("rounds.replays", labels=self.metric_labels)
                    flight_recorder.record("round.replayed")
                    return
                prompt_prev = await self.store.hget(PROMPT_KEY, "current")
                image_prev = await self.store.hget(IMAGE_KEY, "current")
                try:
                    await self.store.hset(PROMPT_KEY, "current", prompt_next)
                    await self.store.hset(IMAGE_KEY, "current", image_next)
                except Exception:
                    # the two current-slot writes span two store keys and
                    # are not atomic; a failure between them would serve a
                    # prompt that doesn't match the image for a whole
                    # round. Best-effort rollback to the consistent old
                    # pair keeps the replay contract true.
                    log.exception("promotion write failed; rolling back")
                    if prompt_prev is not None and image_prev is not None:
                        await self.store.hset(
                            PROMPT_KEY, "current", prompt_prev)
                        await self.store.hset(
                            IMAGE_KEY, "current", image_prev)
                        # the restore is also a current-image change
                        await self._bump_image_version()
                    raise
                if next_gen is not None:
                    # the promotion marker lands RIGHT AFTER the
                    # current-slot writes: the crash window where a
                    # retry would double-promote shrinks to the gap
                    # between these two writes (and a double there
                    # rewrites identical bytes; only the episode
                    # counter could run ahead by one)
                    await self.store.hset(PROMPT_KEY, "promoted_gen",
                                          next_gen)
                await self._bump_image_version()
                await self.store.hdel(PROMPT_KEY, "next", "next_gen")
                await self.store.hdel(IMAGE_KEY, "next")
                next_story = await self.store.hget(STORY_KEY, "next")
                if next_story is not None:
                    await self.init_story(next_story.decode())
                    await self.store.hdel(STORY_KEY, "next")
                await self.store.hincrby(STORY_KEY, "episode", 1)
                metrics.inc("rounds.promoted", labels=self.metric_labels)
                flight_recorder.record("round.promoted")
                await self._notify_answers(prompt_next)
                log.info("buffer promotion complete")
        except LockTimeout:
            log.info("promotion lock held elsewhere; skipping")
        except Exception:
            # reference semantics: promotion failures log and abandon the
            # round update (backend.py:236-238); the old round replays
            log.exception("promotion failed; old round will replay")
            metrics.inc("rounds.promote_failures", labels=self.metric_labels)

    async def _promote_from_reserve(self) -> bool:
        """Degraded promotion (runs under the promotion lock): pull the
        least-recently-played archived round that isn't the one on
        screen and make it current. Same rollback discipline as the
        normal promotion — the served (prompt, image) pair stays
        consistent or unchanged."""
        if self.reserve is None:
            return False
        prompt_prev = await self.store.hget(PROMPT_KEY, "current")
        picked = await self.reserve.pick(exclude=prompt_prev)
        if picked is None:
            return False
        text, prompt_state, image = picked
        image_prev = await self.store.hget(IMAGE_KEY, "current")
        try:
            await self.store.hset(PROMPT_KEY, "current", prompt_state)
            await self.store.hset(IMAGE_KEY, "current", image)
        except Exception:
            log.exception("reserve promotion write failed; rolling back")
            if prompt_prev is not None and image_prev is not None:
                await self.store.hset(PROMPT_KEY, "current", prompt_prev)
                await self.store.hset(IMAGE_KEY, "current", image_prev)
                await self._bump_image_version()
            raise
        await self._bump_image_version()
        # the reserve round becomes the story-so-far: when the backend
        # heals, the next episode continues from what players last saw
        await self.store.hset(PROMPT_KEY, "seed", text)
        metrics.inc("rounds.reserve_promotions", labels=self.metric_labels)
        flight_recorder.record("round.reserve_promotion")
        await self._notify_answers(prompt_state)
        log.warning("generation dark; promoted reserve round "
                    "(fresh-content degraded mode)")
        return True

    # -- clock ------------------------------------------------------------
    async def start_countdown(self) -> None:
        await self.store.setex(COUNTDOWN_KEY, self.time_per_prompt, "active")

    async def remaining(self) -> float:
        return max(0.0, await self.store.ttl(COUNTDOWN_KEY))

    async def reset_flag(self) -> bool:
        return await self.store.exists(RESET_KEY)

    async def rollover(self) -> None:
        """End-of-round sequence (server.py:166-170)."""
        await self.promote_buffer()
        if self.on_promote is not None:
            await self.on_promote()
        await self.start_countdown()
        await self.store.setex(RESET_KEY, 1.0, 1)

    async def global_timer(self, tick: float = 1.0) -> None:
        """1 Hz drive loop (server.py:152-172). Cancel the task to stop."""
        await self.start_countdown()
        buffer_trigger = self.time_per_prompt * self.buffer_at_fraction
        buffered_this_round = False
        while True:
            await asyncio.sleep(tick)
            try:
                remaining = await self.store.ttl(COUNTDOWN_KEY)
                metrics.gauge("round.remaining_s", remaining,
                              labels=self.metric_labels)
                if remaining <= 0:
                    # clear BEFORE rollover: if rollover partially fails
                    # (clock restarted, reset flag lost), the new round
                    # must still buffer rather than silently replay
                    buffered_this_round = False
                    await self.rollover()
                    continue
                if remaining <= buffer_trigger and not buffered_this_round:
                    buffered_this_round = True
                    # strong reference: the loop only weakly references
                    # tasks, and a GC'd task would vanish mid-generation
                    self._buffer_task = asyncio.ensure_future(
                        self.buffer_contents())
            except asyncio.CancelledError:
                raise
            except Exception:
                # the clock is the one task that must never die: a store
                # hiccup skips this tick and the next tick retries
                log.exception("timer tick failed; continuing")
                metrics.inc("rounds.timer_tick_failures",
                            labels=self.metric_labels)

    def start(self, tick: float = 1.0) -> asyncio.Task:
        self._timer_task = asyncio.ensure_future(self.global_timer(tick))
        return self._timer_task

    async def stop(self) -> None:
        for attr in ("_timer_task", "_buffer_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
                setattr(self, attr, None)
