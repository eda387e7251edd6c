"""Per-player session state.

Schema (kept from the reference, server.py:26-51, 78-94): one hash per
session id holding ``max`` (best mean score), ``won`` (0/1), ``attempts``,
and one field per mask index with that mask's best-known score; plus a
``sessions`` set for the live player count. Session hashes expire after one
round length (server.py:40) so abandoned sessions evaporate.

Fixed vs the reference: ``add_client`` checked membership of
the wrong key ('session' vs 'sessions', server.py:31) — here membership is
checked on the real set.
"""

from __future__ import annotations

from typing import Dict, List

from cassmantle_tpu_torch.engine.store import StateStore

SESSIONS_KEY = "sessions"


class SessionManager:
    def __init__(self, store: StateStore, min_score: float,
                 time_per_prompt: float) -> None:
        self.store = store
        self.min_score = min_score
        self.time_per_prompt = time_per_prompt

    async def init_client(self, session: str, masks: List[int]) -> None:
        await self.reset_client(session, masks)
        await self.store.sadd(SESSIONS_KEY, session)

    async def add_client(self, session: str) -> None:
        if session and not await self.store.sismember(SESSIONS_KEY, session):
            await self.store.sadd(SESSIONS_KEY, session)

    async def reset_client(self, session: str, masks: List[int]) -> None:
        contents: Dict[str, object] = {
            "max": self.min_score, "won": 0, "attempts": 0,
        }
        for m in masks:
            contents[str(m)] = 0.0
        await self.store.delete(session)
        await self.store.hset(session, mapping=contents)
        await self.store.expire(session, self.time_per_prompt)

    async def remove_connection(self, session: str) -> None:
        await self.store.srem(SESSIONS_KEY, session)

    async def player_count(self) -> int:
        return len(await self.store.smembers(SESSIONS_KEY))

    async def exists(self, session: str) -> bool:
        return bool(session) and await self.store.exists(session)

    async def increment_attempt(self, session: str) -> None:
        await self.store.hincrby(session, "attempts", 1)

    async def fetch_scores(self, session: str) -> Dict[str, str]:
        raw = await self.store.hgetall(session)
        return {k: v.decode() for k, v in raw.items()}

    async def set_scores(
        self, session: str, scores: Dict[str, float]
    ) -> Dict[str, object]:
        """Record a guess outcome; returns scores + ``won`` flag.

        Win rule kept from the reference (server.py:78-89): mean of this
        attempt's scores == 1.0, i.e. every mask answered exactly.
        """
        current = await self.fetch_scores(session)
        mean_score = sum(scores.values()) / max(1, len(scores))
        if mean_score > float(current.get("max", self.min_score)):
            await self.store.hset(session, "max", mean_score)
        for key, val in scores.items():
            prev = float(current.get(key, 0.0))
            await self.store.hset(session, key, max(prev, val))
        won = int(mean_score == 1.0)
        if won:
            await self.store.hset(session, "won", 1)
        out: Dict[str, object] = {k: str(v) for k, v in scores.items()}
        out["won"] = won if won else int(current.get("won", 0) or 0)
        return out

    async def reset_all(self, masks: List[int]) -> None:
        for session in await self.store.smembers(SESSIONS_KEY):
            await self.reset_client(session, masks)
