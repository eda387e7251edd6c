"""Store-backed round reserve: fresh puzzles while the device path is dark.

A copy of ``cassmantle_tpu/engine/reserve.py``. Every successfully
generated round is archived into a capped ring in the state store, and
when the content breaker is open the round manager promotes the
least-recently-played archived round instead of replaying the current
one.

Each slot's (text, prompt state, image) is ONE pickled hash field, so a
slot is written atomically per the store contract; a small prompt-only
index hash keeps slot selection cheap, and the blob's own prompt is
authoritative at pickup. The reserve holds no thread locks of its own:
``archive`` runs under the buffer/startup store locks and ``pick`` under
the promotion store lock, and every slot write is one store command.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

from cassmantle_tpu_torch.engine.store import StateStore
from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("reserve")

ROUNDS_KEY = "reserve:rounds"    # slot -> pickle((text, prompt_json, jpeg))
INDEX_KEY = "reserve:prompt"     # slot -> prompt_json (selection only)
META_KEY = "reserve:meta"        # counters + per-slot seq/played stamps


def _field(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


class RoundReserve:
    """Capped ring of archived rounds with least-recently-played pickup.

    ``archive`` runs on every successful generation; ``pick`` runs under
    the promotion lock when the buffer is empty. Play stamps are set at
    archive time too (an archived round is about to be the live round),
    so the rotation orders by least-recently-*on-screen*, not merely
    least-recently-picked-from-reserve.
    """

    def __init__(self, store: StateStore, capacity: int = 8) -> None:
        assert capacity > 0, "reserve capacity must be positive"
        self.store = store
        self.capacity = capacity

    @staticmethod
    def _digest(text: str) -> str:
        import hashlib

        return hashlib.md5(text.encode()).hexdigest()

    async def archive(self, text: str, prompt_state_json: str,
                      image_bytes: bytes) -> None:
        """Append one generated round; overwrites the oldest past capacity.
        Consecutive duplicates (a restarted story landing on the same seed)
        are skipped, and re-archiving a text the ring already holds
        REFRESHES that slot in place (idempotent archive): a
        generation retried after a mid-flight worker death must not
        consume a second ring slot for the same puzzle."""
        archived = int(await self.store.hget(META_KEY, "archived") or 0)
        if archived > 0:
            last_slot = str((archived - 1) % self.capacity)
            last = await self.store.hget(ROUNDS_KEY, last_slot)
            if last is not None and pickle.loads(last)[0] == text:
                return
        held = await self.store.hget(META_KEY,
                                     f"slot_of:{self._digest(text)}")
        if held is not None:
            slot = held.decode()
            blob = await self.store.hget(ROUNDS_KEY, slot)
            # the blob is authoritative (the slot_of entry can go stale
            # when ring wraparound evicted the text): refresh in place
            # only when the slot still holds THIS text
            if blob is not None and pickle.loads(blob)[0] == text:
                await self.store.hset(
                    ROUNDS_KEY, slot,
                    pickle.dumps((text, prompt_state_json, image_bytes)))
                await self.store.hset(INDEX_KEY, slot, prompt_state_json)
                metrics.inc("reserve.refreshed")
                return
        seq = await self.store.hincrby(META_KEY, "archived", 1)
        slot = str((seq - 1) % self.capacity)
        # ring wraparound evicts whatever the slot held: drop the
        # evicted text's slot_of entry so the digest index stays
        # bounded by capacity instead of growing per unique text
        old_blob = await self.store.hget(ROUNDS_KEY, slot)
        if old_blob is not None:
            old_text = pickle.loads(old_blob)[0]
            await self.store.hdel(META_KEY,
                                  f"slot_of:{self._digest(old_text)}")
        # the payload is one atomic field; the index is written after, so
        # a crash between the two leaves a stale index entry at worst —
        # pick() re-verifies against the blob before serving
        await self.store.hset(
            ROUNDS_KEY, slot,
            pickle.dumps((text, prompt_state_json, image_bytes)))
        await self.store.hset(INDEX_KEY, slot, prompt_state_json)
        await self.store.hset(META_KEY, f"seq:{slot}", seq)
        await self.store.hset(META_KEY, f"slot_of:{self._digest(text)}",
                              slot)
        # archived == about to be played: stamp now so degraded pickup
        # starts from the round the players saw longest ago
        stamp = await self.store.hincrby(META_KEY, "plays", 1)
        await self.store.hset(META_KEY, f"played:{slot}", stamp)
        metrics.inc("reserve.archived")
        metrics.gauge("reserve.size", await self.size())
        flight_recorder.record("reserve.archived", slot=slot)

    async def size(self) -> int:
        return len(await self.store.hgetall(ROUNDS_KEY))

    async def pick(self, exclude: Optional[bytes] = None,
                   ) -> Optional[Tuple[str, bytes, bytes]]:
        """Least-recently-played (text, prompt_state_json, image) — or
        None if the reserve is empty / only holds the excluded round.
        ``exclude`` is the current round's prompt-state bytes, so degraded
        promotion never re-serves the puzzle already on screen."""
        index = {_field(k): v
                 for k, v in (await self.store.hgetall(INDEX_KEY)).items()}
        meta = {_field(k): v
                for k, v in (await self.store.hgetall(META_KEY)).items()}
        candidates = [
            (int(meta.get(f"played:{slot}", b"0") or 0), slot)
            for slot, prompt_json in index.items()
            if exclude is None or prompt_json != exclude
        ]
        candidates.sort()
        for _, slot in candidates:
            blob = await self.store.hget(ROUNDS_KEY, slot)
            if blob is None:
                continue
            text, prompt_json, image = pickle.loads(blob)
            prompt_bytes = prompt_json.encode() \
                if isinstance(prompt_json, str) else prompt_json
            # the blob is authoritative: a stale index entry (crash
            # between blob and index writes) must not sneak the
            # on-screen round back in
            if exclude is not None and prompt_bytes == exclude:
                continue
            stamp = await self.store.hincrby(META_KEY, "plays", 1)
            await self.store.hset(META_KEY, f"played:{slot}", stamp)
            metrics.inc("reserve.picks")
            flight_recorder.record("reserve.picked", slot=slot)
            return text, prompt_bytes, image
        return None
