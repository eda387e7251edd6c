"""Batched embedding similarity scorer: the scoring ladder.

Port of ``cassmantle_tpu/ops/scorer.py::EmbeddingScorer`` (``:58-335``).
:meth:`EmbeddingScorer.embed` climbs the ladder: rung 0, the int8
wordlist table (``ops/embed_table.py``, ``scorer.table_hits`` /
``scorer.table_oov``); then the host LRU of unit embeddings; then the
device: guesses and answers tokenize on the host, pad into one of a few
fixed (batch, seq) buckets and embed in one MiniLM forward per bucket
chunk, with the per-row integrity verdict (``finite_verdict``) computed
on the device beside it and read back with the rows. A row the verdict
rejects comes back NaN and never enters the LRU.

The port makes its own table: :meth:`EmbeddingScorer.build_table`
embeds the game's wordlist (``data/wordlist.txt`` with the seeds' and
styles' words) through this scorer's encoder on its device in buckets of
2,048, quantizes it with the reference's scheme and caches it in the
git-ignored ``cassmantle_tpu_torch/_build/`` under its signature, which
binds the encoder's weights and its tokenizer's vocabulary.

From a weights directory (``weights_dir``) the encoder loads
``minilm.safetensors`` and the tokenizer ``minilm_vocab.txt``, as the
reference's scorer does; without them, the seeded init and the byte
tokenizer.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from functools import partial
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cassmantle_tpu_torch.chaos import fault_point
from cassmantle_tpu_torch.config import MiniLMConfig
from cassmantle_tpu_torch.models.layers import init_weights
from cassmantle_tpu_torch.models.minilm import MiniLMEncoder
from cassmantle_tpu_torch.models.weights import (
    Rebuilds,
    add_model,
    convert_minilm,
    fill_,
)
from cassmantle_tpu_torch.obs import costmodel
from cassmantle_tpu_torch.ops import embed_table as et
from cassmantle_tpu_torch.serving import integrity
from cassmantle_tpu_torch.utils.device import DeviceLike, resolve_device
from cassmantle_tpu_torch.utils.logging import get_logger, metrics
from cassmantle_tpu_torch.utils.profiling import block_timer
from cassmantle_tpu_torch.server.assets import load_wordlist
from cassmantle_tpu_torch.utils.tokenizers import (
    load_tokenizer,
    tokenizer_identity,
)

log = get_logger("scorer")

# Seed offset of the scorer's random init (the reference's init slot).
INIT_SEED = 7
# Rows per device forward when building the table.
TABLE_BUCKET = 2048
CHECKPOINT = "minilm.safetensors"


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class EmbeddingScorer:
    """Owns the encoder, its tokenizer, the batch buckets, the LRU and the
    int8 table (``table``: an :class:`~.embed_table.EmbedTable`, or None
    for none; the service passes the one :meth:`build_table` makes)."""

    def __init__(self, cfg: MiniLMConfig, device: DeviceLike = "cuda",
                 seq_len: int = 16,
                 batch_buckets: Sequence[int] = (8, 64, 256, 1024),
                 state_dict: Optional[Mapping] = None, seed: int = 0,
                 embed_cache_size: int = 2048,
                 table: Optional[et.EmbedTable] = None,
                 weights_dir: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seq_len = min(seq_len, cfg.max_positions)
        self.batch_buckets = tuple(batch_buckets)
        self.tokenizer = load_tokenizer("minilm", cfg.vocab_size,
                                        weights_dir)
        # text -> unit embedding; a short-hold leaf lock (dict updates
        # only: the device encode runs outside it)
        self._embed_cache: OrderedDict = OrderedDict()
        self._embed_cache_size = embed_cache_size
        self._embed_cache_lock = threading.Lock()

        def encoder(weights: Optional[Mapping]) -> MiniLMEncoder:
            with torch.device(self.device):
                model = MiniLMEncoder(cfg)
            if weights is not None:
                fill_(model, weights)
            else:
                gen = torch.Generator(self.device).manual_seed(
                    seed + INIT_SEED)
                init_weights(model, gen)
            return model.eval()

        def convert(tensors):
            return convert_minilm(tensors, cfg.num_layers)

        self._rebuilds = Rebuilds()
        self.model, self.loaded_real_weights = add_model(
            self._rebuilds, encoder, "minilm", weights_dir, CHECKPOINT,
            convert, state_dict)
        # the table's rows depend on the weights and on the tokenizer's ids
        self.weights_fp = et.weights_fingerprint(
            self.model.state_dict(), tokenizer_identity(self.tokenizer))
        self.table: Optional[et.EmbedTable] = None
        self.arm_table(table)

    # -- the table -------------------------------------------------------
    def arm_table(self, table: Optional[et.EmbedTable]) -> None:
        """Serve rung 0 from ``table`` (None: no rung 0)."""
        if table is not None and table.dim != self.cfg.hidden_size:
            raise ValueError(f"embed table dim {table.dim} != scorer "
                             f"hidden size {self.cfg.hidden_size}")
        self.table = table
        if table is not None:
            metrics.gauge("scorer.table_rows", len(table))

    def table_signature(self, words: Sequence[str]) -> str:
        return et.table_signature(self.cfg, self.seq_len,
                                  [et.normalize_key(w) for w in words],
                                  self.weights_fp)

    def build_table(self, words: Optional[Sequence[str]] = None,
                    path: Optional[str] = None) -> Tuple[et.EmbedTable,
                                                         dict]:
        """The int8 table of ``words`` (default: the game's wordlist) made
        with this scorer's encoder, loaded from ``path`` (default: the
        cache file of its signature) when that holds it, else embedded on
        this scorer's device in buckets of 2,048 rows, written there and
        loaded. Returns (table, stats: seconds, bytes, rows, built)."""
        t0 = time.perf_counter()
        words = list(dict.fromkeys(
            et.normalize_key(w) for w in (words or load_wordlist())))
        sig = self.table_signature(words)
        path = path or et.cache_path(sig)
        table = et.EmbedTable.load(path, expected_signature=sig)
        built = table is None
        if built:
            rows = [self._embed_device(words[i:i + TABLE_BUCKET],
                                       TABLE_BUCKET)[0]
                    for i in range(0, len(words), TABLE_BUCKET)]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            et.write_table(path, words, np.concatenate(rows), self.cfg,
                           self.seq_len, self.weights_fp)
            table = et.EmbedTable.load(path, expected_signature=sig)
        return table, {"seconds": time.perf_counter() - t0,
                       "bytes": os.path.getsize(path), "rows": len(words),
                       "built": built}

    def clear_embed_cache(self) -> None:
        """Forget every cached embedding: the next :meth:`embed` of any
        text runs on the device."""
        with self._embed_cache_lock:
            self._embed_cache.clear()

    # -- device-loss rebuild ----------------------------------------------
    def reload_params(self) -> None:
        """Device-loss rebuild: the encoder's recipe runs again into its
        parameters in place. The LRU and the table hold host arrays
        addressed by text, so neither needs invalidating."""
        self._rebuilds.reload()

    # -- host-side batching ----------------------------------------------
    def _tokenize_batch(self, texts: Sequence[str], batch: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((batch, self.seq_len), self.tokenizer.pad_id,
                      dtype=np.int64)
        mask = np.zeros((batch, self.seq_len), dtype=np.int64)
        for i, text in enumerate(texts):
            toks = self.tokenizer.encode(text)[: self.seq_len]
            if not toks:
                toks = [self.tokenizer.pad_id]
            ids[i, : len(toks)] = np.asarray(toks) % self.cfg.vocab_size
            mask[i, : len(toks)] = 1
        return ids, mask

    def row_products(self) -> costmodel.Products:
        """One encoded row's products at ``seq_len`` tokens, walked on the
        encoder's meta twin."""
        twin = costmodel.meta_module(partial(MiniLMEncoder, self.cfg))

        def walk(counter) -> None:
            ids = torch.zeros((1, self.seq_len), dtype=torch.long,
                              device="meta")
            twin(ids, torch.ones_like(ids))

        return costmodel.count_products(walk)

    @classmethod
    def shape_twin(cls, cfg: MiniLMConfig, seq_len: int = 16
                   ) -> "EmbeddingScorer":
        """A scorer of ``cfg`` with no encoder: :meth:`row_products`
        without building it."""
        twin = cls.__new__(cls)
        twin.cfg = cfg
        twin.seq_len = min(seq_len, cfg.max_positions)
        return twin

    def cost_entries(self) -> List[tuple]:
        """(kind, signature, counter) of one encoded row."""
        return [("scorer", costmodel.scorer_signature(self.cfg,
                                                      self.seq_len),
                 self.row_products)]

    def _row_flops(self) -> Optional[costmodel.Products]:
        return costmodel.dispatch_count(*self.cost_entries()[0])

    def _embed_device(self, texts: Sequence[str],
                      batch: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The uncached device path: (n,) texts -> ((n, D) unit
        embeddings, (n,) validity), one encode per bucket chunk. Validity
        is the device verdict with the copied rows' own finiteness (all
        True under the integrity kill switch)."""
        n = len(texts)
        batch = batch or pick_bucket(n, self.batch_buckets)
        out_chunks, ok_chunks = [], []
        for start in range(0, n, batch):
            chunk = texts[start:start + batch]
            ids, mask = self._tokenize_batch(chunk, batch)
            # the stage span of a guess batch's encode, ended when the rows
            # are on the host; its products cover the padded batch (the
            # device computes the pad rows too)
            row = self._row_flops()
            with block_timer("scorer.encode_s",
                             flops_est=(row.scaled(batch) if row is not None
                                        else None),
                             pipeline="scorer"), torch.inference_mode():
                fault_point("device.lost", peer="scorer")
                emb = self.model(torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))
                # the verdict rides the rows' copy: one host read a dispatch
                both = torch.cat([emb.float(), integrity.finite_verdict(
                    emb)[:, None].float()], dim=1).cpu().numpy()
            emb, verdict = both[:, :-1], both[:, -1] > 0.5
            metrics.inc("scorer.dispatches")
            rows = integrity.poison(emb[: len(chunk)], peer="scorer")
            out_chunks.append(rows)
            if integrity.integrity_disabled():
                ok_chunks.append(np.ones(len(chunk), dtype=bool))
            else:
                ok_chunks.append(verdict[: len(chunk)]
                                 & np.isfinite(rows).all(axis=-1))
        return np.concatenate(out_chunks), np.concatenate(ok_chunks)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(n,) texts -> (n, D) unit embeddings, fp32 host array, through
        the ladder: int8 table, LRU, device. Only the unique texts that
        missed both reach the device; ``scorer.embed_cache_misses``
        counts them, ``scorer.embed_cache_hits`` the LRU's rows. Rows the
        integrity verdict rejects are NaN (and not cached)."""
        n = len(texts)
        if n == 0:
            return np.zeros((0, self.cfg.hidden_size), dtype=np.float32)
        out = np.zeros((n, self.cfg.hidden_size), dtype=np.float32)
        table = self.table if not et.embed_table_disabled() else None
        if table is not None:
            rest: List[int] = []
            for i, text in enumerate(texts):
                row = table.lookup(text)
                if row is None:
                    rest.append(i)
                else:
                    out[i] = row
            metrics.inc("scorer.table_hits", n - len(rest))
            metrics.inc("scorer.table_oov", len(rest))
        else:
            rest = list(range(n))
        miss_rows: "OrderedDict[str, list]" = OrderedDict()
        with self._embed_cache_lock:
            for i in rest:
                emb = self._embed_cache.get(texts[i])
                if emb is not None:
                    self._embed_cache.move_to_end(texts[i])
                    out[i] = emb
                else:
                    miss_rows.setdefault(texts[i], []).append(i)
        if miss_rows:
            fresh, ok = self._embed_device(list(miss_rows))
            bad_members: List[int] = []
            with self._embed_cache_lock:
                for row, valid, (text, idxs) in zip(fresh, ok,
                                                    miss_rows.items()):
                    if not valid:
                        out[idxs] = np.nan
                        bad_members.extend(idxs)
                        continue
                    out[idxs] = row
                    if self._embed_cache_size > 0:
                        self._embed_cache[text] = row.copy()
                        self._embed_cache.move_to_end(text)
                        while len(self._embed_cache) > \
                                self._embed_cache_size:
                            self._embed_cache.popitem(last=False)
            if bad_members:
                integrity.note_invalid("scorer", "encode",
                                       sorted(bad_members))
        metrics.inc("scorer.texts", n)
        metrics.inc("scorer.embed_cache_misses", len(miss_rows))
        metrics.inc("scorer.embed_cache_hits", len(rest) - len(miss_rows))
        return out

    def similarity(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """[(guess, answer)] -> cosine similarity per pair, one device
        batch for all guesses and answers that missed the table and LRU."""
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        texts = [g for g, _ in pairs] + [a for _, a in pairs]
        emb = self.embed(texts)
        n = len(pairs)
        return np.sum(emb[:n] * emb[n:], axis=-1)

    def table_scores(self, pairs: Sequence[Tuple[str, str]]):
        """Rung 0 for the service: [(guess, answer)] -> (scores, served)
        through the int8 table, or None with no table. Pairs ``served``
        completed with no device dispatch. None too under
        CASSMANTLE_NO_EMBED_TABLE."""
        if self.table is None or et.embed_table_disabled():
            return None
        return self.table.score_pairs(list(pairs))

    def pin_answers(self, words: Sequence[str]) -> int:
        """Pin round answers missing from the table: embedded once through
        the LRU and device rungs, quantized with the table's scheme and
        overlaid. Returns the rows pinned (``scorer.table_pins``); none
        under CASSMANTLE_NO_EMBED_TABLE."""
        if self.table is None or et.embed_table_disabled():
            return 0
        todo: List[str] = []
        for w in words:
            key = et.normalize_key(w)
            if key and key not in todo and not self.table.contains(key):
                todo.append(key)
        if not todo:
            return 0
        for w, row in zip(todo, self.embed(todo)):
            self.table.pin(w, row)
        return len(todo)
