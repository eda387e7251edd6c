"""Training data: token packing and a background prefetch loader.

Port of ``cassmantle_tpu/utils/data.py``:

- :func:`pack_tokens`: documents -> fixed-length rows. Each document is
  tokenized and the documents are joined with EOS separators into one
  stream, reshaped to (rows, seq_len); a ``loss_mask`` marks the real
  tokens (all but the EOS pad at the tail of the last row).
- :func:`batches_from`: packed rows -> host batch dicts, reshuffled each
  epoch, the trailing partial batch dropped.
- :class:`PrefetchLoader`: a daemon thread runs ``place`` (a trainer's
  ``place_batch``: the host-to-device copy) on the next batch while the
  current step runs; a bounded queue gives backpressure. An error on the
  thread is raised on the consumer's ``next``; exhaustion is sticky.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np


def pack_tokens(
    texts: Sequence[str],
    encode: Callable[[str], Sequence[int]],
    seq_len: int,
    eos_id: int,
) -> Dict[str, np.ndarray]:
    """Documents -> ``{"input_ids": (N, seq_len) int32, "loss_mask": (N,
    seq_len) int32}``: the stream ``doc0 EOS doc1 EOS ...`` padded with EOS
    to a row boundary, the mask 0 only on that pad."""
    stream: list = []
    for text in texts:
        stream.extend(int(t) for t in encode(text))
        stream.append(eos_id)
    if not stream:
        return {
            "input_ids": np.zeros((0, seq_len), np.int32),
            "loss_mask": np.zeros((0, seq_len), np.int32),
        }
    n_rows = (len(stream) + seq_len - 1) // seq_len
    pad = n_rows * seq_len - len(stream)
    ids = np.asarray(stream + [eos_id] * pad, dtype=np.int32)
    mask = np.concatenate([np.ones(len(stream), dtype=np.int32),
                           np.zeros(pad, dtype=np.int32)])
    return {
        "input_ids": ids.reshape(n_rows, seq_len),
        "loss_mask": mask.reshape(n_rows, seq_len),
    }


def batches_from(
    packed: Dict[str, np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Packed rows -> host batch dicts; ``epochs=None`` streams forever.
    Raises ValueError when the corpus packs to fewer rows than one batch."""
    n = packed["input_ids"].shape[0]
    if n < batch_size:
        raise ValueError(
            f"corpus packs to {n} rows < batch_size {batch_size}; "
            "no batch can ever be yielded")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            sel = order[start:start + batch_size]
            yield {k: v[sel] for k, v in packed.items()}
        epoch += 1


class PrefetchLoader:
    """Iterate ``batches`` with ``place`` applied on a prefetch thread,
    at most ``depth`` batches ahead."""

    _DONE = object()

    def __init__(
        self,
        batches: Iterable[Dict[str, np.ndarray]],
        place: Optional[Callable] = None,
        depth: int = 2,
    ) -> None:
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._place = place or (lambda b: b)
        self._err: Optional[BaseException] = None
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._run, args=(iter(batches),), daemon=True,
            name="data-prefetch")
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            for batch in it:
                self._queue.put(self._place(batch))
        except BaseException as exc:  # raised again on the consumer
            self._err = exc
        finally:
            self._queue.put(self._DONE)

    def __iter__(self) -> "PrefetchLoader":
        return self

    def __next__(self):
        if self._exhausted:
            # the sentinel is consumed once; a second next() would block
            # on the empty queue
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self._exhausted = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
