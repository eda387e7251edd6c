"""Host-memory int8 wordlist embedding table: the scoring ladder's rung 0.

A port of ``cassmantle_tpu/ops/embed_table.py`` (``:41-349``). The guess
vocabulary is finite (``data/wordlist.txt`` plus the round answers known
at promotion), so the scorer's embedding of all of it is computed once
and served from host memory: a guess whose words are all in the table
completes as one int8 dot product, with no device dispatch, no queue hop
and no admission check; other text keeps the full ladder (LRU, queue,
breaker, device).

Artifact format, byte for byte the reference's::

    magic  b"CMETB1\n"
    uint64 little-endian header length
    JSON header {version, signature, wordlist_digest, scorer_signature,
                 weights_fingerprint, dim, count, seq_len, words, ...}
    zero padding to a 64-byte boundary
    int8   rows   (count, dim)   symmetric per-row quantized embeddings
    f32    scales (count,)       absmax/127 per row
    f32    norms  (count,)       ||int8 row||_2

The signature digests the wordlist, the scorer config and the weights'
identity, so a table made from other weights never arms. The port builds
its own table from its own MiniLM at service start
(``ops/scorer.py::EmbeddingScorer.build_table``) and caches it in the
git-ignored ``cassmantle_tpu_torch/_build/``; the reference's committed
``data/embed_table.bin`` digests the JAX weights and is never armed or
written here.

Fidelity: lookup returns ``q / ||q||``, the unit vector of the
dequantized row, and ``score_pairs`` computes ``int32_dot(q_g, q_a) /
(||q_g||·||q_a||)``, exactly the cosine of the vectors lookup returns;
the only error against the fp32 scorer is quantization noise.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import threading
import unicodedata
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from cassmantle_tpu_torch.utils.logging import get_logger, metrics

log = get_logger("embed_table")

TABLE_VERSION = 1
_MAGIC = b"CMETB1\n"
_ALIGN = 64

# the port's table cache: git-ignored, beside the kernel builds
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def normalize_key(text: str) -> str:
    """Table lookup key: NFKC + casefold + strip (the engine lowercases
    and strips both sides of a scored pair, and the tokenizers lowercase,
    so texts sharing a key embed alike on the device path too)."""
    return unicodedata.normalize("NFKC", text).casefold().strip()


# -- signatures -------------------------------------------------------------

def wordlist_digest(words: Sequence[str]) -> str:
    h = hashlib.sha256()
    for w in words:
        h.update(w.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()[:16]


def _digest(*parts) -> str:
    """``cassmantle_tpu/obs/costmodel.py::_digest``."""
    return hashlib.sha256("|".join(repr(p) for p in parts)
                          .encode()).hexdigest()[:16]


def scorer_signature(mcfg, seq_len: int) -> str:
    """``cassmantle_tpu/obs/costmodel.py::scorer_signature``."""
    return _digest("scorer", mcfg, seq_len)


def weights_fingerprint(state_dict, tokenizer: str = "") -> str:
    """Identity of what the rows come from: sha256 of the served
    encoder's state dict (its tensors sorted by name, in fp32) and of
    ``tokenizer`` (``utils/tokenizers.py::tokenizer_identity``: its class
    and a digest of its vocabulary file), so a change of the weights, of
    the init that drew them, of the model's code or of the tokenizer's
    ids gives another signature."""
    h = hashlib.sha256()
    h.update(tokenizer.encode("utf-8"))
    for name in sorted(state_dict):
        t = state_dict[name]
        h.update(name.encode("utf-8"))
        h.update(np.ascontiguousarray(
            t.detach().cpu().float().numpy()
            if hasattr(t, "detach") else np.asarray(t)).tobytes())
    return "sha256:" + h.hexdigest()[:16]


def cache_path(signature: str) -> str:
    """Where the port caches the table of ``signature``."""
    return os.path.join(CACHE_DIR, f"embed_table-{signature}.bin")


def table_signature(mcfg, seq_len: int, words: Sequence[str],
                    weights_fp: str) -> str:
    """One digest binding everything the rows depend on — same
    discipline as data/cost_model.json entries: artifact and runtime
    derive the signature from the same definition, or the match
    silently never fires and the device path serves everything."""
    return _digest("embed_table", TABLE_VERSION, wordlist_digest(words),
                   scorer_signature(mcfg, seq_len), weights_fp)


# -- quantization -----------------------------------------------------------

def quantize_rows(emb: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fp32 rows -> (int8 rows, per-row scales, int8-row L2 norms).

    Symmetric per-row absmax quantization. Norms are ||q||_2 of the
    INT8 rows: lookup and the fused dot both divide by them, making the
    two rungs produce identical cosines by construction."""
    emb = np.asarray(emb, dtype=np.float32)
    absmax = np.max(np.abs(emb), axis=1)
    scales = (np.maximum(absmax, 1e-8) / 127.0).astype(np.float32)
    q = np.clip(np.rint(emb / scales[:, None]), -127, 127).astype(np.int8)
    norms = np.sqrt(
        np.sum(q.astype(np.float32) ** 2, axis=1)).astype(np.float32)
    # an all-zero fp row quantizes to all-zero int8; keep its norm
    # divisor finite (the unit vector is then the zero vector)
    norms = np.maximum(norms, 1e-8).astype(np.float32)
    return q, scales, norms


# -- artifact I/O -----------------------------------------------------------

def _pad_to(n: int, align: int = _ALIGN) -> int:
    return (align - n % align) % align


def write_table(path: str, words: Sequence[str], emb: np.ndarray,
                mcfg, seq_len: int, weights_fp: str,
                generated_by: str = "cassmantle_tpu_torch/ops/scorer.py"
                ) -> Dict:
    """Quantize ``emb`` (len(words), dim) and write the artifact.
    Returns the header dict (with the stamped signature)."""
    words = [normalize_key(w) for w in words]
    if len(set(words)) != len(words):
        raise ValueError("wordlist collapses under normalize_key; "
                         "dedupe before emitting")
    q, scales, norms = quantize_rows(emb)
    header = {
        "version": TABLE_VERSION,
        "signature": table_signature(mcfg, seq_len, words, weights_fp),
        "wordlist_digest": wordlist_digest(words),
        "scorer_signature": scorer_signature(mcfg, seq_len),
        "weights_fingerprint": weights_fp,
        "dim": int(q.shape[1]),
        "count": int(q.shape[0]),
        "seq_len": int(seq_len),
        "generated_by": generated_by,
        "words": list(words),
    }
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<Q", len(blob)))
    buf.write(blob)
    buf.write(b"\0" * _pad_to(buf.tell()))
    buf.write(q.tobytes(order="C"))
    buf.write(scales.astype(np.float32).tobytes())
    buf.write(norms.astype(np.float32).tobytes())
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return header


def _read_header_raw(path: str) -> Tuple[Dict, int]:
    """(header dict, byte offset of the int8 row data)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an embed table (bad magic)")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
    if header.get("version") != TABLE_VERSION:
        raise ValueError(
            f"{path}: table version {header.get('version')} != "
            f"{TABLE_VERSION}")
    data_off = len(_MAGIC) + 8 + hlen
    return header, data_off + _pad_to(data_off)


def read_header(path: str) -> Dict:
    """Cheap header-only read (no row data touched)."""
    return _read_header_raw(path)[0]


# -- the table --------------------------------------------------------------

class EmbedTable:
    """Memory-mapped int8 embedding table + runtime answer-pin overlay.

    Lookups and pins are served under a short-hold leaf lock: dict/array
    reads only — quantization of
    a pinned row happens outside it, and no other lock is ever taken
    while holding it."""

    def __init__(self, words: Sequence[str], rows: np.ndarray,
                 norms: np.ndarray, header: Optional[Dict] = None) -> None:
        self._index: Dict[str, int] = {
            w: i for i, w in enumerate(words)}
        self._rows = rows            # (count, dim) int8 (mmap or array)
        self._norms = norms          # (count,) f32
        self.header = header or {}
        self.dim = int(rows.shape[1])
        self.signature = self.header.get("signature", "")
        # runtime overlay: round answers pinned at promotion time,
        # quantized with the SAME scheme so pinned words score through
        # the identical int8 math as committed rows
        self._pins: Dict[str, Tuple[np.ndarray, np.float32]] = {}
        self._lock = threading.Lock()

    # -- constructors --------------------------------------------------

    @classmethod
    def load(cls, path: str,
             expected_signature: Optional[str] = None
             ) -> Optional["EmbedTable"]:
        """mmap the committed artifact; None (never raise) when the file
        is absent, malformed, or — the drift case — its signature does
        not match ``expected_signature``. A stale table must never arm:
        serving wrong-embedding scores silently is worse than paying
        the device path."""
        try:
            header, data_off = _read_header_raw(path)
        except (OSError, ValueError) as exc:
            log.info("embed table not armed (%s)", exc)
            return None
        if expected_signature is not None and \
                header["signature"] != expected_signature:
            log.warning(
                "embed table signature mismatch (committed %s != "
                "expected %s); not arming",
                header["signature"], expected_signature)
            return None
        count, dim = header["count"], header["dim"]
        rows = np.memmap(path, dtype=np.int8, mode="r",
                         offset=data_off, shape=(count, dim))
        norms_off = data_off + count * dim + count * 4  # skip scales
        norms = np.array(np.memmap(path, dtype=np.float32, mode="r",
                                   offset=norms_off, shape=(count,)))
        return cls(header["words"], rows, norms, header=header)

    @classmethod
    def from_embeddings(cls, words: Sequence[str], emb: np.ndarray,
                        signature: str = "") -> "EmbedTable":
        """In-memory table from fp32 rows."""
        keys = [normalize_key(w) for w in words]
        q, _scales, norms = quantize_rows(emb)
        return cls(keys, q, norms, header={"signature": signature})

    # -- reads ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._index) + len(self._pins)

    def _get(self, key: str) -> Optional[Tuple[np.ndarray, np.float32]]:
        with self._lock:
            i = self._index.get(key)
            if i is not None:
                return self._rows[i], self._norms[i]
            return self._pins.get(key)

    def contains(self, text: str) -> bool:
        return self._get(normalize_key(text)) is not None

    def lookup(self, text: str) -> Optional[np.ndarray]:
        """word -> fresh (dim,) f32 UNIT embedding, or None when OOV.
        The unit vector of the dequantized row: the per-row scale
        cancels, so only q and its precomputed norm are needed."""
        hit = self._get(normalize_key(text))
        if hit is None:
            return None
        q, norm = hit
        return q.astype(np.float32) / np.float32(norm)

    def score_pairs(self, pairs: Sequence[Tuple[str, str]]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused int8-dot scoring: [(guess, answer)] ->
        (scores f32 (n,), served bool (n,)). A pair is served only when
        BOTH sides are in the table; unserved pairs score 0 here and
        keep the full ladder. ``scorer.table_hits`` counts texts served
        (2 per served pair), mirroring ``scorer.texts`` units."""
        n = len(pairs)
        scores = np.zeros((n,), dtype=np.float32)
        served = np.zeros((n,), dtype=bool)
        hits = 0
        for i, (g, a) in enumerate(pairs):
            gq = self._get(normalize_key(g))
            if gq is None:
                continue
            aq = self._get(normalize_key(a))
            if aq is None:
                continue
            # int32 accumulate: dim<=1024 rows of |q|<=127 can't overflow
            dot = np.dot(gq[0].astype(np.int32), aq[0].astype(np.int32))
            scores[i] = np.float32(dot) / (np.float32(gq[1])
                                           * np.float32(aq[1]))
            served[i] = True
            hits += 2
        if hits:
            metrics.inc("scorer.table_hits", hits)
        return scores, served

    # -- runtime pins --------------------------------------------------

    def pin(self, word: str, emb: np.ndarray) -> None:
        """Overlay a round answer at promotion time: quantize the fp32
        embedding with the committed scheme and serve it from the same
        int8 math. Pins accumulate for the process lifetime (a handful
        of words per round — bounded by round cadence, not traffic)."""
        key = normalize_key(word)
        if not key:
            return
        q, _scales, norms = quantize_rows(
            np.asarray(emb, dtype=np.float32)[None, :])
        row, norm = q[0], norms[0]
        with self._lock:
            if key in self._index:
                return
            self._pins[key] = (row, np.float32(norm))
        metrics.inc("scorer.table_pins", 1)
