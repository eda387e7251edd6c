"""The scoring ladder of the port against the reference, on the CPU at
``test_config()``'s MiniLM: the int8 wordlist table (artifact bytes,
quantization, lookups, fused scores, pins) and ``EmbeddingScorer``'s
three rungs (table, host LRU, device) with the reference's encoder tree
carried by ``from_jax``, each within 1e-5 of the reference's scores.
The port's own table build (its encoder over a word list, cached under
its signature) is held to the reference's fidelity bar: int8 cosines
within 1e-2 of the fp32 ones.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cassmantle_tpu.config import test_config as jax_test_config
from cassmantle_tpu.models.minilm import MiniLMEncoder as JMiniLM
from cassmantle_tpu.ops import embed_table as jet
from cassmantle_tpu.ops.scorer import EmbeddingScorer as JScorer
from cassmantle_tpu_torch.config import test_config as port_test_config
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import embed_table as pet
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.utils.logging import metrics
from cassmantle_tpu_torch.utils.text import load_wordlist

from _torch_port_common import jax_params

WORDS = ["lighthouse", "comet", "harbor", "orchard", "Caravan", "teal",
         "amber", "glacier", "canyon", "violet", "archive", "silver"]
OOV = ["a quiet harbor", "zqxv", "an orchard at dusk", "crimson tide"]
ATOL = 1e-5


@pytest.fixture(scope="module")
def scorers():
    """(reference, port) scorers on one seeded MiniLM tree, no table."""
    jm = jax_test_config().models.minilm
    ref = JScorer(jm, batch_buckets=(8, 64), table=None)
    ids = jnp.zeros((1, ref.seq_len), jnp.int32)
    ref.params = jax_params(JMiniLM(jm), 41, ids, ids)
    port = EmbeddingScorer(port_test_config().models.minilm, "cpu",
                           batch_buckets=(8, 64),
                           state_dict=from_jax("minilm", ref.params))
    return ref, port


def _rows(n=12, dim=64, seed=42):
    rows = np.random.default_rng(seed).standard_normal(
        (n, dim)).astype(np.float32)
    rows[3] = 0.0                      # an all-zero row keeps a finite norm
    return rows


def test_quantize_rows_matches_reference():
    rows = _rows()
    for got, want in zip(pet.quantize_rows(rows), jet.quantize_rows(rows)):
        np.testing.assert_array_equal(got, want)


def test_write_table_bytes_equal_and_each_loads_the_other(tmp_path):
    """Each package's ``write_table`` on the same fp32 rows writes the same
    bytes; each package loads the other's file with the same lookups and
    fused scores."""
    mcfg = port_test_config().models.minilm
    rows = _rows()
    paths = {}
    for name, mod, cfg in (("ref", jet, jax_test_config().models.minilm),
                           ("port", pet, mcfg)):
        paths[name] = str(tmp_path / f"{name}.bin")
        header = mod.write_table(paths[name], WORDS, rows, cfg, 16,
                                 "sha256:0123456789abcdef",
                                 generated_by="test")
        assert header["count"] == len(WORDS) and header["dim"] == 64
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    sig = pet.read_header(paths["ref"])["signature"]
    assert sig == jet.read_header(paths["port"])["signature"]
    assert sig == pet.table_signature(
        mcfg, 16, [pet.normalize_key(w) for w in WORDS],
        "sha256:0123456789abcdef")
    pairs = [(WORDS[i], WORDS[(i + 5) % len(WORDS)])
             for i in range(len(WORDS))] + [("zqxv", "comet")]
    port_reads_ref = pet.EmbedTable.load(paths["ref"],
                                         expected_signature=sig)
    ref_reads_port = jet.EmbedTable.load(paths["port"],
                                         expected_signature=sig)
    for w in WORDS + ["ZQXV", " Lighthouse "]:
        a, b = port_reads_ref.lookup(w), ref_reads_port.lookup(w)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for got, want in zip(port_reads_ref.score_pairs(pairs),
                         ref_reads_port.score_pairs(pairs)):
        np.testing.assert_array_equal(got, want)
    assert pet.EmbedTable.load(paths["ref"],
                               expected_signature="stale") is None


def test_table_pins_match_reference():
    rows = _rows()
    tables = [mod.EmbedTable.from_embeddings(WORDS, rows)
              for mod in (jet, pet)]
    pin = np.random.default_rng(43).standard_normal(64).astype(np.float32)
    for t in tables:
        t.pin("crimson", pin)
        t.pin("Lighthouse", pin)            # already a row: no pin
    assert len(tables[0]) == len(tables[1]) == len(WORDS) + 1
    pairs = [("crimson", w) for w in WORDS]
    np.testing.assert_array_equal(tables[1].score_pairs(pairs)[0],
                                  tables[0].score_pairs(pairs)[0])


def test_scorer_rungs_match_reference(scorers):
    """Device rung, then the LRU (the same texts again: no new device
    rows), then the table rung (the same fp32 rows quantized in both
    packages): every score within 1e-5 of the reference's."""
    ref, port = scorers
    pairs = [(g, a) for g in WORDS[:6] + OOV for a in WORDS[6:9]]
    dispatches = metrics.counter_total("scorer.dispatches")
    np.testing.assert_allclose(port.similarity(pairs),
                               ref.similarity(pairs), atol=ATOL, rtol=0)
    assert metrics.counter_total("scorer.dispatches") == dispatches + 1
    hits = metrics.counter_total("scorer.embed_cache_hits")
    np.testing.assert_allclose(port.similarity(pairs),
                               ref.similarity(pairs), atol=ATOL, rtol=0)
    assert metrics.counter_total("scorer.dispatches") == dispatches + 1
    assert metrics.counter_total("scorer.embed_cache_hits") > hits
    rows = ref.embed(WORDS)
    ref.table = jet.EmbedTable.from_embeddings(WORDS, rows)
    port.arm_table(pet.EmbedTable.from_embeddings(WORDS, rows))
    try:
        table_hits = metrics.counter_total("scorer.table_hits")
        np.testing.assert_allclose(port.embed(WORDS + OOV),
                                   ref.embed(WORDS + OOV), atol=ATOL, rtol=0)
        assert metrics.counter_total("scorer.table_hits") == \
            table_hits + len(WORDS)
        np.testing.assert_allclose(port.similarity(pairs),
                                   ref.similarity(pairs), atol=ATOL, rtol=0)
        got, want = port.table_scores(pairs), ref.table_scores(pairs)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
        assert port.pin_answers(OOV[:2] + WORDS[:1]) == \
            ref.pin_answers(OOV[:2] + WORDS[:1]) == 2
        both = [(w, o) for w in WORDS[:4] for o in OOV[:2]]
        got, want = port.table_scores(both), ref.table_scores(both)
        assert got[1].all() and want[1].all()
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    finally:
        ref.table = None
        port.arm_table(None)


def test_invalid_rows_are_nan_and_never_cached(scorers):
    """A row the device verdict rejects (the chaos poison here) comes back
    NaN and stays out of the LRU; the next call embeds it afresh."""
    from cassmantle_tpu_torch import chaos

    _, port = scorers
    texts = ["poisoned once", "healthy neighbor"]
    chaos.configure("seed=2;device.poison=raise:peer=scorer,times=1")
    try:
        bad = port.embed(texts)
    finally:
        chaos.disarm()
    assert np.isnan(bad[0]).all() and np.isfinite(bad[1]).all()
    good = port.embed(texts)
    assert np.isfinite(good).all()
    np.testing.assert_array_equal(good[1], bad[1])


def test_port_builds_and_caches_its_own_table(scorers, tmp_path):
    """``build_table`` embeds the words through the scorer's own encoder,
    writes the reference's format under the port's signature and loads
    it back; a second call loads the cached file. Its int8 cosines stay
    within the reference's 1e-2 bar of the fp32 ones."""
    _, port = scorers
    words = list(load_wordlist()[:300]) + WORDS
    path = str(tmp_path / "table.bin")
    table, stats = port.build_table(words, path=path)
    assert stats["built"] and stats["bytes"] == os.path.getsize(path)
    assert stats["rows"] == len(table) == len(
        dict.fromkeys(pet.normalize_key(w) for w in words))
    assert pet.read_header(path)["signature"] == port.table_signature(words)
    again, stats2 = port.build_table(words, path=path)
    assert not stats2["built"] and len(again) == len(table)
    keys = list(dict.fromkeys(pet.normalize_key(w) for w in words))
    fp32 = port.embed(keys[:64])
    q8 = np.stack([table.lookup(w) for w in keys[:64]])
    err = np.abs(fp32 @ fp32.T - q8 @ q8.T)
    assert float(err.max()) < 1e-2, err.max()
    assert port.weights_fp.startswith("sha256:")
    fresh = EmbeddingScorer(port_test_config().models.minilm, "cpu")
    assert fresh.weights_fp.startswith("sha256:")
    assert fresh.weights_fp != port.weights_fp
    assert fresh.table_signature(words) != port.table_signature(words)



def test_a_new_tokenizer_never_arms_the_cached_table(tmp_path):
    """The signature binds the tokenizer too: the same seeded weights with
    a WordPiece vocabulary (minilm_vocab.txt in the weights directory) in
    place of the byte tokenizer neither load the table the byte tokenizer
    made nor serve its rows; they build their own, and a changed
    vocabulary file changes the signature again."""
    from _torch_port_weights import write_vocab_files

    words = WORDS + OOV
    path = str(tmp_path / "table.bin")
    cfg = port_test_config().models.minilm
    byte = EmbeddingScorer(cfg, "cpu")
    byte.build_table(words, path=path)
    vocab_dir = tmp_path / "weights"
    vocab_dir.mkdir()
    write_vocab_files(str(vocab_dir))
    wp = EmbeddingScorer(cfg, "cpu", weights_dir=str(vocab_dir))
    assert type(wp.tokenizer).__name__ == "WordPieceTokenizer"
    assert all(np.array_equal(a, b) for a, b in zip(
        byte.model.state_dict().values(), wp.model.state_dict().values()))
    sig = wp.table_signature(words)
    assert wp.weights_fp != byte.weights_fp
    assert sig != byte.table_signature(words)
    assert pet.EmbedTable.load(path, expected_signature=sig) is None
    table, stats = wp.build_table(words, path=path)
    assert stats["built"]
    assert pet.read_header(path)["signature"] == sig
    np.testing.assert_allclose(
        table.lookup(OOV[0]), wp.embed([OOV[0]])[0], atol=1e-2)
    with open(vocab_dir / "minilm_vocab.txt", "a") as f:
        f.write("zyzzyva\n")
    edited = EmbeddingScorer(cfg, "cpu", weights_dir=str(vocab_dir))
    assert edited.table_signature(words) != sig

def test_a_changed_weight_never_arms_the_cached_table(tmp_path):
    """The signature digests the served encoder's weights themselves: a
    scorer whose weights differ from the cached table's in one element
    neither loads that table nor serves its rows; it builds its own."""
    words = WORDS + OOV
    path = str(tmp_path / "table.bin")
    cfg = port_test_config().models.minilm
    first = EmbeddingScorer(cfg, "cpu")
    first.build_table(words, path=path)
    state = {k: v.clone() for k, v in first.model.state_dict().items()}
    name = sorted(state)[0]
    state[name].view(-1)[0] += 1e-3
    changed = EmbeddingScorer(cfg, "cpu", state_dict=state)
    assert changed.weights_fp != first.weights_fp
    sig = changed.table_signature(words)
    assert sig != first.table_signature(words)
    assert pet.EmbedTable.load(path, expected_signature=sig) is None
    table, stats = changed.build_table(words, path=path)
    assert stats["built"]
    assert pet.read_header(path)["signature"] == sig
    np.testing.assert_allclose(
        table.lookup(OOV[0]), changed.embed([OOV[0]])[0], atol=1e-2)
