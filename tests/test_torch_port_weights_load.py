"""The port's weights loading against the reference's, on the CPU.

Checkpoints are fabricated from seeded reference trees under the
published names and written with the ``safetensors`` package
(``tests/_torch_port_weights.py``). Held here:

- every converter's output equals ``from_jax`` of the reference
  converter's, bit for bit, for all ten kinds;
- every manifest of ``data/manifests`` (nine files, and the VAE encoder
  from both VAE files), fed as zero-stride stubs on the meta device,
  fills the port module built on the meta device at its published config,
  shape for shape, with nothing left over but the manifest's ``optional``
  keys and the converter's ignore list;
- the reader against the ``safetensors`` package (F32, F16, BF16, I8),
  shards, the seeded fallbacks (truncated file, missing tensor), the
  fingerprints (a changed file raises; sidecars verify across packages);
- pipelines built from one directory by both packages (image, tokens,
  embeddings, SDXL's projection, img2img's encoder, the speculative
  draft, ``loaded_real_weights``);
- the file-backed rebuild: the files read again, the served tensors
  restored in place, and a changed file failing the rebuild attempt.
"""

import asyncio
import dataclasses
import json
import logging
import os
import shutil
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from cassmantle_tpu import config as jax_config
from cassmantle_tpu.models import weights as jax_weights
from cassmantle_tpu.ops.ddim import initial_latents as jax_initial_latents
from cassmantle_tpu.ops.scorer import EmbeddingScorer as JScorer
from cassmantle_tpu.serving import pipeline as jax_pipeline
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu.utils import checkpoint as jax_checkpoint
from cassmantle_tpu_torch import config as port_config
from cassmantle_tpu_torch.models import weights as pw
from cassmantle_tpu_torch.models.clip_text import ClipTextEncoder
from cassmantle_tpu_torch.models.gpt2 import GPT2LM
from cassmantle_tpu_torch.models.minilm import MiniLMEncoder
from cassmantle_tpu_torch.models.mistral import MistralLM
from cassmantle_tpu_torch.models.unet import UNet
from cassmantle_tpu_torch.models.vae import VAEDecoder, VAEEncoder
from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
from cassmantle_tpu_torch.serving.pipeline import (
    PromptGenerator,
    Text2ImagePipeline,
)
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
from cassmantle_tpu_torch.serving.service import InferenceService
from cassmantle_tpu_torch.utils import checkpoint as port_checkpoint
from cassmantle_tpu_torch.utils.logging import metrics
from cassmantle_tpu_torch.utils.tokenizers import (
    BPETokenizer,
    SentencePieceBPETokenizer,
    WordPieceTokenizer,
)

import _torch_port_weights as fab
from test_torch_port_rules import _imported_modules, _port_files

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(REPO, "data", "manifests")


def _mistral_cfg(module):
    cfg = module.test_config()
    return cfg.replace(models=dataclasses.replace(
        cfg.models, mistral=module.MistralConfig.tiny()))


def _draft_cfg(module):
    cfg = module.test_config()
    return cfg.replace(spec_decode=module.SpecDecodeConfig(
        mode="draft_model", gamma=4, draft_model=module.GPT2Config(
            vocab_size=cfg.models.gpt2.vocab_size, hidden_size=32,
            num_layers=1, num_heads=2, max_positions=128, dtype="float32")))


CONFIGS = {"sd15": (jax_config.test_config, port_config.test_config),
           "sdxl": (jax_config.test_sdxl_config,
                    port_config.test_sdxl_config),
           "mistral": (lambda: _mistral_cfg(jax_config),
                       lambda: _mistral_cfg(port_config)),
           "draft": (lambda: _draft_cfg(jax_config),
                     lambda: _draft_cfg(port_config))}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: (weights_dir, reference cfg, port cfg, reference params)};
    Mistral in two shards."""
    out = {}
    for name, (jcfg, pcfg) in CONFIGS.items():
        path = str(tmp_path_factory.mktemp(name))
        cfg = jcfg()
        params = fab.reference_params(cfg, seed=len(out) * 31)
        fab.write_weights_dir(path, cfg, params,
                              shards=2 if name == "mistral" else 1)
        out[name] = (path, cfg, pcfg(), params)
    return out


@contextmanager
def weights_log():
    """The port's ``cassmantle.weights`` records (the logger tree does not
    propagate to pytest's root handler)."""
    records = []

    class Collect(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("cassmantle.weights")
    handler = Collect()
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def _assert_equal_dicts(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k in want:
        g, w = torch.as_tensor(got[k]), want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def _ref_convert(kind, jcfg):
    m = jcfg.models
    return {
        "clip_text": lambda t: jax_weights.convert_clip_text(
            t, m.clip_text.num_layers),
        "clip_text_2": lambda t: jax_weights.convert_clip_text(
            t, m.clip_text_2.num_layers),
        "unet": lambda t: jax_weights.convert_unet(t, m.unet),
        "unet_xl": lambda t: jax_weights.convert_unet(t, m.unet),
        "vae": lambda t: jax_weights.convert_vae_decoder(t, m.vae),
        "vae_xl": lambda t: jax_weights.convert_vae_decoder(t, m.vae),
        "vae_enc": lambda t: jax_weights.convert_vae_encoder(t, m.vae),
        "gpt2": lambda t: jax_weights.convert_gpt2(
            t, m.gpt2.num_layers, m.gpt2.hidden_size),
        "mistral": lambda t: jax_weights.convert_mistral(
            t, m.mistral.num_layers),
        "minilm": lambda t: jax_weights.convert_minilm(
            t, m.minilm.num_layers),
    }[kind]


# -- converters, bit for bit ---------------------------------------------------

KIND_DIRS = {"clip_text": "sd15", "clip_text_2": "sdxl", "unet": "sd15",
             "unet_xl": "sdxl", "vae": "sd15", "vae_xl": "sdxl",
             "vae_enc": "sd15", "gpt2": "sd15", "mistral": "mistral",
             "minilm": "sd15"}


@pytest.mark.parametrize("kind", pw.KINDS)
def test_converter_equals_reference_bit_for_bit(dirs, kind):
    """maybe_load(file) == from_jax(kind, reference maybe_load(file)),
    every key, tolerance 0 (Mistral from its two shards)."""
    path, jcfg, pcfg, _ = dirs[KIND_DIRS[kind]]
    name = pw.CHECKPOINT_FILES[kind]
    with weights_log() as records:
        got = pw.maybe_load(path, name, pw.converter_for(kind, pcfg.models),
                            kind)
    assert got is not None
    assert not [r for r in records if r.levelno >= logging.WARNING]
    ref = jax_weights.maybe_load(path, name, _ref_convert(kind, jcfg), kind)
    _assert_equal_dicts(dict(got), pw.from_jax(kind, jax.device_get(ref)))
    if kind == "clip_text_2":
        tensors = pw.load_checkpoint_tensors(path, name)
        want = jax_weights.convert_clip_text_projection(
            jax_weights.load_checkpoint_tensors(path, name))
        assert torch.equal(pw.convert_clip_text_projection(tensors),
                           torch.from_numpy(np.asarray(want)))


def test_converter_casts_to_the_storage_dtype(dirs):
    path, _, pcfg, _ = dirs["sd15"]
    plain = pw.maybe_load(path, "unet.safetensors",
                          pw.converter_for("unet", pcfg.models), "unet")
    cast = pw.maybe_load(path, "unet.safetensors",
                         pw.converter_for("unet", pcfg.models), "unet",
                         cast_to="bfloat16")
    for k in plain:
        assert cast[k].dtype == torch.bfloat16
        assert torch.equal(cast[k], plain[k].to(torch.bfloat16))


# -- full-width inventories -----------------------------------------------------

def _published():
    sd15, xl = port_config.FrameworkConfig().models, \
        port_config.sdxl_config().models
    mistral = port_config.MistralConfig()
    return {
        "unet_sd15": ("unet", sd15, lambda: UNet(sd15.unet)),
        "unet_sdxl": ("unet_xl", xl, lambda: UNet(xl.unet)),
        "clip_full": ("clip_text", sd15,
                      lambda: ClipTextEncoder(sd15.clip_text)),
        "clip_bigg": ("clip_text_2", xl,
                      lambda: ClipTextEncoder(xl.clip_text_2)),
        "vae_sd15": ("vae", sd15, lambda: VAEDecoder(sd15.vae)),
        "vae_sdxl": ("vae_xl", xl, lambda: VAEDecoder(xl.vae)),
        "vae_sd15/encoder": ("vae_enc", sd15, lambda: VAEEncoder(sd15.vae)),
        "vae_sdxl/encoder": ("vae_enc", xl, lambda: VAEEncoder(xl.vae)),
        "gpt2": ("gpt2", sd15, lambda: GPT2LM(sd15.gpt2)),
        "minilm": ("minilm", sd15, lambda: MiniLMEncoder(sd15.minilm)),
        "mistral": ("mistral", dataclasses.replace(sd15, mistral=mistral),
                    lambda: MistralLM(mistral)),
    }


@pytest.mark.parametrize("manifest", sorted(_published()))
def test_manifest_fills_the_port_module_at_published_width(manifest):
    """Zero-stride stubs of the full inventory (optional keys included)
    on the meta device: no tensor left unused outside the ignore list, a
    tensor for every parameter of the port module built on the meta
    device, shape for shape. Nothing is allocated."""
    kind, models, build = _published()[manifest]
    with open(os.path.join(MANIFESTS,
                           f"{manifest.split('/')[0]}.json")) as f:
        inv = json.load(f)
    stub = torch.empty((), device="meta")
    tensors = {k: stub.expand(tuple(s))
               for k, s in {**inv["tensors"], **inv["optional"]}.items()}
    with weights_log() as records:
        got = pw.converter_for(kind, models)(tensors)
    unused = [r.getMessage() for r in records if r.levelno >= logging.WARNING]
    assert not unused, unused
    with torch.device("meta"):
        want = build().state_dict()
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    bad = {k: (tuple(got[k].shape), tuple(v.shape)) for k, v in want.items()
           if tuple(got[k].shape) != tuple(v.shape)}
    assert not bad, list(bad.items())[:4]
    if kind == "clip_text_2":
        h = models.clip_text_2.hidden_size
        assert pw.convert_clip_text_projection(tensors).shape == (h, h)


def test_port_imports_no_safetensors():
    """The card has no safetensors package: the port and chip_smoke.py
    read the format themselves."""
    bad = {os.path.relpath(p, REPO): m for p in _port_files()
           for m in _imported_modules(p) if m.split(".")[0] == "safetensors"}
    assert not bad, bad


# -- the reader and the fallbacks ------------------------------------------------

def test_reader_equals_the_safetensors_package(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(7, generator=gen).half(),
        "bf16": torch.randn(2, 3, 4, generator=gen).to(torch.bfloat16),
        "i8": torch.randint(-128, 128, (9,), generator=gen,
                            dtype=torch.int8),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "x.safetensors")
    st_save(tensors, path, metadata={"format": "pt"})
    got, want = pw.load_safetensors(path), st_load(path)
    _assert_equal_dicts(got, want)
    # the reference's reader gives the same values
    ref = jax_weights.load_safetensors(path)
    for k in ("f32", "f16", "i8"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert torch.equal(got["bf16"].float(),
                       torch.from_numpy(np.asarray(ref["bf16"],
                                                   dtype=np.float32)))


def test_shards_merge_in_sorted_order(dirs, tmp_path):
    """gpt2-00001/00002 give what gpt2.safetensors gives."""
    path, _, pcfg, _ = dirs["sd15"]
    whole = pw.load_safetensors(os.path.join(path, "gpt2.safetensors"))
    keys = sorted(whole)
    for i in range(2):
        st_save({k: whole[k].clone() for k in keys[i::2]},
                str(tmp_path / f"gpt2-{i + 1:05d}.safetensors"))
    conv = pw.converter_for("gpt2", pcfg.models)
    got = pw.maybe_load(str(tmp_path), "gpt2.safetensors", conv, "gpt2")
    want = pw.maybe_load(path, "gpt2.safetensors", conv, "gpt2")
    _assert_equal_dicts(dict(got), dict(want))
    assert pw.checkpoint_paths(str(tmp_path), "gpt2.safetensors") == [
        str(tmp_path / "gpt2-00001.safetensors"),
        str(tmp_path / "gpt2-00002.safetensors")]


def _seeded_gpt2(pcfg):
    return PromptGenerator(pcfg, "cpu").model.state_dict()


@pytest.mark.parametrize("fault", ["truncated", "missing_tensor"])
def test_bad_file_falls_back_to_the_seeded_init(dirs, tmp_path, fault):
    """A truncated file and a file lacking a tensor: None from maybe_load
    with a log line, and the pipeline serves the seeded init."""
    path, _, pcfg, _ = dirs["sd15"]
    src = os.path.join(path, "gpt2.safetensors")
    dst = str(tmp_path / "gpt2.safetensors")
    if fault == "truncated":
        data = open(src, "rb").read()
        with open(dst, "wb") as f:
            f.write(data[: len(data) // 2])
    else:
        tensors = st_load(src)
        del tensors["h.0.mlp.c_fc.weight"]
        st_save(tensors, dst)
    with weights_log() as records:
        got = pw.maybe_load(str(tmp_path), "gpt2.safetensors",
                            pw.converter_for("gpt2", pcfg.models), "gpt2")
    assert got is None
    said = " ".join(r.getMessage() for r in records
                    if r.levelno >= logging.ERROR)
    assert ("unreadable" if fault == "truncated" else "missing") in said
    gen = PromptGenerator(pcfg, "cpu", weights_dir=str(tmp_path))
    assert not gen.loaded_real_weights
    _assert_equal_dicts(gen.model.state_dict(), _seeded_gpt2(pcfg))


def test_changed_file_raises_checkpoint_corrupt(dirs, tmp_path):
    """The first load records the sidecar; a changed file then raises
    (and counts) instead of falling back."""
    path, _, pcfg, _ = dirs["sd15"]
    shutil.copy(os.path.join(path, "gpt2.safetensors"), tmp_path)
    conv = pw.converter_for("gpt2", pcfg.models)
    assert pw.maybe_load(str(tmp_path), "gpt2.safetensors", conv, "gpt2")
    assert os.path.exists(tmp_path / "gpt2.safetensors.fingerprint")
    tensors = st_load(str(tmp_path / "gpt2.safetensors"))
    tensors["wte.weight"][0, 0] += 1.0
    st_save(tensors, str(tmp_path / "gpt2.safetensors"))
    before = metrics.counter_total("checkpoint.fingerprint_mismatch")
    with pytest.raises(port_checkpoint.CheckpointCorrupt, match="gpt2"):
        pw.maybe_load(str(tmp_path), "gpt2.safetensors", conv, "gpt2")
    assert metrics.counter_total("checkpoint.fingerprint_mismatch") == \
        before + 1


@pytest.mark.parametrize("recorder", ["reference", "port"])
def test_sidecars_verify_across_packages(tmp_path, recorder):
    """A sidecar either package recorded verifies in the other; both
    reject the same changed file."""
    path = str(tmp_path / "w.safetensors")
    st_save({"a": torch.arange(4.0)}, path)
    first, other = ((jax_checkpoint, port_checkpoint)
                    if recorder == "reference"
                    else (port_checkpoint, jax_checkpoint))
    first.verify_or_record(path)
    assert port_checkpoint.read_fingerprint(path) == \
        jax_checkpoint.read_fingerprint(path)
    other.verify_or_record(path)
    st_save({"a": torch.arange(5.0)}, path)
    for pkg in (first, other):
        with pytest.raises(pkg.CheckpointCorrupt):
            pkg.verify_or_record(path)


def test_a_model_given_both_ways_is_an_error(dirs):
    path, _, pcfg, params = dirs["sd15"]
    sd = pw.from_jax("gpt2", params["gpt2"])
    with pytest.raises(ValueError, match="give one"):
        PromptGenerator(pcfg, "cpu", sd, weights_dir=path)
    with pytest.raises(ValueError, match="give one"):
        Text2ImagePipeline(pcfg, "cpu", weights_dir=path, state_dicts={
            "vae": pw.from_jax("vae", params["vae"])})
    with pytest.raises(ValueError, match="give one"):
        EmbeddingScorer(pcfg.models.minilm, "cpu", weights_dir=path,
                        state_dict=pw.from_jax("minilm", params["minilm"]))


# -- pipelines from one directory ------------------------------------------------

def _x_t(jcfg, n, seed):
    s = jcfg.sampler
    scale = 2 ** (len(jcfg.models.vae.channel_mults) - 1)
    return torch.from_numpy(np.array(jax_initial_latents(
        jax.random.PRNGKey(seed), n, s.image_size, scale)))


def _assert_images_close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


@pytest.mark.parametrize("which", ["sd15", "sdxl"])
def test_image_round_from_a_directory_matches_reference(dirs, which):
    """Both packages' image pipelines from one directory (BPE tokenizer
    from its files, SDXL with bigG's projection): images within 2 uint8
    levels (mean 0.5), the same loaded_real_weights."""
    path, jcfg, pcfg, _ = dirs[which]
    if which == "sd15":
        ref = jax_pipeline.Text2ImagePipeline(jcfg, weights_dir=path)
        port = Text2ImagePipeline(pcfg, "cpu", weights_dir=path)
        assert port.loaded_real_weights == ref.loaded_real_weights is True
    else:
        ref = JSDXL(jcfg, weights_dir=path)
        port = SDXLPipeline(pcfg, "cpu", weights_dir=path)
        assert ref.clip2_proj is not None and port.loaded_real_weights
        np.testing.assert_array_equal(port.clip2_proj.numpy(),
                                      np.asarray(ref.clip2_proj))
    assert isinstance(port.tokenizer, BPETokenizer)
    assert type(ref.tokenizer).__name__ == "BPETokenizer"
    want = ref.generate(PROMPTS, seed=3)
    got = port.generate(PROMPTS, latents=_x_t(jcfg, len(PROMPTS), 3))
    _assert_images_close(got, want)


def test_img2img_encoder_from_vae_file_matches_reference(dirs):
    """The encoder half of vae.safetensors, read at first use: its
    parameters equal the reference's, bit for bit, and generate_img2img
    lands within 2 levels of the reference's."""
    path, jcfg, pcfg, _ = dirs["sd15"]
    ref = jax_pipeline.Text2ImagePipeline(jcfg, weights_dir=path)
    port = Text2ImagePipeline(pcfg, "cpu", weights_dir=path)
    assert port.vae_enc is None
    port._ensure_encoder()
    ref._ensure_encoder()
    _assert_equal_dicts(port.vae_enc.state_dict(), pw.from_jax(
        "vae_enc", jax.device_get(ref.enc_params)))
    size = jcfg.sampler.image_size
    img = np.random.default_rng(5).integers(0, 256, (1, size, size, 3),
                                            dtype=np.uint8)
    want = ref.generate_img2img(img, PROMPTS[:1], strength=0.5, seed=1)
    got = port.generate_img2img(img, PROMPTS[:1], strength=0.5, seed=1)
    _assert_images_close(got, want)


@pytest.mark.parametrize("which", ["sd15", "mistral", "draft"])
def test_prompt_decode_from_a_directory_matches_reference(dirs, which):
    """GPT-2, Mistral (two shards, SentencePiece tokenizer) and GPT-2
    with its speculative draft from gpt2_draft.safetensors: tokens and
    lengths equal, the same loaded_real_weights."""
    path, jcfg, pcfg, _ = dirs[which]
    ref = jax_pipeline.PromptGenerator(jcfg, weights_dir=path)
    port = PromptGenerator(pcfg, "cpu", weights_dir=path)
    assert port.loaded_real_weights == ref.loaded_real_weights is True
    want_cls = (SentencePieceBPETokenizer if which == "mistral"
                else BPETokenizer)
    assert isinstance(port.tokenizer, want_cls)
    assert type(ref.tokenizer).__name__ == want_cls.__name__
    texts = fab.SEEDS[:3]
    want_t, want_n = ref.decode_ids_batch(texts, max_new_tokens=8, seed=0)
    got_t, got_n = port.decode_ids_batch(texts, max_new_tokens=8)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))
    if which == "draft":
        _assert_equal_dicts(port.spec_draft.model.state_dict(), pw.from_jax(
            "gpt2", jax.device_get(ref._spec_draft_params)))
        for key in ("chunks", "drafted", "accepted"):
            assert port.last_spec_stats[key] == ref.last_spec_stats[key]


def test_scorer_from_a_directory_matches_reference(dirs):
    """MiniLM from minilm.safetensors with the WordPiece vocabulary:
    embeddings within 1e-5 of the reference's."""
    path, jcfg, pcfg, _ = dirs["sd15"]
    ref = JScorer(jcfg.models.minilm, weights_dir=path, table=None)
    port = EmbeddingScorer(pcfg.models.minilm, "cpu", weights_dir=path)
    assert port.loaded_real_weights
    assert isinstance(port.tokenizer, WordPieceTokenizer)
    words = fab.WORDS[:24] + ["a quiet harbor", "lighthouse", "zyzzyva"]
    np.testing.assert_allclose(port.embed(words), np.asarray(ref.embed(words)),
                               atol=1e-5)


# -- the rebuild from files ----------------------------------------------------

@pytest.fixture()
def service(dirs, tmp_path):
    """An InferenceService over a private copy of the SD1.5 directory."""
    path, _, pcfg, _ = dirs["sd15"]
    local = str(tmp_path / "weights")
    shutil.copytree(path, local)
    svc = InferenceService(pcfg, device="cpu", weights_dir=local, table=None)
    yield svc, local
    asyncio.run(svc.stop())


def test_rebuild_reads_the_files_again_into_the_served_tensors(service,
                                                               monkeypatch):
    """Corrupt served tensors of every model, reload: each equals what
    boot loaded, at the same address, and every recipe read its file
    again (none built a fresh module)."""
    svc, path = service
    t2i, gen, scorer = svc.backend.t2i, svc.backend.prompt_gen, svc.scorer
    before = {id(t): (t.data_ptr(), t.clone())
              for p in (t2i, gen) for t in p.param_tensors()}
    before.update({id(t): (t.data_ptr(), t.clone())
                   for t in scorer._rebuilds.tensors()})
    reads = []
    real = pw.load_safetensors
    monkeypatch.setattr(pw, "load_safetensors",
                        lambda p: reads.append(os.path.basename(p)) or
                        real(p))
    with torch.no_grad():
        for m in (t2i.clip, t2i.unet, t2i.vae, gen.model, scorer.model):
            next(m.parameters()).add_(1.0)
    svc.rebuild_device_state()
    for p in (t2i, gen):
        for t in p.param_tensors():
            ptr, value = before[id(t)]
            assert t.data_ptr() == ptr and torch.equal(t, value)
    for t in scorer._rebuilds.tensors():
        assert torch.equal(t, before[id(t)][1])
    assert sorted(reads) == sorted(
        ["clip_text.safetensors", "unet.safetensors", "vae.safetensors",
         "gpt2.safetensors", "minilm.safetensors"])


def test_rebuild_after_a_file_changed_fails_the_attempt(service,
                                                        monkeypatch):
    """A file changed since boot: the rebuild raises CheckpointCorrupt
    (never the seeded init), every attempt through the recovery manager
    fails, and the loss ends permanent."""
    svc, path = service
    unet_file = os.path.join(path, "unet.safetensors")
    tensors = st_load(unet_file)
    tensors["conv_in.weight"] += 1.0
    st_save(tensors, unet_file)
    with pytest.raises(port_checkpoint.CheckpointCorrupt):
        svc.rebuild_device_state()
    errors = []
    real = svc.rebuild_device_state

    def rebuild():
        try:
            real()
        except Exception as exc:
            errors.append(type(exc).__name__)
            raise

    monkeypatch.setattr(svc.recovery, "rebuild", rebuild)
    svc.recovery.backoff_s = 0.0
    assert svc.recovery.note_dispatch_exception(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    svc.recovery.join(timeout=60.0)
    assert svc.recovery.permanent
    assert errors == ["CheckpointCorrupt"] * svc.recovery.max_attempts


def test_w8a8_rebuild_from_files_requantizes_as_at_build(dirs, tmp_path):
    """The W8A8 UNet and GPT-2 loaded from files: a reload quantizes each
    site from the file's weight as the build did (int8 data and scales
    equal)."""
    path, _, _, _ = dirs["sd15"]
    cfg = port_config.test_config()
    cfg = cfg.replace(models=dataclasses.replace(
        cfg.models, unet_w8a8=True, lm_w8a8=True, w8a8_min_size=1,
        unet=dataclasses.replace(cfg.models.unet, fused_conv=True)))
    t2i = Text2ImagePipeline(cfg, "cpu", weights_dir=path)
    gen = PromptGenerator(cfg, "cpu", weights_dir=path)
    for pipe in (t2i, gen):
        served = pipe.param_tensors()
        assert any(t.dtype == torch.int8 for t in served)
        before = [t.clone() for t in served]
        with torch.no_grad():
            for t in served:
                t.zero_()
        pipe.reload_params()
        for t, b in zip(served, before):
            assert torch.equal(t, b)
