"""The port's CLIP quality gate against the reference's.

``cassmantle_tpu_torch/models/clip_vision.py``, ``eval/clip_parity.py``,
``tools/clip_report.py`` and the CLIP vision converter against
``cassmantle_tpu``'s, at the tiny CLIP geometry (fp32, CPU), on the same
seeded weights and images. Tolerances: the vision tower's unit
embeddings within 1e-5; ``preprocess_for_clip`` within 1e-5 (512 and
1024 -> 224: JAX's own resize weights, summed in another order);
similarities and report figures within 1e-5; converted tensors equal bit
for bit.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from cassmantle_tpu.config import ClipTextConfig as JClipTextConfig
from cassmantle_tpu.config import FrameworkConfig as JFrameworkConfig
from cassmantle_tpu.eval import clip_parity as jparity
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClipText
from cassmantle_tpu.models.clip_vision import ClipVisionConfig as JVCfg
from cassmantle_tpu.models.clip_vision import ClipVisionEncoder as JVision
from cassmantle_tpu.models.clip_vision import (
    preprocess_for_clip as jpreprocess,
)
from cassmantle_tpu.models.weights import init_params
from cassmantle_tpu_torch.config import ClipTextConfig, FrameworkConfig
from cassmantle_tpu_torch.eval import clip_parity as pparity
from cassmantle_tpu_torch.models import weights as pw
from cassmantle_tpu_torch.models.clip_vision import (
    ClipVisionConfig,
    ClipVisionEncoder,
    preprocess_for_clip,
)
from cassmantle_tpu_torch.tools import clip_report as preport
from test_weights import _torch_dense, fabricate_clip, fabricate_clip_vision

from _torch_port_common import jax_params, load, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_positions=16)
PROMPTS = ["a lighthouse", "a caravan", "a comet"]


def _images(seed, n=3, hw=32):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3),
                                                dtype=np.uint8)


def _reference_report_module():
    spec = importlib.util.spec_from_file_location(
        "reference_clip_report", os.path.join(REPO, "tools",
                                              "clip_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jharness():
    return jparity.ClipSimilarityHarness(
        text_cfg=JClipTextConfig(**TEXT), vision_cfg=JVCfg.tiny(),
        pad_len=16)


def _port_harness(jh):
    """The port's harness on the reference harness's weights."""
    return pparity.ClipSimilarityHarness(
        text_cfg=ClipTextConfig(**TEXT), vision_cfg=ClipVisionConfig.tiny(),
        pad_len=16, device="cpu", state_dicts={
            "clip_text": pw.from_jax("clip_text",
                                     jax.device_get(jh.text_params)),
            "clip_vision": pw.from_jax("clip_vision",
                                       jax.device_get(jh.vision_params)),
            "text_projection": torch.from_numpy(
                np.asarray(jh.text_projection))})


@pytest.fixture(scope="module")
def pharness(jharness):
    return _port_harness(jharness)


# -- the tower and its preprocessing ------------------------------------------

@pytest.mark.parametrize("cfg", [ClipVisionConfig.tiny(), ClipVisionConfig(
    image_size=56, patch_size=14, hidden_size=96, intermediate_size=160,
    num_layers=3, num_heads=6, projection_dim=48)], ids=("tiny", "l14ish"))
def test_vision_tower_matches_flax(cfg):
    jcfg = JVCfg(**vars(cfg))
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)
                                 ).astype(np.float32)
    params = jax_params(JVision(jcfg), 2, jnp.asarray(images))
    ref = np.asarray(JVision(jcfg).apply(params, jnp.asarray(images)))
    port = load(ClipVisionEncoder(cfg), params, "clip_vision")
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    np.testing.assert_allclose(to_numpy(got), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ref, axis=-1), 1.0,
                               atol=1e-5)


def test_full_size_config_is_vit_l14():
    cfg = ClipVisionConfig()
    assert (cfg.image_size, cfg.patch_size, cfg.hidden_size,
            cfg.intermediate_size, cfg.num_layers, cfg.num_heads,
            cfg.projection_dim, cfg.dtype) == (224, 14, 1024, 4096, 24, 16,
                                               768, "float32")
    assert vars(cfg) == vars(JVCfg())
    assert vars(ClipVisionConfig.tiny()) == vars(JVCfg.tiny())
    with torch.device("meta"):
        tower = ClipVisionEncoder(cfg)
    n = sum(p.numel() for p in tower.parameters())
    assert n == 303_966_208     # CLIP ViT-L/14's vision_model + projection


@pytest.mark.parametrize("hw,size", [(512, 224), (1024, 224), (64, 32),
                                     (32, 32)])
def test_preprocess_matches_reference(hw, size):
    images = _images(hw, n=2, hw=hw)
    ref = np.asarray(jax.jit(jpreprocess, static_argnums=1)(
        jnp.asarray(images), size))
    got = preprocess_for_clip(torch.from_numpy(images), size)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# -- the harness --------------------------------------------------------------

def test_similarity_and_parity_report_match_reference(jharness, pharness):
    images = _images(0)
    ref = jharness.similarity(images, PROMPTS)
    got = pharness.similarity(images, PROMPTS)
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pharness.similarity(images, PROMPTS), got)
    jr = jharness.parity_report(images, PROMPTS, baseline_mean=0.3)
    pr = pharness.parity_report(images, PROMPTS, baseline_mean=0.3)
    assert set(pr) == set(jr)
    for k in jr:
        if isinstance(jr[k], float):
            assert abs(pr[k] - jr[k]) <= 1e-5 * max(1.0, abs(jr[k])), k
        else:
            assert pr[k] == jr[k], k
    assert pr["real_weights"] is False


def test_image_similarity_matches_reference(jharness, pharness):
    a, b = _images(1), _images(2)
    np.testing.assert_allclose(pharness.image_similarity(a, b),
                               jharness.image_similarity(a, b), atol=1e-5)
    same = pharness.image_similarity(a, a)
    np.testing.assert_allclose(same, 1.0, atol=1e-5)


@pytest.mark.parametrize("name,arms", [
    ("consistency_quality_report", ("student", "teacher")),
    ("w8a8_quality_report", ("w8a8", "fp")),
    ("encprop_quality_report", ("encprop", "full"))])
def test_pair_reports_match_reference(jharness, pharness, name, arms):
    a, b = _images(3), _images(4)
    b[0] = a[0]
    for x, y in ((a, b), (a, a)):
        jr = getattr(jparity, name)(jharness, x, y, PROMPTS)
        pr = getattr(pparity, name)(pharness, x, y, PROMPTS)
        assert list(pr) == list(jr)
        assert {f"clip_sim_{arm}" for arm in arms} <= set(pr)
        for k in jr:
            if isinstance(jr[k], float):
                assert abs(pr[k] - jr[k]) <= 1e-5, (k, pr[k], jr[k])
            else:
                assert pr[k] == jr[k], k
    assert pr["exact"] and not pr["gate_enforced"]
    assert (pparity.ENCPROP_IMAGE_SIM_FLOOR,
            pparity.CONSISTENCY_IMAGE_SIM_FLOOR,
            pparity.W8A8_IMAGE_SIM_FLOOR) == (
        jparity.ENCPROP_IMAGE_SIM_FLOOR, jparity.CONSISTENCY_IMAGE_SIM_FLOOR,
        jparity.W8A8_IMAGE_SIM_FLOOR)


def _full_clip_file(tmp_path, with_projection=True):
    """A full CLIPModel file (both towers, both projections) written with
    the reference's fabricators from seeded reference trees."""
    text_cfg, vcfg = JClipTextConfig(**TEXT), JVCfg.tiny()
    text_ref = init_params(JClipText(text_cfg), 0,
                           jnp.zeros((1, 8), dtype=jnp.int32))
    vis_ref = init_params(JVision(vcfg), 1, jnp.zeros(
        (1, vcfg.image_size, vcfg.image_size, 3)))
    proj = np.random.default_rng(0).standard_normal(
        (text_cfg.hidden_size, vcfg.projection_dim)).astype(np.float32)
    ckpt = {**fabricate_clip(text_ref, text_cfg.num_layers),
            **fabricate_clip_vision(vis_ref, vcfg.num_layers),
            "logit_scale": np.asarray(2.6592, np.float32),
            "vision_model.embeddings.position_ids": np.arange(
                17, dtype=np.int64)[None]}
    if with_projection:
        ckpt["text_projection.weight"] = _torch_dense(proj)
    save_file(ckpt, str(tmp_path / "clip_text.safetensors"))
    return text_ref, vis_ref, proj


def test_converters_on_a_seeded_full_clip_file(tmp_path, caplog):
    text_ref, vis_ref, proj = _full_clip_file(tmp_path)
    tensors = pw.load_checkpoint_tensors(str(tmp_path),
                                         "clip_text.safetensors")
    with caplog.at_level("WARNING", logger="cassmantle.weights"):
        vision = pw.convert_clip_vision(tensors, 2)
        text = pw.convert_clip_text(tensors, 2)
    assert not [r for r in caplog.records if r.levelname == "WARNING"]
    for got, ref in ((vision, pw.from_jax("clip_vision",
                                          jax.device_get(vis_ref))),
                     (text, pw.from_jax("clip_text",
                                        jax.device_get(text_ref)))):
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    assert torch.equal(pw.convert_clip_text_projection(tensors),
                       torch.from_numpy(proj))
    # the harness loads all three stages from the one file
    h = pparity.ClipSimilarityHarness(
        text_cfg=ClipTextConfig(**TEXT), vision_cfg=ClipVisionConfig.tiny(),
        weights_dir=str(tmp_path), pad_len=16, device="cpu")
    assert h.loaded_real_weights
    for k, v in h.vision.state_dict().items():
        assert torch.equal(v, vision[k]), k
    assert torch.equal(h.text_projection, torch.from_numpy(proj))
    report = h.parity_report(np.zeros((1, 32, 32, 3), dtype=np.uint8),
                             ["x"])
    assert report["real_weights"] is True
    jh = jparity.ClipSimilarityHarness(
        text_cfg=JClipTextConfig(**TEXT), vision_cfg=JVCfg.tiny(),
        weights_dir=str(tmp_path), pad_len=16)
    assert jh.loaded_real_weights
    images = _images(5)
    np.testing.assert_allclose(h.similarity(images, PROMPTS),
                               jh.similarity(images, PROMPTS), atol=1e-5)


def test_a_file_without_the_projection_is_not_real_weights(tmp_path):
    _full_clip_file(tmp_path, with_projection=False)
    h = pparity.ClipSimilarityHarness(
        text_cfg=ClipTextConfig(**TEXT), vision_cfg=ClipVisionConfig.tiny(),
        weights_dir=str(tmp_path), pad_len=16, device="cpu")
    assert not h.loaded_real_weights
    assert h.text_projection.shape == (64, 64)


def test_from_jax_takes_the_clip_vision_kind():
    assert "clip_vision" in pw.TREE_KINDS
    assert "clip_vision" not in pw.KINDS
    with pytest.raises(ValueError, match="unknown model kind"):
        pw.from_jax("clip_vision_2", {})


# -- the report and the gate --------------------------------------------------

def test_quality_gate_config_equals_reference():
    assert FrameworkConfig().quality == FrameworkConfig().quality
    ours, ref = FrameworkConfig().quality, JFrameworkConfig().quality
    assert ours.parity_vs_ddim50 == ref.parity_vs_ddim50
    assert ours.ddim50_min_sim == ref.ddim50_min_sim
    for name in ("dpmpp25", "lcm", "sdxl_w8a8", "nope"):
        assert ours.threshold_for(name) == ref.threshold_for(name)


@pytest.mark.parametrize("anchor", [0.30, 0.10])
def test_apply_quality_gate_matches_reference(anchor):
    ref_mod = _reference_report_module()

    def report():
        presets = {"ddim50": {"clip_sim_mean": anchor},
                   "dpmpp25": {"clip_sim_mean": 0.29,
                               "parity_vs_ddim50": 0.29 / anchor},
                   "turbo": {"clip_sim_mean": 0.2,
                             "parity_vs_ddim50": 0.2 / anchor},
                   "custom": {"clip_sim_mean": 0.1,
                              "parity_vs_ddim50": 0.1 / anchor}}
        return {"presets": presets}

    ours, theirs = report(), report()
    assert preport.apply_quality_gate(ours) == \
        ref_mod.apply_quality_gate(theirs)
    assert ours == theirs
    assert preport.PROMPTS == ref_mod.PROMPTS
    assert set(preport.preset_factories(True)) == set(
        ref_mod.preset_factories(True))
    assert set(preport.preset_factories(False)) == set(
        ref_mod.preset_factories(False))


def test_clip_report_tiny_and_the_gate(tmp_path):
    out = tmp_path / "report.json"
    assert preport.main(["--tiny", "--platform", "cpu", "--seeds", "1",
                         "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert list(report["presets"]) == preport.DEFAULT_PRESETS.split(",")
    assert report["real_weights"] is False
    assert report["gate_enforced"] is False
    for name, entry in report["presets"].items():
        assert entry["n"] == 8 and np.isfinite(entry["clip_sim_mean"])
        assert entry["pipeline_real_weights"] is False
        if name != "ddim50":
            assert "parity_vs_ddim50" in entry
    # the same failures the gate names, now enforced
    assert preport.main(["--tiny", "--platform", "cpu", "--seeds", "1",
                         "--presets", "ddim50,turbo", "--out",
                         str(tmp_path / "e.json"), "--enforce"]) == (
        2 if json.loads((tmp_path / "e.json").read_text())["gate_failures"]
        else 0)
    assert preport.main(["--tiny", "--platform", "cpu",
                         "--presets", "nope"]) == 2
