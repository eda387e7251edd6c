"""Port parity of the W8A8 calibration pass and its recorder, on the CPU.

The committed ``data/act_scales.json`` is read, never written: every emit
here goes to a temp path, and the file's bytes are checked unchanged.

Tolerances, each with its reason:
- the signature, the prompt set and its digest, the site keys and the
  committed entry's scales are exact;
- the calibration pass's absmax per site against the reference's on the
  same weights: within 1e-4 relative. Both run fp32 forwards; the
  reference's latents come from ``jax.random.normal``, the port's from
  ``utils/jax_random.py`` (within 4 ulps of it), and the sums run in
  another order (measured: below 2e-6).
"""

import dataclasses
import hashlib
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from cassmantle_tpu.ops import quant as jq
from cassmantle_tpu.ops import quant_matmul as jqm
from cassmantle_tpu.parallel import calibrate as jcal
from cassmantle_tpu.serving.pipeline import (
    Text2ImagePipeline as JText2Image,
)
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.ops import quant
from cassmantle_tpu_torch.parallel import calibrate as pcal
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

COMMITTED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "act_scales.json")


def _digest_of(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def committed_file_unchanged():
    """No test of this file writes data/act_scales.json."""
    before = _digest_of(COMMITTED)
    yield
    assert _digest_of(COMMITTED) == before


@pytest.fixture(scope="module")
def ref_case():
    """The reference's calibration at calibration_config() on its own
    (cached) seeded pipeline, and that pipeline's trees as the port's
    state dicts. The reference's fused sites run its lax path (its
    Pallas interpret mode raises under the installed jax)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CASSMANTLE_NO_FUSED_CONV", "1")
        mp.setattr(jqm, "int8_matmul_ok", lambda *a: False)
        mp.setattr(jqm, "int8_conv_ok", lambda *a: False)
        cfg = jcal.calibration_config()
        stats = jcal.collect_unet_stats(cfg)
        pipe = JText2Image(cfg)
        sd = {"clip_text": from_jax("clip_text",
                                    jax.device_get(pipe.clip_params)),
              "unet": from_jax("unet", jax.device_get(pipe.unet_params)),
              "vae": from_jax("vae", jax.device_get(pipe.vae_params))}
    return {"stats": stats, "sd": sd}


def test_constants_prompts_and_signature_match_the_reference():
    assert pcal.NUM_CALIBRATION_PROMPTS == jcal.NUM_CALIBRATION_PROMPTS
    assert pcal.CALIBRATION_TIMESTEPS == jcal.CALIBRATION_TIMESTEPS
    prompts = pcal.calibration_prompts()
    assert prompts == jcal.calibration_prompts()
    assert pcal.prompts_digest(prompts) == jcal.prompts_digest(prompts)
    dig = pcal.prompts_digest(prompts)
    pm, jm = pcal.calibration_config().models, jcal.calibration_config().models
    assert pcal.calibration_signature(pm, dig) == \
        jcal.calibration_signature(jm, dig)
    with open(COMMITTED) as f:
        entry = json.load(f)["entries"]["unet"]
    assert pcal.calibration_signature(pm, entry["prompts_digest"]) == \
        entry["signature"]
    assert pm.unet.fused_conv and pm.w8a8_min_size == 0


def test_load_act_scales_returns_the_committed_entry():
    """At calibration_config() the port's loader returns the committed
    entry's 44 scales key for key, as the reference's does."""
    with open(COMMITTED) as f:
        want = json.load(f)["entries"]["unet"]["scales"]
    got = pcal.load_act_scales(pcal.calibration_config().models)
    assert got == {k: float(v) for k, v in want.items()}
    assert len(got) == 44
    assert got == jcal.load_act_scales(jcal.calibration_config().models)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_load_act_scales_never_raises(tmp_path):
    """A missing or corrupt artifact and an unmatched config each log and
    return None (dynamic scales), as the reference's loader does."""
    m = pcal.calibration_config().models
    other = dataclasses.replace(m, unet=dataclasses.replace(
        m.unet, base_channels=64))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    records = _Records()
    pcal.log.addHandler(records)
    try:
        assert pcal.load_act_scales(m, str(tmp_path / "none.json")) is None
        assert pcal.load_act_scales(m, str(bad)) is None
        assert pcal.load_act_scales(other) is None
    finally:
        pcal.log.removeHandler(records)
    assert sum("dynamic activation scales" in m
               for m in records.messages) == 3


def test_the_recorder_and_its_site_keys(ref_case):
    """Outside collect_act_stats a site records nothing; inside, the
    port's fp UNet (from the reference's weights) records exactly the
    reference's site keys: its QDense and fused-conv sites."""
    cfg = pcal.calibration_config()
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=ref_case["sd"])
    assert not quant.act_stats_active()
    quant.note_act_stat("x", torch.ones(2))            # no sink: a no-op
    with quant.collect_act_stats(pipe.unet) as sink:
        assert quant.act_stats_active()
        quant.note_act_stat(None, torch.ones(2))      # not a site
        with quant.collect_act_stats() as inner:
            pass
        assert inner == {} and quant.act_stats_active()
        lat = torch.zeros(1, 8, 8, 4)
        with torch.inference_mode():
            pipe.unet(lat, torch.tensor([5]), torch.zeros(
                1, 8, cfg.models.unet.context_dim))
    assert not quant.act_stats_active()
    assert set(sink) == set(ref_case["stats"])
    assert quant.act_site(pipe.unet.time_fc1) is None


def test_collect_unet_stats_matches_the_reference(ref_case):
    stats = pcal.collect_unet_stats(pcal.calibration_config(), device="cpu",
                                    state_dicts=ref_case["sd"])
    ref = ref_case["stats"]
    assert set(stats) == set(ref)
    for k, v in ref.items():
        assert stats[k] == pytest.approx(v, rel=1e-4), k
    with pytest.raises(AssertionError, match="unmodified fp path"):
        cfg = pcal.calibration_config()
        pcal.collect_unet_stats(cfg.replace(models=dataclasses.replace(
            cfg.models, unet_w8a8=True)), device="cpu")


def test_emit_then_serve_static_scales(ref_case, tmp_path, monkeypatch):
    """``emit`` writes a signed artifact where it is told; pointed at it,
    a W8A8 build of the same geometry is ``w8a8_calibrated`` with each
    site's scale absmax / 127 of the emitted value, as the reference's
    tree transform folds it; ``main --emit`` writes one too, by default
    to ``EMIT_PATH``, never to the committed file."""
    out = str(tmp_path / "scales.json")
    art = pcal.emit(out, device="cpu", state_dicts=ref_case["sd"])
    entry = art["entries"]["unet"]
    assert entry["signature"] == pcal.calibration_signature(
        pcal.calibration_config().models, entry["prompts_digest"])
    monkeypatch.setattr(pcal, "ACT_SCALES_PATH", out)
    cfg = pcal.calibration_config()
    cfg = cfg.replace(models=dataclasses.replace(cfg.models, unet_w8a8=True))
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=ref_case["sd"])
    assert quant.w8a8_calibrated(pipe.unet)
    for name, m in pipe.unet.named_modules():
        q = quant.quantized_weight(m)
        if q is None:
            continue
        want = jq.act_scale_from_absmax(entry["scales"][quant.site_key(
            tuple(name.split(".")))])
        assert float(q.act_scale) == float(np.asarray(want)), name
    monkeypatch.setattr(pcal, "EMIT_PATH", str(tmp_path / "m.json"))
    assert pcal.main(["--emit", "--platform", "cpu"]) == 0
    assert json.loads((tmp_path / "m.json").read_text())["entries"]["unet"][
        "signature"] == entry["signature"]
    assert pcal.main([]) == 2
