"""The brownout ladder of the port against the reference, on the CPU.

- The ladder: the same verdict sequence under the same fake clock drives
  both packages' ``BrownoutLadder`` (each with its own registry and
  recorder), and the tier after every step, the trip and recovery counts
  and the recorded transitions are equal: dwell, hysteresis, watched
  objectives, the kill switch and the chaos flap.
- ``degraded_sampler_cfg`` on the nine presets x six tiers, with
  ``consistency_available`` both ways and under
  ``CASSMANTLE_NO_CONSISTENCY``: equal fields.
- ``quantize_blur_radius`` and ``blur_bucket_px`` at every tier.
- The pipelines at a tier, eager on the CPU at ``test_config()`` sizes:
  ``Text2ImagePipeline`` and ``SDXLPipeline`` at tiers 1 and 4,
  against the reference's degraded denoise (its ``degraded_sampler_cfg``
  and ``run_cfg_denoise``) from the same numpy x_T at the tier's size:
  within 2 levels everywhere and 0.5 on average, the tolerance of the
  untiered images (``test_torch_port_slice.py``, ``test_torch_port_sdxl.py``).
- Tier 0 bit-equal to the untiered port before and after the ladder
  moved; one cached variant per key; a delta the config cannot take
  counts ``pipeline.brownout_delta_unusable`` and serves full quality,
  while a ``RuntimeError`` raised inside a tier's denoise propagates.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu import config as jconfig
from cassmantle_tpu.models.clip_text import ClipTextEncoder as JClip
from cassmantle_tpu.models.unet import UNet as JUNet
from cassmantle_tpu.models.vae import VAEDecoder as JVAE
from cassmantle_tpu.models.vae import postprocess_images as jax_postprocess
from cassmantle_tpu.obs.recorder import FlightRecorder as JRecorder
from cassmantle_tpu.ops.samplers import make_sampler as jax_make_sampler
from cassmantle_tpu.serving import overload as joverload
from cassmantle_tpu.serving.pipeline import run_cfg_denoise as jax_denoise
from cassmantle_tpu.serving.pipeline import tokenize_clip_prompts as jax_tok
from cassmantle_tpu.serving.sdxl import SDXLPipeline as JSDXL
from cassmantle_tpu.utils.logging import Metrics as JMetrics
from cassmantle_tpu.utils.tokenizers import load_tokenizer as jax_tokenizer
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch import config as pconfig
from cassmantle_tpu_torch.models.weights import from_jax
from cassmantle_tpu_torch.obs.recorder import FlightRecorder as PRecorder
from cassmantle_tpu_torch.serving import overload as poverload
from cassmantle_tpu_torch.serving import pipeline as ppipeline
from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
from cassmantle_tpu_torch.serving.sdxl import SDXLPipeline
from cassmantle_tpu_torch.utils.logging import Metrics as PMetrics
from cassmantle_tpu_torch.utils.logging import metrics as pmetrics

from _torch_port_common import jax_params, randn

PROMPTS = ["A watercolor style piece depicting: a lighthouse at dusk.",
           "A vaporwave style piece depicting: the comet market."]
PRESETS = ("FrameworkConfig", "fusedconv_serving_config",
           "w8a8_serving_config", "sdxl_config", "encprop_serving_config",
           "deepcache_serving_config", "fast_serving_config",
           "turbo_serving_config", "lcm_serving_config")
PACKAGES = {"reference": (joverload, jchaos, JMetrics, JRecorder),
            "port": (poverload, pchaos, PMetrics, PRecorder)}


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def verdict(state, name="score_latency"):
    return {name: {"state": state, "fast_burn": 5.0 if state == "burning"
                   else 0.1, "slow_burn": 0.2}}


# (seconds to advance, verdicts, env CASSMANTLE_NO_BROWNOUT, chaos spec)
# per step: trips per dwell, one rung per dwell, a burn mid-recovery, an
# unwatched objective, the kill switch mid-flight, and a chaos flap
LADDER_SCRIPT = (
    [(0.0, verdict("burning"), None, None)]
    + [(1.1, verdict("burning"), None, None)] * 3
    + [(0.0, verdict("ok"), None, None), (3.1, verdict("ok"), None, None),
       (1.5, verdict("burning"), None, None), (1.5, verdict("ok"), None,
                                               None),
       (3.1, verdict("ok"), None, None)]
    + [(1.1, verdict("burning", "replication_lag"), None, None)] * 3
    + [(1.1, verdict("burning"), None, None)] * 3
    + [(0.0, verdict("burning"), "1", None), (1.1, verdict("burning"),
                                              None, None)]
    + [(0.0, verdict("ok"), None, "overload.brownout=raise:times=2")] * 3
    + [(3.1, verdict("ok"), None, None)] * 4
    + [(1.1, verdict("burning"), None, None)] * 8
    + [(3.1, verdict("ok"), None, None)] * 8
)


def _ladder_transcript(package, monkeypatch):
    overload, chaos, metrics_cls, recorder_cls = PACKAGES[package]
    clock, registry, recorder = FakeClock(), metrics_cls(), recorder_cls()
    ladder = overload.BrownoutLadder(
        overload.DEFAULT_TIERS, objectives=("score_latency",),
        step_up_dwell_s=1.0, step_down_dwell_s=3.0, clock=clock,
        registry=registry, recorder=recorder)
    out = []
    try:
        for advance, verdicts, env, spec in LADDER_SCRIPT:
            clock.t += advance
            if env:
                monkeypatch.setenv("CASSMANTLE_NO_BROWNOUT", env)
            else:
                monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
            if spec and not chaos.armed():
                chaos.configure(spec)
            elif not spec:
                chaos.disarm()
            ladder.on_slo_eval(verdicts)
            out.append((ladder.tier(), ladder.status()))
    finally:
        chaos.disarm()
    events = [{k: v for k, v in e.items() if k not in ("t", "ts", "seq")}
              for e in recorder.tail()]
    return out, {name: registry.counter_total(name) for name in (
        "overload.brownout_trips", "overload.brownout_recoveries")}, \
        registry.gauge_values("overload.brownout_tier"), events


def test_ladder_trajectory_matches_reference(monkeypatch):
    ref = _ladder_transcript("reference", monkeypatch)
    port = _ladder_transcript("port", monkeypatch)
    assert port == ref
    tiers = [t for t, _ in port[0]]
    # the script reaches the top, pins to 0, flaps and recovers
    assert max(tiers) == len(poverload.DEFAULT_TIERS) - 1
    assert 0 in tiers[12:] and port[1]["overload.brownout_trips"] > 5


def _preset(module, name):
    return getattr(module, name)()


@pytest.mark.parametrize("no_consistency", [False, True])
@pytest.mark.parametrize("available", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_degraded_sampler_cfg_matches_reference(preset, available,
                                                no_consistency, monkeypatch):
    """Every tier's degraded config: every field the port keeps equals
    the reference's."""
    if no_consistency:
        monkeypatch.setenv("CASSMANTLE_NO_CONSISTENCY", "1")
    else:
        monkeypatch.delenv("CASSMANTLE_NO_CONSISTENCY", raising=False)
    jcfg, pcfg = _preset(jconfig, preset), _preset(pconfig, preset)
    js = dataclasses.replace(jcfg.sampler, consistency_available=available)
    ps = dataclasses.replace(pcfg.sampler, consistency_available=available)
    for jtier, ptier in zip(joverload.DEFAULT_TIERS,
                            poverload.DEFAULT_TIERS):
        assert dataclasses.asdict(jtier) == dataclasses.asdict(ptier)
        want = joverload.degraded_sampler_cfg(js, jtier)
        got = poverload.degraded_sampler_cfg(ps, ptier)
        for field in dataclasses.fields(got):
            assert getattr(got, field.name) == getattr(want, field.name), (
                ptier.name, field.name)
        assert (got == ps) == (want == js)


def _at_tier(overload, tier, monkeypatch):
    ladder = overload.BrownoutLadder(overload.DEFAULT_TIERS, clock=FakeClock(),
                                     registry=type(overload.metrics)())
    with ladder._lock:
        ladder._tier = tier
    monkeypatch.setattr(overload, "_LADDER", ladder)
    return ladder


@pytest.mark.parametrize("tier", range(6))
def test_blur_buckets_match_reference(tier, monkeypatch):
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    radii = [0.0, 0.2, 0.24, 0.26, 0.6, 0.9, 1.0, 1.3, 2.0, 2.1, 3.75, 7.5,
             14.99, 15.0]
    _at_tier(joverload, tier, monkeypatch)
    _at_tier(poverload, tier, monkeypatch)
    assert poverload.blur_bucket_px() == joverload.blur_bucket_px()
    assert poverload.current_tier() == joverload.current_tier() == tier
    got = [poverload.quantize_blur_radius(r) for r in radii]
    assert got == [joverload.quantize_blur_radius(r) for r in radii]
    if tier == 5:                       # coarse buckets round up only
        assert all(g >= r for g, r in zip(got, radii))
    advert = poverload.peer_advert()
    assert advert.get("btier", 0) == tier
    assert poverload.status_block()["brownout"]["tier"] == tier


# -- the pipelines at a tier ---------------------------------------------------

@pytest.fixture(scope="module")
def sd15():
    """Reference parameters of the tiny SD1.5 slice and its token ids."""
    cfg = jconfig.test_config()
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions)
    ids = jnp.asarray(jax_tok(tok, PROMPTS, pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt] * len(PROMPTS), pad,
                               m.clip_text.vocab_size))
    x = jnp.zeros((2, 32, 32, 4))
    params = {
        "clip_text": jax_params(JClip(m.clip_text), 52, ids),
        "unet": jax_params(JUNet(m.unet), 53, x, jnp.zeros((2,), jnp.int32),
                           jnp.zeros((2, pad, m.unet.context_dim))),
        "vae": jax_params(JVAE(m.vae), 54, x),
    }
    clip = JClip(m.clip_text)
    ctx = clip.apply(params["clip_text"], ids)["hidden"]
    uctx = clip.apply(params["clip_text"], uids)["hidden"]
    sd = {k: from_jax(k, v) for k, v in params.items()}
    return {"params": params, "ctx": ctx, "uctx": uctx, "sd": sd}


def _ref_images(cfg, params, ctx, uctx, x_t, tier, **add):
    """The reference's tier dispatch from ``x_t``: its degraded config,
    its sampler and ``run_cfg_denoise``, the VAE and uint8."""
    scfg = joverload.degraded_sampler_cfg(cfg.sampler,
                                          joverload.DEFAULT_TIERS[tier])
    sampler = (None if scfg.consistency else
               jax_make_sampler(scfg.kind, scfg.num_steps, eta=scfg.eta))
    m = cfg.models
    final = jax_denoise(scfg, sampler, None, JUNet(m.unet).apply,
                        params["unet"], ctx, uctx, jnp.asarray(x_t), **add)
    return np.asarray(jax_postprocess(JVAE(m.vae).apply(params["vae"],
                                                        final))), scfg


def _assert_close_images(images, ref):
    assert images.dtype == np.uint8 and images.shape == ref.shape
    diff = np.abs(images.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert diff.mean() <= 0.5, diff.mean()


def _x_t(seed, size, vae_scale=2):
    hw = size // vae_scale
    return randn(np.random.default_rng(seed), len(PROMPTS), hw, hw, 4)


@pytest.mark.parametrize("tier", [1, 4])
def test_t2i_tier_images_match_reference(sd15, tier, monkeypatch):
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    jcfg, pcfg = jconfig.test_config(), pconfig.test_config()
    scfg = poverload.degraded_sampler_cfg(pcfg.sampler,
                                          poverload.DEFAULT_TIERS[tier])
    x_t = _x_t(60 + tier, scfg.image_size)
    ref, jscfg = _ref_images(jcfg, sd15["params"], sd15["ctx"],
                             sd15["uctx"], x_t, tier)
    assert (jscfg.num_steps, jscfg.image_size, jscfg.consistency) == (
        scfg.num_steps, scfg.image_size, scfg.consistency)
    pipe = Text2ImagePipeline(pcfg, device="cpu", state_dicts=sd15["sd"])
    _at_tier(poverload, tier, monkeypatch)
    before = pmetrics.counter_total("pipeline.brownout_images")
    images = pipe.generate(PROMPTS, latents=torch.from_numpy(x_t))
    _assert_close_images(images, ref)
    assert images.shape[1] == scfg.image_size
    assert list(pipe.tier_variants) == [ppipeline.tier_key(scfg)]
    assert pmetrics.counter_total("pipeline.brownout_images") - before == 2


@pytest.fixture(scope="module")
def sdxl():
    cfg = jconfig.test_sdxl_config()
    m, s = cfg.models, cfg.sampler
    tok = jax_tokenizer(None, "clip", m.clip_text.vocab_size)
    pad = min(s.prompt_pad_len, m.clip_text.max_positions,
              m.clip_text_2.max_positions)
    ids = jnp.asarray(jax_tok(tok, PROMPTS, pad, m.clip_text.vocab_size))
    uids = jnp.asarray(jax_tok(tok, [s.negative_prompt] * len(PROMPTS), pad,
                               m.clip_text.vocab_size))
    x = jnp.zeros((2, 32, 32, 4))
    params = {
        "clip": jax_params(JClip(m.clip_text), 72, ids),
        "clip2": jax_params(JClip(m.clip_text_2), 73, ids),
        "unet": jax_params(JUNet(m.unet), 74, x, jnp.zeros((2,), jnp.int32),
                           jnp.zeros((2, pad, m.unet.context_dim)),
                           jnp.zeros((2, m.unet.addition_embed_dim))),
        "vae": jax_params(JVAE(m.vae), 75, x),
    }
    ns = types.SimpleNamespace(
        cfg=cfg, clip=JClip(m.clip_text), clip2=JClip(m.clip_text_2),
        clip2_proj=None,
        time_id_dim=(m.unet.addition_embed_dim
                     - m.clip_text_2.hidden_size) // 6)
    jp = dict(params, clip2_proj=None)
    ctx, pooled = JSDXL._encode(ns, jp, ids)
    uctx, upooled = JSDXL._encode(ns, jp, uids)
    sd = {"clip_text": from_jax("clip_text", params["clip"]),
          "clip_text_2": from_jax("clip_text_2", params["clip2"]),
          "unet": from_jax("unet_xl", params["unet"]),
          "vae": from_jax("vae_xl", params["vae"])}
    return {"cfg": cfg, "params": params, "ns": ns, "ctx": ctx,
            "uctx": uctx, "pooled": pooled, "upooled": upooled, "sd": sd}


@pytest.mark.parametrize("tier", [1, 4])
def test_sdxl_tier_images_match_reference(sdxl, tier, monkeypatch):
    """The micro-conditioning's time ids follow the tier's size."""
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    jcfg, pcfg = sdxl["cfg"], pconfig.test_sdxl_config()
    scfg = poverload.degraded_sampler_cfg(pcfg.sampler,
                                          poverload.DEFAULT_TIERS[tier])
    x_t = _x_t(80 + tier, scfg.image_size)
    time_ids = JSDXL._time_ids(sdxl["ns"], len(PROMPTS), scfg.image_size)
    add = {"addition_embeds": jnp.concatenate([sdxl["pooled"], time_ids],
                                              axis=-1),
           "uncond_addition_embeds": jnp.concatenate(
               [sdxl["upooled"], time_ids], axis=-1)}
    ref, _ = _ref_images(jcfg, {"unet": sdxl["params"]["unet"],
                                "vae": sdxl["params"]["vae"]},
                         sdxl["ctx"], sdxl["uctx"], x_t, tier, **add)
    pipe = SDXLPipeline(pcfg, device="cpu", state_dicts=sdxl["sd"])
    _at_tier(poverload, tier, monkeypatch)
    images = pipe.generate(PROMPTS, latents=torch.from_numpy(x_t))
    _assert_close_images(images, ref)
    if tier == 4:      # the conditioning at the tier's size, not 64
        assert scfg.image_size != pcfg.sampler.image_size


def test_tier_zero_is_the_untiered_path_and_variants_cache(sd15,
                                                           monkeypatch):
    """Tier 0 (and a ladder back at 0) serves bit for bit the pipeline
    with no ladder; tiers 4 and 5 share one variant (5 only coarsens the
    blur), built once."""
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    cfg = pconfig.test_config()
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd15["sd"])
    poverload.reset_brownout()
    plain = pipe.generate(PROMPTS, seed=3)
    ladder = _at_tier(poverload, 0, monkeypatch)
    np.testing.assert_array_equal(pipe.generate(PROMPTS, seed=3), plain)
    for tier in (4, 5, 4):
        with ladder._lock:
            ladder._tier = tier
        assert pipe.generate(PROMPTS, seed=3).shape[1] == 32
    assert len(pipe.tier_variants) == 1
    (variant,) = pipe.tier_variants.values()
    assert variant is pipe.tier_variant(poverload.DEFAULT_TIERS[5])
    with ladder._lock:
        ladder._tier = 0
    np.testing.assert_array_equal(pipe.generate(PROMPTS, seed=3), plain)
    assert pipe.tier_variant(None) is None


def test_unusable_delta_counts_and_device_faults_propagate(sd15,
                                                           monkeypatch):
    """A student declared with a teacher grid the few-step tier cannot
    take (4 teacher steps for 4 student steps): its plan raises before
    any device work, so the tier serves full quality and counts
    ``pipeline.brownout_delta_unusable``. A RuntimeError inside a tier's
    denoise (a kernel that fails to launch) propagates uncounted."""
    monkeypatch.delenv("CASSMANTLE_NO_BROWNOUT", raising=False)
    monkeypatch.delenv("CASSMANTLE_NO_CONSISTENCY", raising=False)
    base = pconfig.test_config()
    cfg = base.replace(sampler=dataclasses.replace(
        base.sampler, consistency_available=True,
        consistency_teacher_steps=4))
    pipe = Text2ImagePipeline(cfg, device="cpu", state_dicts=sd15["sd"])
    full = pipe.generate(PROMPTS, seed=5)
    _at_tier(poverload, 3, monkeypatch)
    count = "pipeline.brownout_delta_unusable"
    before = pmetrics.counter_total(count)
    np.testing.assert_array_equal(pipe.generate(PROMPTS, seed=5), full)
    assert pmetrics.counter_total(count) - before == 1
    assert not pipe.tier_variants

    _at_tier(poverload, 1, monkeypatch)

    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(ppipeline, "sample_spec", fault)
    with pytest.raises(RuntimeError, match="launch failure"):
        pipe.generate(PROMPTS, seed=5)
    assert pmetrics.counter_total(count) - before == 1
