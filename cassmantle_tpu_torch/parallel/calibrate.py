"""Activation-scale calibration for W8A8 serving.

Port of ``cassmantle_tpu/parallel/calibrate.py``. The int8 W8A8 kernels
scale activations before quantizing. Dynamic mode takes absmax on the
device at each dispatch (one more read of the activation); static mode
folds a calibrated per-site scale into the quantized weights at build.
This module is where static scales come from.

The pass runs the first :data:`NUM_CALIBRATION_PROMPTS` seed titles
(``data/seeds.txt``) through the fp UNet EAGERLY at
:data:`CALIBRATION_TIMESTEPS`, on latents from the reference's PRNG keys
(``utils/jax_random.py``), and collects each site's activation absmax
through the recorder (``ops/quant.py::collect_act_stats``). Site keys are
the reference's Flax module paths, the keys ``ops/quant.py::w8a8_modules``
folds scales in by.

The artifact ``data/act_scales.json`` is gated by a signature: a digest
of the UNet's architecture, the text tower's config and the prompt set,
equal to the reference's for the same config. Serving loads an entry only
when its signature matches (:func:`load_act_scales`); otherwise it logs
and serves dynamic scales. The committed entry was emitted by the
reference at ``calibration_config()`` (the tiny test geometry). The file
is read here and never written: ``--emit`` writes to ``--out`` (default
:data:`EMIT_PATH`, in the package's git-ignored ``_build/``), and serving
reads an emitted artifact where ``ACT_SCALES_PATH`` is pointed at it.

    python -m cassmantle_tpu_torch.parallel.calibrate --emit [--out PATH]
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional, Sequence

import torch

from cassmantle_tpu_torch.utils.logging import get_logger

log = get_logger("calibrate")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the artifact serving reads (looked up at each call, so a caller may
#: point it elsewhere)
ACT_SCALES_PATH = os.path.join(_REPO_ROOT, "data", "act_scales.json")
#: where ``main --emit`` writes without ``--out``: never the committed file
EMIT_PATH = os.path.join(_REPO_ROOT, "cassmantle_tpu_torch", "_build",
                         "act_scales.json")

#: prompts per calibration pass
NUM_CALIBRATION_PROMPTS = 8

#: denoise timesteps sampled per prompt: a spread across the schedule
CALIBRATION_TIMESTEPS = (981, 661, 341, 21)


def calibration_prompts(n: int = NUM_CALIBRATION_PROMPTS) -> list:
    """The first ``n`` seed titles (the game's own content)."""
    from cassmantle_tpu_torch.server.assets import load_seeds

    return list(load_seeds())[:n]


def prompts_digest(prompts: Sequence[str]) -> str:
    return hashlib.sha256("\n".join(prompts).encode()).hexdigest()[:16]


def calibration_signature(models_cfg, prompts_dig: str) -> str:
    """What gates an entry to a config: the UNet's architecture, the text
    tower's config and the prompt set's digest (the reference's digest of
    the same values)."""
    from cassmantle_tpu_torch.obs.costmodel import _digest

    return _digest("act_scales", models_cfg.unet.arch(),
                   models_cfg.clip_text, prompts_dig)


def calibration_config():
    """The config of the committed entry: the tiny test geometry with the
    fused conv on (W8A8's conv sites ride it) and no site floor."""
    from cassmantle_tpu_torch.config import test_config

    base = test_config()
    m = base.models
    return dataclasses.replace(base, models=dataclasses.replace(
        m, unet=dataclasses.replace(m.unet, fused_conv=True),
        w8a8_min_size=0))


def collect_unet_stats(cfg, weights_dir: Optional[str] = None,
                       prompts: Optional[Sequence[str]] = None,
                       timesteps: Sequence[int] = CALIBRATION_TIMESTEPS,
                       device="cuda", state_dicts=None, pipe=None
                       ) -> Dict[str, float]:
    """Per-site activation absmax of the image UNet: eager fp forwards of
    the calibration prompts at each timestep, the latents drawn from
    ``PRNGKey(i)`` for the i-th timestep. ``pipe`` (a built
    ``Text2ImagePipeline`` of ``cfg``) is used as it is; otherwise one is
    built on ``device`` from ``weights_dir`` / ``state_dicts``."""
    from cassmantle_tpu_torch.ops import quant
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline
    from cassmantle_tpu_torch.utils import jax_random

    m = cfg.models
    if m.unet_w8a8 or m.lm_w8a8:
        raise AssertionError(
            "calibration runs the unmodified fp path; strip the w8a8 flags "
            "from the config first (they would quantize the very "
            "activations being measured)")
    prompts = list(prompts if prompts is not None
                   else calibration_prompts())
    if pipe is None:
        pipe = Text2ImagePipeline(cfg, device, state_dicts, weights_dir)
    dev = pipe.device
    lat_hw = cfg.sampler.image_size // pipe.vae_scale
    with torch.inference_mode():
        # the context outside the recorder: CLIP's own sites stay out
        ctx = pipe.clip(pipe._tokenize(prompts))["hidden"]
        with quant.collect_act_stats(pipe.unet) as stats:
            for i, t in enumerate(timesteps):
                lat = jax_random.normal(
                    jax_random.PRNGKey(i),
                    (len(prompts), lat_hw, lat_hw, 4)).to(dev)
                tvec = torch.full((len(prompts),), int(t),
                                  dtype=torch.int32, device=dev)
                pipe.unet(lat, tvec, ctx)
    return dict(stats)


def emit(path: str, cfg=None, weights_dir: Optional[str] = None,
         device="cuda", state_dicts=None, pipe=None) -> dict:
    """Run the calibration pass and write the signed artifact to
    ``path``."""
    cfg = cfg or calibration_config()
    prompts = calibration_prompts()
    dig = prompts_digest(prompts)
    stats = collect_unet_stats(cfg, weights_dir, prompts, device=device,
                               state_dicts=state_dicts, pipe=pipe)
    artifact = {
        "version": 1,
        "generated_by": "python -m cassmantle_tpu_torch.parallel.calibrate "
                        "--emit",
        "note": "per-site activation absmax from EAGER fp forwards over "
                "the calibration prompt set (module docstring); scales "
                "derive as absmax/qmax at load (ops/quant.py "
                "act_scale_from_absmax).",
        "entries": {
            "unet": {
                "signature": calibration_signature(cfg.models, dig),
                "prompts_digest": dig,
                "num_prompts": len(prompts),
                "timesteps": list(CALIBRATION_TIMESTEPS),
                "scales": {k: float(v) for k, v in sorted(stats.items())},
            },
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    log.info("wrote %s: %d sites, signature %s", path, len(stats),
             artifact["entries"]["unet"]["signature"])
    return artifact


def load_act_scales(models_cfg, path: Optional[str] = None
                    ) -> Optional[Dict[str, float]]:
    """The site -> absmax map of the artifact's entry whose signature
    matches this config, else None (serving then scales dynamically).
    Never raises: a missing or corrupt artifact logs and serves dynamic
    scales."""
    path = path or ACT_SCALES_PATH
    try:
        with open(path) as f:
            artifact = json.load(f)
        entries = artifact.get("entries", {})
        for entry in entries.values():
            if not isinstance(entry, dict):
                continue
            expect = calibration_signature(
                models_cfg, str(entry.get("prompts_digest")))
            if entry.get("signature") == expect:
                scales = entry.get("scales") or {}
                return {str(k): float(v) for k, v in scales.items()}
    except Exception:
        log.warning(
            "w8a8: no readable calibration artifact at %s; dynamic "
            "activation scales; rebuild with `python -m "
            "cassmantle_tpu_torch.parallel.calibrate --emit`", path)
        return None
    log.warning(
        "w8a8: no calibration entry in %s matches this model config; "
        "dynamic activation scales; rebuild with `python -m "
        "cassmantle_tpu_torch.parallel.calibrate --emit`", path)
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emit", action="store_true",
                    help="run the calibration pass and write the signed "
                         "artifact")
    ap.add_argument("--out", default=None,
                    help=f"where the artifact is written (default "
                         f"{os.path.relpath(EMIT_PATH, _REPO_ROOT)})")
    ap.add_argument("--weights-dir", default=None,
                    help="checkpoint dir (seeded init when absent)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="the device the fp forwards run on")
    args = ap.parse_args(argv)
    if not args.emit:
        ap.print_help()
        return 2
    emit(args.out or EMIT_PATH, weights_dir=args.weights_dir,
         device=args.platform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
