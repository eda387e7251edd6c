"""CLIP-similarity report across the serving presets: the quality gate.

Port of the reference's ``tools/clip_report.py``. The fast presets count
as wins only if their images score on par with DDIM-50 under CLIP. Each
preset generates the same eight prompts (``--seeds`` batches), each image
is scored against its prompt with ``eval/clip_parity.py``'s harness, and
one JSON report gives each preset's mean, its ratio to the ddim50 anchor
and the gate's verdict (``config.py::QualityGateConfig``).

``real_weights`` is false when any CLIP stage or any pipeline stage came
from the seeded init: such a run checks the plumbing only, its gate is
advisory (``gate_enforced`` false) unless ``--enforce``, and it is not a
quality number. The pipelines of one architecture share their weights
through the seeded init of one seed (or the same files).

Usage:
    python -m cassmantle_tpu_torch clip-report [--weights DIR]
        [--out PATH] [--platform cuda|cpu] [--seeds N] [--tiny]
        [--presets ddim50,dpmpp25,deepcache,turbo,int8,encprop] [--enforce]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
# reports land in the git-ignored build directory
OUT_DIR = os.path.join(PACKAGE_DIR, "_build")

PROMPTS = [
    "A watercolor style piece depicting: a lighthouse over a stormy sea",
    "An art deco style piece depicting: a caravan crossing silver dunes",
    "A stained glass style piece depicting: an orchard under two moons",
    "A vaporwave style piece depicting: a night train between cities",
    "An ukiyo-e style piece depicting: cranes over a frozen river",
    "A chalk pastel style piece depicting: a market street in the rain",
    "A linocut style piece depicting: a fox asleep in a bell tower",
    "A gouache style piece depicting: terraced fields at first light",
]

DEFAULT_PRESETS = "ddim50,dpmpp25,deepcache,turbo,int8,encprop"


def _with_unet_int8(cfg):
    return cfg.replace(models=dataclasses.replace(cfg.models, unet_int8=True))


def preset_factories(tiny: bool) -> Dict[str, Callable]:
    """Preset name -> a config factory: the serving presets, or their
    tiny counterparts at ``test_config()`` geometry."""
    if tiny:
        from cassmantle_tpu_torch.config import test_config

        def tiny_kind(kind, **kw):
            def make():
                cfg = test_config()
                return cfg.replace(sampler=dataclasses.replace(
                    cfg.sampler, kind=kind, **kw))
            return make

        return {
            "ddim50": tiny_kind("ddim", num_steps=4),
            "dpmpp25": tiny_kind("dpmpp_2m", num_steps=2),
            "deepcache": tiny_kind("ddim", num_steps=4, deepcache=True),
            "turbo": tiny_kind("dpmpp_2m", num_steps=4, deepcache=True),
            "int8": lambda: _with_unet_int8(test_config()),
            "encprop": tiny_kind("ddim", num_steps=4, encprop=True,
                                 encprop_stride=2, encprop_dense_steps=0),
        }
    from cassmantle_tpu_torch.config import (
        FrameworkConfig,
        deepcache_serving_config,
        encprop_serving_config,
        fast_serving_config,
        turbo_serving_config,
    )

    return {
        "ddim50": FrameworkConfig,
        "dpmpp25": fast_serving_config,
        "deepcache": deepcache_serving_config,
        "turbo": turbo_serving_config,
        # DDIM-50's trajectory over the weights-only int8 UNet
        "int8": lambda: _with_unet_int8(FrameworkConfig()),
        # DDIM-50 with encoder propagation and the fused VAE decoder
        "encprop": encprop_serving_config,
    }


def apply_quality_gate(report: dict, gate_cfg=None) -> List[str]:
    """Annotate each gated preset with ``gate`` ({threshold or min_sim,
    passed}) and return the failures as text. Pure on the report."""
    if gate_cfg is None:
        from cassmantle_tpu_torch.config import FrameworkConfig

        gate_cfg = FrameworkConfig().quality
    failures = []
    anchor = report["presets"].get("ddim50")
    if anchor:
        floor = gate_cfg.ddim50_min_sim
        anchor["gate"] = {"min_sim": floor,
                          "passed": anchor["clip_sim_mean"] >= floor}
        if not anchor["gate"]["passed"]:
            failures.append(f"ddim50 anchor clip_sim_mean "
                            f"{anchor['clip_sim_mean']:.4f} < floor {floor}")
    for name, entry in report["presets"].items():
        threshold = gate_cfg.threshold_for(name)
        if threshold is None or "parity_vs_ddim50" not in entry:
            continue
        entry["gate"] = {"threshold": threshold,
                         "passed": entry["parity_vs_ddim50"] >= threshold}
        if not entry["gate"]["passed"]:
            failures.append(f"{name} parity_vs_ddim50 "
                            f"{entry['parity_vs_ddim50']:.4f} < {threshold}")
    return failures


def tiny_harness(device: str):
    from cassmantle_tpu_torch.config import ClipTextConfig
    from cassmantle_tpu_torch.eval.clip_parity import ClipSimilarityHarness
    from cassmantle_tpu_torch.models.clip_vision import ClipVisionConfig

    return ClipSimilarityHarness(
        text_cfg=ClipTextConfig(vocab_size=512, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, max_positions=16),
        vision_cfg=ClipVisionConfig.tiny(), weights_dir=None, pad_len=16,
        device=device)


def build_report(harness, factories: Dict[str, Callable],
                 wanted: List[str], seeds: int, device: str,
                 weights_dir: Optional[str]) -> dict:
    """Generate and score every wanted preset; each pipeline is dropped
    before the next is built."""
    from cassmantle_tpu_torch.serving.pipeline import Text2ImagePipeline

    report: dict = {"real_weights": harness.loaded_real_weights,
                    "prompts": len(PROMPTS), "seeds": seeds, "presets": {}}
    for name in wanted:
        pipe = Text2ImagePipeline(factories[name](), device=device,
                                  weights_dir=weights_dir)
        sims = []
        for seed in range(seeds):
            images = pipe.generate(PROMPTS, seed=seed)
            sims.extend(harness.similarity(images, PROMPTS).tolist())
        entry = {"clip_sim_mean": float(np.mean(sims)),
                 "clip_sim_std": float(np.std(sims)), "n": len(sims),
                 "pipeline_real_weights": bool(pipe.loaded_real_weights)}
        # the headline flag: the scorer AND every generator from files
        report["real_weights"] = (report["real_weights"]
                                  and entry["pipeline_real_weights"])
        report["presets"][name] = entry
        print(f"[clip_report] {name}: mean={entry['clip_sim_mean']:.4f} "
              f"std={entry['clip_sim_std']:.4f} n={entry['n']}", flush=True)
        del pipe
        gc.collect()
    anchor = report["presets"].get("ddim50")
    if anchor and anchor["clip_sim_mean"]:
        for name, entry in report["presets"].items():
            if name != "ddim50":
                entry["parity_vs_ddim50"] = float(
                    entry["clip_sim_mean"] / anchor["clip_sim_mean"])
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=os.path.join(REPO_ROOT, "weights"),
                    help="weights directory (used when it exists)")
    ap.add_argument("--out", default=None,
                    help="report path; defaults to _build/CLIP_REPORT.json "
                         "(CLIP_REPORT.tiny.json under --tiny)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--presets", default=DEFAULT_PRESETS)
    ap.add_argument("--seeds", type=int, default=2,
                    help="image batches per preset (n = seeds x 8 prompts)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny configs: a plumbing run, not a measurement")
    ap.add_argument("--enforce", action="store_true",
                    help="fail the gate on seeded weights too (tests the "
                         "enforcement path)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        OUT_DIR, "CLIP_REPORT.tiny.json" if args.tiny else "CLIP_REPORT.json")

    from cassmantle_tpu_torch.eval.clip_parity import ClipSimilarityHarness

    factories = preset_factories(args.tiny)
    wanted = [p.strip() for p in args.presets.split(",") if p.strip()]
    unknown = sorted(set(wanted) - set(factories))
    if unknown:
        print(f"unknown presets: {unknown}; have {sorted(factories)}",
              file=sys.stderr)
        return 2
    # tiny models never read a full-size checkpoint
    weights_dir = (None if args.tiny else
                   args.weights if os.path.isdir(args.weights) else None)
    harness = (tiny_harness(args.platform) if args.tiny else
               ClipSimilarityHarness(weights_dir=weights_dir,
                                     device=args.platform))
    report = build_report(harness, factories, wanted, args.seeds,
                          args.platform, weights_dir)
    # the thresholds hold whenever the report is a measurement; seeded
    # similarity is noise, so a plumbing run is advisory unless --enforce
    enforce = bool(report["real_weights"] or args.enforce)
    failures = apply_quality_gate(report)
    report["gate_enforced"] = enforce
    report["gate_failures"] = failures

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"[clip_report] wrote {out} (real_weights={report['real_weights']})",
          flush=True)
    if failures:
        verdict = "FAILED" if enforce else "advisory (seeded weights)"
        print(f"[clip_report] quality gate {verdict}:", file=sys.stderr)
        for line in failures:
            print(f"[clip_report]   {line}", file=sys.stderr)
        if enforce:
            return 2
    elif "ddim50" in report["presets"]:
        print(f"[clip_report] quality gate passed "
              f"({'enforced' if enforce else 'advisory'})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
