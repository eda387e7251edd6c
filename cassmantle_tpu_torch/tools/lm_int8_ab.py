"""A/B of weights-only int8 against the fp prompt LM's decode.

Port of the reference's ``tools/lm_int8_ab.py``: the same LM family built
twice, fp (``param_dtype`` storage) and weights-only int8
(``ops/quant.py``), the same fixed-length greedy decodes through the
serving ``PromptGenerator``, and one JSON line: tokens/s, ms a token,
tensor bytes and each arm's weight-read bound at the card's memory rate,
peak device memory and the decode graph's pool. Each arm runs in its own
child process, so one arm's peak is not charged to the other.
``real_weights`` is true only when both arms loaded
their weights from checkpoints: a decode of seeded weights is never
labelled a real-weights number.

    python -m cassmantle_tpu_torch lm-int8-ab [--family gpt2|mistral]
        [--tokens 64] [--reps 3] [--weights DIR] [--platform cuda|cpu]
        [--tiny] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

SEED_TEXT = "The lighthouse keeper counted the storms of"
#: the H100 SXM's HBM3 rate (data sheet), bytes/s: the weight-read bound
PEAK_BYTES_PER_S = 3.35e12


def build_cfg(family: str, tiny: bool, int8: bool):
    from cassmantle_tpu_torch.config import (
        FrameworkConfig,
        MistralConfig,
        test_config,
    )

    cfg = test_config() if tiny else FrameworkConfig()
    models = cfg.models
    if family == "mistral":
        models = dataclasses.replace(
            models, mistral=MistralConfig.tiny() if tiny else MistralConfig())
    return cfg.replace(models=dataclasses.replace(models, lm_int8=int8))


def _decode_state(gen):
    """The captured greedy decode of the last generate (None on the CPU)."""
    return next((s for s in gen.decode_graphs.values()
                 if getattr(s, "graph", None) is not None), None)


def measure_arm(gen, tokens: int = 64, reps: int = 3) -> dict:
    """Fixed-length greedy decodes of :data:`SEED_TEXT` through ``gen``:
    a warm-up (the capture on the card), then ``reps`` timed decodes; on
    the card also the captured step's ms a token between CUDA events."""
    import torch

    from cassmantle_tpu_torch.ops.quant import int8_site_count

    cuda = gen.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(gen.device)
    text = gen.generate(SEED_TEXT, max_new_tokens=tokens)
    t0 = time.perf_counter()
    for _ in range(reps):
        text = gen.generate(SEED_TEXT, max_new_tokens=tokens)
    decode_s = (time.perf_counter() - t0) / reps
    out = {"tokens_per_sec": tokens / decode_s, "decode_s": decode_s,
           "decode_ms_per_token": decode_s / tokens * 1e3,
           "param_bytes": gen.param_bytes,
           "quantized_leaves": int8_site_count(gen.model),
           "weight_read_bound_ms_per_token":
               gen.param_bytes / PEAK_BYTES_PER_S * 1e3,
           "real_weights": bool(gen.loaded_real_weights),
           "sample_chars": len(text)}
    state = _decode_state(gen) if cuda else None
    if state is not None:
        steps = max(1, state.max_new - 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            # replays from step 0 (the last decode left the counter at
            # its end; the values replayed over do not matter for time)
            state.step_index.zero_()
            start.record()
            for _ in range(steps):
                state.graph.replay()
            end.record()
            torch.cuda.synchronize()
        out["graph_ms_per_token"] = start.elapsed_time(end) / steps
        out["graph_pool_mb"] = state.graph.pool_bytes / 2 ** 20
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(gen.device) / 2 ** 30
    return out


def report(fp: dict, q8: dict, family: str, tokens: int, tiny: bool) -> dict:
    """The A/B line from each arm's :func:`measure_arm` (or its error)."""
    rep = {"metric": f"lm_int8_decode_ab_{family}", "family": family,
           "tokens": tokens, "tiny": tiny, "fp": fp, "int8": q8,
           # a real-weights A/B needs both arms from checkpoints
           "real_weights": bool(fp.get("real_weights")
                                and q8.get("real_weights"))}
    if "tokens_per_sec" in fp and "tokens_per_sec" in q8:
        rep["speedup"] = q8["tokens_per_sec"] / fp["tokens_per_sec"]
    if fp.get("param_bytes") and "param_bytes" in q8:
        rep["param_shrink"] = q8["param_bytes"] / fp["param_bytes"]
    return rep


def _run_arm(args, int8: bool) -> dict:
    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    gen = PromptGenerator(build_cfg(args.family, args.tiny, int8),
                          device=args.platform, weights_dir=args.weights)
    return measure_arm(gen, args.tokens, args.reps)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cassmantle_tpu_torch lm-int8-ab",
        description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="gpt2", choices=("gpt2", "mistral"))
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="tiny dims (plumbing, not a measurement)")
    ap.add_argument("--out", default=None,
                    help="also write the report line to this file")
    ap.add_argument("--arm", default=None, choices=("fp", "int8"),
                    help=argparse.SUPPRESS)      # a child: one arm
    args = ap.parse_args(argv)
    if args.weights is not None and not os.path.isdir(args.weights):
        ap.error(f"--weights {args.weights!r} is not a directory")
    if args.arm:
        print(json.dumps(_run_arm(args, args.arm == "int8")))
        return 0
    arms = {}
    for arm in ("fp", "int8"):
        child = [sys.executable, "-m", "cassmantle_tpu_torch.tools.lm_int8_ab",
                 "--arm", arm] + list(argv if argv is not None
                                      else sys.argv[1:])
        proc = subprocess.run(child, capture_output=True, text=True,
                              timeout=3600)
        if proc.returncode != 0:      # an OOM of the fp arm is a result
            arms[arm] = {"error": proc.stderr[-800:]}
        else:
            arms[arm] = json.loads(proc.stdout.splitlines()[-1])
        print(f"[lm_int8_ab] {arm}: {arms[arm]}", file=sys.stderr)
    line = json.dumps(report(arms["fp"], arms["int8"], args.family,
                             args.tokens, args.tiny))
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
