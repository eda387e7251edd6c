"""Command line: ``python -m cassmantle_tpu_torch <command> [flags]``.

The counterpart of ``cassmantle_tpu/__main__.py``'s commands:

- ``serve``: the game server of one worker (``server/app.py::main``);
- ``quantize-weights``: write ``<family>.int8.safetensors``
  (``tools/quantize_weights.py``);
- ``lm-int8-ab``: the fp against weights-only int8 decode A/B, one JSON
  line (``tools/lm_int8_ab.py``);
- ``clip-report``: the CLIP-similarity quality gate across the presets
  (``tools/clip_report.py``);
- ``train-diffusion``: the UNet's denoising fine-tune (synthetic or .npy
  data; ``parallel/train.py``);
- ``train-lm``: the prompt LM's next-token fine-tune (GPT-2;
  ``parallel/lm_train.py``).

The training commands are thin loops over the trainers with
``utils/checkpoint.py::TrainCheckpointer`` (``--checkpoint-dir`` resumes
from its latest step). Step N's draws come from a generator seeded from
(``--seed``, N), so a resumed run draws what an uninterrupted one does.
They train on one device: ``--dp``, ``--tp`` and ``--sp`` other than 1
(``--dp -1``, every device, is the one) are ROADMAP Queue 1 item 16 and
are refused. ``--platform cpu`` runs on the host.

The W8A8 calibration runs as ``python -m
cassmantle_tpu_torch.parallel.calibrate --emit``, as in the reference.
"""

from __future__ import annotations

import argparse
import sys


def _exit_code(e: SystemExit) -> int:
    """sys.exit accepts any object; non-int codes print to stderr."""
    if e.code is None:
        return 0
    if isinstance(e.code, int):
        return e.code
    print(e.code, file=sys.stderr)
    return 1


def cmd_serve(argv) -> int:
    from cassmantle_tpu_torch.server.app import main as serve_main

    saved = sys.argv
    sys.argv = ["cassmantle-tpu-torch serve"] + list(argv)
    try:
        serve_main(list(argv))
    except SystemExit as e:
        return _exit_code(e)
    finally:
        sys.argv = saved
    return 0


def cmd_quantize_weights(argv) -> int:
    from cassmantle_tpu_torch.tools.quantize_weights import main as run

    try:
        return run(list(argv))
    except SystemExit as e:
        return _exit_code(e)


def cmd_lm_int8_ab(argv) -> int:
    from cassmantle_tpu_torch.tools.lm_int8_ab import main as run

    try:
        return run(list(argv))
    except SystemExit as e:
        return _exit_code(e)


def cmd_clip_report(argv) -> int:
    from cassmantle_tpu_torch.tools.clip_report import main as run

    try:
        return run(list(argv))
    except SystemExit as e:
        return _exit_code(e)


def _train_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dp", type=int, default=-1,
                   help="data parallel width: -1 (every device) or 1; the "
                        "port trains on one device")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (fits "
                        "bigger batches)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory (resumes from its latest "
                        "step)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", default="default",
                   choices=("default", "test"),
                   help="'test': the tiny test geometry")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    return p


def _refuse_mesh(p: argparse.ArgumentParser, args) -> None:
    wide = {name: n for name, n in (("dp", args.dp), ("tp", args.tp),
                                    ("sp", args.sp))
            if n not in ((-1, 1) if name == "dp" else (1,))}
    if wide:
        p.error(f"{wide}: the port trains on one device; data, tensor and "
                f"sequence parallelism are ROADMAP Queue 1 item 16")


def _framework_config(args):
    from cassmantle_tpu_torch.config import FrameworkConfig, test_config

    return test_config() if args.config == "test" else FrameworkConfig()


def _train_loop(name: str, args, trainer, next_batch) -> int:
    """Step, log and checkpoint; ``next_batch(step)`` gives the batch on
    the trainer's device. Logs each logged step's loss as ``repr`` of the
    float, and at the end the tokens or images a second of the steps
    after this run's first (which loads the kernels), saves left out."""
    import time

    import torch

    from cassmantle_tpu_torch.parallel.train import step_generator
    from cassmantle_tpu_torch.utils.checkpoint import TrainCheckpointer
    from cassmantle_tpu_torch.utils.device import synchronize

    ckpt = (TrainCheckpointer(args.checkpoint_dir) if args.checkpoint_dir
            else None)
    start = saved = 0
    restored = ckpt.restore() if ckpt is not None else None
    if restored is not None:
        start = restored["step"]
        trainer.load_model_state(restored["model"])
        trainer.optimizer.load_state_dict(restored["optimizer"])
        print(f"resumed from step {start}", flush=True)
    dev = trainer.device
    timed_s, items = 0.0, 0
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = next_batch(step)
        loss = trainer.step(batch, step_generator(args.seed, step, dev))
        synchronize(dev)
        if step > start:
            timed_s += time.perf_counter() - t0
            first = next(iter(batch.values()))
            items += first.numel() if name == "lm" else first.shape[0]
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[{name}] step {step} loss {float(loss)!r}", flush=True)
        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            saved = step + 1
            ckpt.save(saved, trainer.model_state(),
                      trainer.optimizer.state_dict())
    if items:
        unit = "tokens" if name == "lm" else "images"
        card = (f" {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
                else "")
        print(f"[{name}] {args.steps - start - 1} steps after the first in "
              f"{timed_s:.3f} s: {items / timed_s:.1f} {unit}/s on "
              f"{dev}{card}", flush=True)
    if ckpt is not None:
        if saved != args.steps and start < args.steps:
            ckpt.save(args.steps, trainer.model_state(),
                      trainer.optimizer.state_dict())
        ckpt.close()
    return 0


def cmd_train_diffusion(argv) -> int:
    p = _train_parser("UNet denoising fine-tune on one device")
    p.add_argument("--latents", default=None,
                   help=".npy of clean latents (N, H, W, 4); synthetic "
                        "data when omitted")
    p.add_argument("--context", default=None,
                   help=".npy of text states (N, S, context_dim)")
    p.add_argument("--image-size", type=int, default=512)
    args = p.parse_args(argv)
    if bool(args.latents) != bool(args.context):
        p.error("--latents and --context must be given together")
    _refuse_mesh(p, args)

    import numpy as np

    from cassmantle_tpu_torch.parallel.train import DiffusionTrainer

    cfg = _framework_config(args)
    trainer = DiffusionTrainer(cfg, lr=args.lr, remat=args.remat,
                               device=args.platform)
    hw = args.image_size // 8
    if args.latents:
        lat_all = np.load(args.latents).astype(np.float32)
        ctx_all = np.load(args.context).astype(np.float32)
    else:
        rng = np.random.default_rng(args.seed)
        lat_all = rng.standard_normal((args.batch * 4, hw, hw, 4),
                                      dtype=np.float32)
        ctx_all = rng.standard_normal(
            (args.batch * 4, 77, cfg.models.unet.context_dim),
            dtype=np.float32)
    trainer.init_state(seed=args.seed)
    n = lat_all.shape[0]

    def next_batch(step):
        idx = np.arange(step * args.batch, (step + 1) * args.batch) % n
        return trainer.place_batch({"latents": lat_all[idx],
                                    "context": ctx_all[idx]})

    return _train_loop("diffusion", args, trainer, next_batch)


def cmd_train_lm(argv) -> int:
    p = _train_parser("LM next-token fine-tune on one device (GPT-2)")
    p.add_argument("--tokens", default=None,
                   help=".npy int32 token stream; synthetic when omitted")
    p.add_argument("--seq-len", type=int, default=256)
    args = p.parse_args(argv)
    _refuse_mesh(p, args)

    import numpy as np
    import torch

    from cassmantle_tpu_torch.models.gpt2 import GPT2LM
    from cassmantle_tpu_torch.parallel.lm_train import LMTrainer
    from cassmantle_tpu_torch.utils.device import resolve_device

    cfg = _framework_config(args)
    if not 2 <= args.seq_len <= cfg.models.gpt2.max_positions:
        p.error(f"--seq-len {args.seq_len} outside [2, "
                f"{cfg.models.gpt2.max_positions}] (the model's positions)")
    dev = resolve_device(args.platform)
    with torch.device(dev):
        model = GPT2LM(cfg.models.gpt2)
    trainer = LMTrainer(model, lr=args.lr, remat=args.remat, device=dev)
    if args.tokens:
        stream = np.load(args.tokens).astype(np.int32)
    else:
        rng = np.random.default_rng(args.seed)
        stream = rng.integers(0, cfg.models.gpt2.vocab_size,
                              size=args.batch * args.seq_len * 4,
                              dtype=np.int32)
    rows = len(stream) // args.seq_len
    ids = stream[:rows * args.seq_len].reshape(rows, args.seq_len)
    mask = np.ones_like(ids)
    trainer.init_state(seed=args.seed)

    def next_batch(step):
        idx = np.arange(step * args.batch, (step + 1) * args.batch) % rows
        return trainer.place_batch({"input_ids": ids[idx],
                                    "loss_mask": mask[idx]})

    return _train_loop("lm", args, trainer, next_batch)


COMMANDS = {"serve": cmd_serve, "quantize-weights": cmd_quantize_weights,
            "lm-int8-ab": cmd_lm_int8_ab, "clip-report": cmd_clip_report,
            "train-diffusion": cmd_train_diffusion,
            "train-lm": cmd_train_lm}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(f"usage: python -m cassmantle_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [--help] ...", file=sys.stderr)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
