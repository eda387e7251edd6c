"""Offline weight quantization: write an int8 prompt-LM checkpoint.

Port of the reference's ``tools/quantize_weights.py``: build the prompt LM
with ``lm_int8`` (from the fp checkpoint in ``--weights``, or the seeded
init without one), then write ``<family>.int8.safetensors`` beside it in
the reference's format. A later ``lm_int8`` build (``serve --lm-int8``)
reads the int8 file straight from disk while it is newer than the fp
checkpoint.

    python -m cassmantle_tpu_torch quantize-weights --weights DIR
        [--lm gpt2|mistral] [--platform cuda|cpu]

The LM is built on the card, as ``serve --lm-int8`` builds it there: the
seeded init without an fp checkpoint is the card generator's, the values
serving on the card draws. A host without CUDA raises unless
``--platform cpu`` asks for the host's build. The quantize itself runs on
the host either way (``ops/quant.py::int8_modules``), one layer at a
time for a streamed Mistral-7B.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


def quantized_config(lm: str = "gpt2"):
    """``FrameworkConfig()`` with the int8 prompt LM (Mistral-7B with
    ``lm == "mistral"``), as the reference's tool builds it."""
    from cassmantle_tpu_torch.config import FrameworkConfig, MistralConfig

    cfg = FrameworkConfig()
    models = dataclasses.replace(cfg.models, lm_int8=True)
    if lm == "mistral":
        models = dataclasses.replace(models, mistral=MistralConfig())
    return cfg.replace(models=models)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cassmantle_tpu_torch quantize-weights",
        description=__doc__.splitlines()[0])
    parser.add_argument("--weights", required=True,
                        help="checkpoint directory (the output lands here)")
    parser.add_argument("--lm", default="gpt2", choices=("gpt2", "mistral"))
    parser.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                        help="where the LM is built (default: the card)")
    args = parser.parse_args(argv)

    from cassmantle_tpu_torch.serving.pipeline import PromptGenerator

    gen = PromptGenerator(quantized_config(args.lm), device=args.platform,
                          weights_dir=args.weights)
    path = gen.save_quantized()
    print(f"quantized checkpoint written: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
