"""Command line: ``python -m cassmantle_tpu_torch <command> [flags]``.

The counterpart of ``cassmantle_tpu/__main__.py``'s commands:

- ``serve``: the game server of one worker (``server/app.py::main``);
- ``quantize-weights``: write ``<family>.int8.safetensors``
  (``tools/quantize_weights.py``);
- ``lm-int8-ab``: the fp against weights-only int8 decode A/B, one JSON
  line (``tools/lm_int8_ab.py``).

The W8A8 calibration runs as ``python -m
cassmantle_tpu_torch.parallel.calibrate --emit``, as in the reference.
"""

from __future__ import annotations

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


COMMANDS = {"serve": cmd_serve, "quantize-weights": cmd_quantize_weights,
            "lm-int8-ab": cmd_lm_int8_ab}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m cassmantle_tpu_torch "
              "{serve,quantize-weights,lm-int8-ab} [--help] ...",
              file=sys.stderr)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
