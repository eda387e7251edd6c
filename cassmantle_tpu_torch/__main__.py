"""Command line: ``python -m cassmantle_tpu_torch serve [flags]``.

The counterpart of ``cassmantle_tpu/__main__.py``'s ``serve`` command:
the game server of one worker (``server/app.py::main``). No other command
is ported yet.
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


COMMANDS = {"serve": cmd_serve}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m cassmantle_tpu_torch serve [--help] ...",
              file=sys.stderr)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
