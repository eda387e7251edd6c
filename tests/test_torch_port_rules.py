"""Rules of the port: ``cassmantle_tpu_torch`` (every module under it, the
server's and the fabric's included) and ``chip_smoke.py`` import no JAX,
no Flax and nothing of the JAX package; and its entry points (the
pipelines, the service, the device probe and telemetry, the server's
``build_game``, ``build_fabric`` and ``serve``) run on the card unless
asked for the CPU, raising on a host without CUDA.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cassmantle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "cassmantle_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, cassmantle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _entry_points():
    from cassmantle_tpu_torch.config import test_config
    from cassmantle_tpu_torch.obs.device import DeviceMetrics
    from cassmantle_tpu_torch.ops.blur import device_blur
    from cassmantle_tpu_torch.server import app
    from cassmantle_tpu_torch.ops.scorer import EmbeddingScorer
    from cassmantle_tpu_torch.serving.pipeline import (
        PromptGenerator,
        Text2ImagePipeline,
        TorchContentBackend,
    )
    from cassmantle_tpu_torch.parallel.mesh import make_mesh
    from cassmantle_tpu_torch.serving.service import (
        InferenceService,
        default_serving_mesh,
    )
    from cassmantle_tpu_torch.utils.health import DeviceHealth

    cfg = test_config()
    return {
        "InferenceService": lambda: InferenceService(cfg),
        "TorchContentBackend": lambda: TorchContentBackend(cfg),
        "Text2ImagePipeline": lambda: Text2ImagePipeline(cfg),
        "PromptGenerator": lambda: PromptGenerator(cfg),
        "EmbeddingScorer": lambda: EmbeddingScorer(cfg.models.minilm),
        "device_blur": lambda: device_blur(
            np.zeros((8, 8, 3), np.uint8), 2.0),
        "DeviceHealth": lambda: DeviceHealth(),
        "DeviceMetrics": lambda: DeviceMetrics(),
        "build_game": lambda: app.build_game(cfg),
        "build_fabric": lambda: app.build_fabric(cfg),
        "serve_main": lambda: app.main(["--port", "0"]),
        "make_mesh": lambda: make_mesh(),
        "default_serving_mesh": lambda: default_serving_mesh(cfg),
    }


@pytest.mark.parametrize("name", ["InferenceService", "TorchContentBackend",
                                  "Text2ImagePipeline", "PromptGenerator",
                                  "EmbeddingScorer", "device_blur",
                                  "DeviceHealth", "DeviceMetrics",
                                  "build_game", "build_fabric",
                                  "serve_main", "make_mesh",
                                  "default_serving_mesh"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Called without ``device=``, an entry point asks for CUDA; on a host
    without it, it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()
