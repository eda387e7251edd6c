"""Build the port's CUDA sources into shared libraries and load them.

Each source in ``cassmantle_tpu_torch/csrc/`` is a plain C interface
compiled by ``nvcc`` for ``sm_90a`` into ``cassmantle_tpu_torch/_build/``
(git-ignored) and loaded with ``ctypes``. The library's file name carries
a hash of the source, the shared headers (``*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one loads the library built
before. Nothing is built at import time: the first launch of a kernel
builds its library; ``build_all`` runs one ``nvcc`` per source, all at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc")


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in csrc/) is built."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read())
    for header in sorted(h for h in os.listdir(CSRC_DIR)
                         if h.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``source`` unless its library is already built; return the
    library's path. The compiler's report (registers, shared memory,
    spills) is kept beside it as ``.log``."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, str]:
    """Build every source of csrc/ that is not built yet, one nvcc
    process per source, all started together; returns {source: library
    path}."""
    sources = sorted(s for s in os.listdir(CSRC_DIR) if s.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _loaded[source] = lib
        return lib
