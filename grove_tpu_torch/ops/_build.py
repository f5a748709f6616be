"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` into ``build/grove_tpu_torch/<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source rebuilds) and loaded
with ``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
``load_all`` starts one nvcc per missing source, all together. Nothing is
built when a module is imported.

A ``load_all`` that loads a library not yet loaded runs inside a
``solver.compile`` span (``kernel``: the libraries' names) and observes its
wall, the build included, as ``gang_solve_compile_seconds``: the port's
counterpart of the JAX package's XLA compile of a solver program, which
happens once per process and library here.

``BUILD_DIR`` is also the port's counterpart of the JAX package's
persistent compile cache (``grove_tpu/utils/platform.py``,
``enable_compile_cache``): a library built once is reused by every later
process of the checkout, keyed by its source and flags instead of by a
program signature, and a stale entry can only miss, never load the wrong
code. It needs no switch: it is always on, inside the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grove_tpu_torch"

# --fmad=false: no multiply-add contraction, so `free - take * demand`
# rounds like the plain PyTorch version; no fast math (IEEE division).
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "--fmad=false",
    "-Xptxas",
    "-v",
    "-Xcompiler",
    "-fPIC",
    "-shared",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel source (ptxas register/shared-memory report)
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _compile(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns
    (process, temporary path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries for ``csrc/<name>.cu`` of every name, compiling
    each one that has no build with one nvcc per source, all started
    together. Raises ``RuntimeError`` with nvcc's output when a build
    fails."""
    with _LOCK:
        missing = [name for name in names if name not in _LIBS]
        if missing:
            t0 = time.perf_counter()
            with TRACER.span("solver.compile", kernel=",".join(missing)):
                _build_and_load(missing)
            METRICS.observe("gang_solve_compile_seconds", time.perf_counter() - t0)
        return {name: _LIBS[name] for name in names}


def _build_and_load(names) -> None:
    """Compile every library of ``names`` that has no build, one nvcc each,
    all started together; then load them all."""
    procs = {name: _compile(name) for name in names if not library_path(name).exists()}
    try:
        for name, (proc, tmp) in procs.items():
            BUILD_LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                    + BUILD_LOGS[name]
                )
            os.replace(tmp, library_path(name))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in names:
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it first when no
    build of this source exists. Raises ``RuntimeError`` with nvcc's output
    when the build fails."""
    return load_all([name])[name]
