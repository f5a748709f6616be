"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` into ``build/grove_tpu_torch/<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source rebuilds) and loaded
with ``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it first when no
    build of this source exists. Raises ``RuntimeError`` with nvcc's output
    when the build fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                    + BUILD_LOGS[name]
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
