"""Build-at-first-use for the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function. It is compiled by
``nvcc`` into ``build/kernels/lib<name>_<hash>.so`` at the repository root
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited kernel rebuilds and an unchanged one is reused) and
loaded with ``ctypes``. Nothing here runs at import time: a CPU-only machine
imports the package without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# sm_90a: Hopper with its arch-specific features. -fmad=false: no multiply
# is contracted into an FMA, so the kernels' arithmetic rounds exactly like
# their plain PyTorch versions (and shared triangle edges stay exact
# negations). -Xptxas -v reports registers / shared memory / spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel library: {"seconds": build time or 0.0 when cached, "log": ptxas}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/ at first use")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    # the hash also covers the shared headers, which a source may include
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    info = {"seconds": 0.0, "log": "", "path": str(so)}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{info['log']}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    BUILD_INFO[name] = info
    return lib
