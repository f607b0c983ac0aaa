"""Build the port's CUDA sources into a shared library and load it.

Sources under ``i3rc_tpu_torch/csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the repository root, at first use, and
cached there by a hash of the sources and flags.  The library has a plain C
interface and is loaded with ``ctypes``; nothing here includes PyTorch's
headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false keeps float arithmetic identical to the PyTorch twins (no
# contracted multiply-adds); -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float     # compile time; 0.0 when the cached library was reused
    log: str           # nvcc / ptxas output of the compile ("" when cached)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(name: str, sources: tuple[str, ...]) -> Built:
    """Compile ``csrc/<sources>`` into ``build/kernels/<name>-<hash>.so``."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
