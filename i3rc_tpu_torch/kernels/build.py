"""Build the port's CUDA sources into a shared library and load it.

Sources under ``i3rc_tpu_torch/csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the repository root, at first use, and
cached there by a hash of the sources, the headers and the flags.  Each
source compiles in its own ``nvcc`` process, all started together, and one
more links the objects.  The library has a plain C interface and is loaded
with ``ctypes``; nothing here includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false keeps float arithmetic identical to the PyTorch twins (no
# contracted multiply-adds); -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float     # wall time of the build; 0.0 when the cached library was reused
    log: str           # nvcc / ptxas output of the build ("" when cached)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run(cmds: list[list[str]], what: str) -> str:
    """Run the commands in parallel; their joined output, or raise.  Each
    writes to a file of its own, so no process waits on a full pipe."""
    files = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(cmds, files)]
    outs = []
    for p, f in zip(procs, files):
        p.wait()
        f.seek(0)
        outs.append(f.read())
        f.close()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed building {what} (exit {p.returncode}):\n{out}")
    return "".join(outs)


def build(name: str, sources: tuple[str, ...]) -> Built:
    """Compile ``csrc/<sources>`` into ``build/kernels/<name>-<hash>.so``."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths + sorted(CSRC.glob("*.cuh")):
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in paths]
        tmp = BUILD_DIR / f"{tag}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        try:
            log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(paths, objs)], name)
            log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], name)
            os.replace(tmp, out)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
