"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each kernel's ``csrc/<name>.cu`` exposes a plain C interface and compiles,
with the ``*.cuh`` headers beside it, to its own shared library, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/kernels/`` at the root of the checkout, named by a hash of
the sources and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing is built at import: :func:`load` builds on the
first CUDA call, and :func:`build_all` starts one ``nvcc`` per source at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

# kernel name -> source, relative to this package
SOURCES = {
    "dequant_matmul": KERNELS_DIR / "dequant_matmul" / "csrc"
    / "dequant_matmul.cu",
    "dequant_matmul_grouped": KERNELS_DIR / "dequant_matmul" / "csrc"
    / "dequant_matmul_grouped.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "rd_quant": KERNELS_DIR / "rd_quant" / "csrc" / "rd_quant.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}      # kernel -> nvcc/ptxas output
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    """Named by a hash of the source, the headers beside it and the flags."""
    src = SOURCES[name]
    text = b"".join(p.read_bytes()
                    for p in (src, *sorted(src.parent.glob("*.cuh"))))
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (path, tmp, process, t0) or (path, None, None, None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, out: Path, tmp, proc, t0) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all


def build_all() -> dict[str, float]:
    """Build every kernel, one ``nvcc`` per source started together.
    Returns the seconds each build took (0.0 for a library reused)."""
    started = {n: _start(n) for n in SOURCES}
    for n, job in started.items():
        _finish(n, *job)
    return {n: BUILD_SECONDS.get(n, 0.0) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        _finish(name, *job)
        lib = ctypes.CDLL(str(job[0]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher (a launch
    refused for its configuration never runs, and a later synchronize
    would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
