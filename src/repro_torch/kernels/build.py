"""Build the port's CUDA sources at first use and load them with ctypes.

Each source in ``kernels/csrc`` has a plain C interface and includes no
PyTorch header, so ``nvcc`` compiles it in seconds.  The shared library
goes into ``.repro_torch_build/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once.  Any failure raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "build_log",
           "find_nvcc", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".repro_torch_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _compile(src: Path, out: Path) -> str:
    """nvcc ``src`` into ``out`` atomically; returns the compiler's log."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return log


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = _lib_path(name)
        if not out.exists():
            _compile(CSRC / f"{name}.cu", out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def build_all() -> dict[str, float]:
    """Compile every source in ``csrc`` that has no library yet, one
    ``nvcc`` per source, all started together; returns the seconds each
    took (0 for a library already built).  Loading stays with
    :func:`load_library`."""
    def one(src: Path) -> float:
        out = _lib_path(src.stem)
        if out.exists():
            return 0.0
        t0 = time.perf_counter()
        _compile(src, out)
        return time.perf_counter() - t0

    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        secs = list(pool.map(one, sources))
    return {src.stem: s for src, s in zip(sources, secs)}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v`` register and shared-memory
    report) of the library :func:`load_library` built for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
