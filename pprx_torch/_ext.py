"""Build and load the port's native code: CUDA kernels and host C++.

Each ``pprx_torch/csrc/<name>.cu`` (a kernel, ``build``) or
``pprx_torch/csrc/<name>.cpp`` (host code, ``build_host``) exposes a plain C
interface. It is compiled, with ``nvcc`` or with ``$CXX`` (else ``g++``),
into a shared library under ``build/pprx_torch/`` at the root of the
checkout, keyed by a hash of the source, the compiler and the flags, at
first use, and loaded with ``ctypes``. Nothing is compiled when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pprx_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# native/Makefile's flags for the JAX package's copy of the edge-list parser
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


@dataclasses.dataclass(frozen=True)
class Build:
    """Where a kernel library lies, how long it took to build (0 when it
    was already built from the same source and flags) and what the
    compiler printed (``-Xptxas -v`` register and spill lines)."""

    path: Path
    seconds: float
    log: str


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, $PATH); "
            "the CUDA kernels build only on a machine with the CUDA toolkit"
        )
    return found


def find_cxx() -> str | None:
    """The host C++ compiler: ``$CXX`` where it is set, else ``g++`` on the
    ``PATH``; ``None`` where there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _compile(src: Path, compiler: str, flags: tuple[str, ...]) -> Build:
    """Compile ``src`` into ``build/pprx_torch/`` unless a library from the
    same source, compiler and flags is already there; raises when the
    compiler fails."""
    digest = hashlib.sha256(src.read_bytes() + " ".join((compiler, *flags)).encode())
    out = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return Build(out, seconds, log)


def build(name: str) -> Build:
    """Compile the kernel source ``csrc/<name>.cu`` unless a library from
    the same source and flags is already built."""
    return _compile(CSRC / f"{name}.cu", find_nvcc(), NVCC_FLAGS)


def build_host(name: str) -> Build:
    """Compile the host source ``csrc/<name>.cpp`` with ``find_cxx()``
    unless a library from the same source, compiler and flags is already
    built; raises where there is no compiler."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler for csrc/{name}.cpp (looked for $CXX, else g++ on $PATH)")
    return _compile(CSRC / f"{name}.cpp", cxx, CXX_FLAGS)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cpp``, built on first use."""
    return ctypes.CDLL(str(build_host(name).path))
