"""Build a CUDA source into a shared library with ``nvcc`` and load it.

Each kernel's source (``csrc/*.cu``) has a plain C interface and is compiled
on its own into ``build/`` beside this file, keyed on a hash of the source
and the flags, so a stale library is never loaded. Nothing here runs at
import: a library is built the first time its kernel is launched (or when
``chip_smoke.py`` builds them all up front, one ``nvcc`` per source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "load_library", "ptxas_report"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def build_library(source: Path, build_dir: Path) -> Path:
    """Compile ``source`` into ``build_dir`` (cached by source hash) and
    return the library's path. Raises if ``nvcc`` is missing or fails.
    ``ptxas``'s report of each kernel's registers, spills and shared memory
    is kept beside the library (``ptxas_report``)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = build_dir / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: a concurrent build never sees a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True, check=False,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text(res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ptxas_report(library: Path) -> list[str]:
    """``ptxas -v``'s lines for a library built by ``build_library``: per
    kernel, its name, then its registers, spills and shared memory."""
    log = library.with_suffix(".ptxas.txt")
    if not log.exists():
        return []
    keep = ("Compiling entry", "Used ", "spill")
    return [line.replace("ptxas info    : ", "").strip() for line in log.read_text().splitlines()
            if any(k in line for k in keep)]


def load_library(path: Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load ``path`` and declare each C function's arguments; every function
    returns a CUDA error code (``int``)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        # c_void_p for pointers and the stream: without argtypes ctypes
        # passes Python ints as 32-bit C ints and cuts the pointers.
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
