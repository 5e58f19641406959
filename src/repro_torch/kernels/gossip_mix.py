"""The DecAvg mixing kernel ``C = W @ P``: build, wrapper and plain version.

Replaces ``repro/kernels/gossip_mix.py::gossip_mix_pallas``. The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/gossip_mix.cu`` (its header says what bounds
it and how its design answers that). It is compiled with ``nvcc`` at first
use into ``build/`` beside this file, keyed on a hash of the source so a
stale library is never loaded, and bound with ``ctypes``.

``gossip_mix`` takes the plain version only for tensors on the CPU. A CUDA
tensor always launches the kernel: a missing ``nvcc``, a failed build or a
refused launch raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.nvcc import build_library, load_library

__all__ = ["gossip_mix", "gossip_mix_ref", "build", "SOURCE"]

SOURCE = Path(__file__).parent / "csrc" / "gossip_mix.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_lib: ctypes.CDLL | None = None


def gossip_mix_ref(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: f32-accumulated ``W @ P`` cast back to P's dtype."""
    return (w.float() @ p.float()).to(p.dtype)


def build() -> Path:
    """Compile ``csrc/gossip_mix.cu`` into a shared library (cached by source
    hash) and return its path. Raises if ``nvcc`` is missing or fails."""
    return build_library(SOURCE, _BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        args = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = load_library(build(), {"gossip_mix_f32": args, "gossip_mix_bf16": args})
    return _lib


def gossip_mix(w: torch.Tensor, p: torch.Tensor, *, block_sparse: bool = True) -> torch.Tensor:
    """``W @ P`` with f32 accumulation, output in P's dtype.

    w: (M, K) mixing matrix (cast to f32); p: (K, D) contiguous, f32 or bf16.
    ``block_sparse`` lets the kernel skip all-zero W tiles (the result is the
    same either way). CPU tensors take ``gossip_mix_ref``.
    """
    if w.dim() != 2 or p.dim() != 2 or w.shape[1] != p.shape[0]:
        raise ValueError(f"gossip_mix wants W (M, K) and P (K, D), got "
                         f"{tuple(w.shape)} and {tuple(p.shape)}")
    if p.dtype is not torch.float32 and p.dtype is not torch.bfloat16:
        raise TypeError(f"gossip_mix takes f32 or bf16 P, got {p.dtype}")
    dev = p.device
    if w.device != dev:
        raise ValueError(f"W on {w.device} but P on {dev}")
    if dev.type == "cpu":
        return gossip_mix_ref(w, p)
    if dev.type != "cuda":
        raise ValueError(f"gossip_mix runs on CUDA or CPU tensors, got {dev}")
    if not p.is_contiguous():
        raise ValueError("gossip_mix wants a contiguous P (reshape the leaf first)")
    if w.dtype is not torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()  # tiny: (N, N)
    lib = _lib or _library()
    fn = lib.gossip_mix_f32 if p.dtype is torch.float32 else lib.gossip_mix_bf16
    out = torch.empty((w.shape[0], p.shape[1]), dtype=p.dtype, device=dev)
    args = (w.data_ptr(), p.data_ptr(), out.data_ptr(), w.shape[0], w.shape[1],
            p.shape[1], int(block_sparse))
    # The kernel launches on the CUDA runtime's current device: make it P's.
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gossip_mix launch failed: CUDA error {rc}")
    count_launch("gossip_mix")
    return out
