"""The ELL slot sum of the ``sparse`` and ``sparse_sharded`` mixes: build,
wrapper and plain version.

``ell_sum(idx, val, src)`` is ``out[i] = sum_k val[i, k] * src[idx[i, k]]``
over each row's slots in slot order, in f32, each product rounded before it
is added. It replaces no TPU kernel (the reference's sums are ``jnp``
segment sums): the plain version, ``ell_sum_ref``, launched three kernels a
slot over every row, and a hub's row of 117 slots made a round of the
large_n preset tens of thousands of launches. The kernel is CUDA C++ for
``sm_90a`` in ``csrc/ell_sum.cu`` (its header says what bounds it and how
its design answers that), built with ``nvcc`` at first use and bound with
``ctypes``. It gives the plain version's results bit for bit (under
``torch.equal``), so every path that sums this way keeps its numbers.

A CPU tensor takes the plain version; a CUDA tensor always launches the
kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.nvcc import build_library, load_library

__all__ = ["SOURCE", "build", "ell_sum", "ell_sum_ref", "load"]

SOURCE = Path(__file__).parent / "csrc" / "ell_sum.cu"
_BUILD_DIR = Path(__file__).parent / "build"

_lib: ctypes.CDLL | None = None


def ell_sum_ref(idx: torch.Tensor, val: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version: ``sum_k val[:, k] * src[idx[:, k]]`` in k order, one
    gather, multiply and add a slot over all rows; ``src`` is f32."""
    out = src.index_select(0, idx[:, 0]).mul_(val[:, :1])
    for k in range(1, idx.shape[1]):
        out.add_(src.index_select(0, idx[:, k]).mul_(val[:, k : k + 1]))
    return out


def build() -> Path:
    """Compile ``csrc/ell_sum.cu`` into a shared library (cached by source
    hash) and return its path. Raises if ``nvcc`` is missing or fails."""
    return build_library(SOURCE, _BUILD_DIR)


def load(device: torch.device | None = None) -> ctypes.CDLL:
    """Build and load the library once, and load its kernels on ``device``
    (None: the current card), so that a CUDA graph captured there can record
    a launch. A launch does this on its tensors' card itself."""
    global _lib
    if _lib is None:
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        _lib = load_library(build(), {"ell_sum_i32": args, "ell_sum_i64": args, "ell_sum_load": []})
        _lib.devices = set()
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _lib.devices:
        with torch.cuda.device(index):
            rc = _lib.ell_sum_load()
        if rc != 0:
            raise RuntimeError(f"ell_sum failed to load on cuda:{index}: CUDA error {rc}")
        _lib.devices.add(index)
    return _lib


def ell_sum(idx: torch.Tensor, val: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(R, D) f32: row i is ``sum_k val[i, k] * src[idx[i, k]]``, summed in
    slot order from slot 0's product, each product rounded before it is
    added.

    idx: (R, K) int32 or int64 rows of ``src``, trusted to lie in [0, H);
    val: (R, K) f32 weights (zero-weight slots add nothing and are skipped
    on the card); src: (H, D) f32, rows of any stride. CPU tensors take
    ``ell_sum_ref``; CUDA tensors launch the kernel once.
    """
    if idx.dim() != 2 or val.dim() != 2 or src.dim() != 2:
        raise ValueError(f"ell_sum wants 2-D idx, val and src, got {tuple(idx.shape)}, "
                         f"{tuple(val.shape)} and {tuple(src.shape)}")
    if val.shape != idx.shape or idx.shape[1] == 0:
        raise ValueError(f"ell_sum: idx {tuple(idx.shape)} and val {tuple(val.shape)} must "
                         f"match, with one slot or more")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ell_sum takes int32 or int64 idx, got {idx.dtype}")
    if val.dtype is not torch.float32 or src.dtype is not torch.float32:
        raise TypeError(f"ell_sum takes f32 val and src, got {val.dtype} and {src.dtype}")
    dev = src.device
    if idx.device != dev or val.device != dev:
        raise ValueError(f"idx on {idx.device}, val on {val.device}, src on {dev}")
    if dev.type == "cpu":
        return ell_sum_ref(idx, val, src)
    if dev.type != "cuda":
        raise ValueError(f"ell_sum runs on CUDA or CPU tensors, got {dev}")
    (r, k), (h, d) = idx.shape, src.shape
    out = torch.empty((r, d), dtype=torch.float32, device=dev)
    if r == 0 or d == 0:
        return out
    if d > 1 and src.stride(1) != 1:
        src = src.contiguous()
    ld = src.stride(0) if h > 1 else d
    idx, val = idx.contiguous(), val.contiguous()
    lib = load(dev)
    fn = lib.ell_sum_i32 if idx.dtype is torch.int32 else lib.ell_sum_i64
    args = (idx.data_ptr(), val.data_ptr(), src.data_ptr(), out.data_ptr(), r, k, d, ld)
    # The kernel launches on the CUDA runtime's current device: make it src's.
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_sum launch failed: CUDA error {rc}")
    count_launch("ell_sum")
    return out
