"""The sparse DecAvg mixing kernels: build, wrappers and plain versions.

Replaces the two Pallas kernels of ``repro/kernels/sparse_gossip.py``:

- ``gossip_mix_sparse_blocked`` (``sparse_gossip_blocked_pallas``): the
  8-row-blocked ELL layout of ``core.sparse.block_ell_from_csr``;
- ``gossip_mix_sparse`` (``sparse_gossip_pallas``): the scalar ELL row
  gather of ``core.sparse.ell_from_csr``.

Both are one CUDA C++ kernel template for ``sm_90a`` in
``csrc/sparse_gossip.cu`` (its header says what bounds them and how the
design answers that), built with ``nvcc`` at first use and bound with
``ctypes``. A wrapper takes the plain version only for tensors on the CPU; a
CUDA tensor always launches the kernel, or the call raises. The kernels take
P unpadded: they mask a ragged N and D themselves, and choose on their own
between bulk copies (16-byte aligned rows) and 4-byte copies.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.nvcc import build_library, load_library

__all__ = [
    "BLOCK_ROWS",
    "SOURCE",
    "WINDOW_ROWS",
    "build",
    "load",
    "open_library",
    "gossip_mix_sparse",
    "gossip_mix_sparse_blocked",
    "sparse_gossip_ref",
    "sparse_gossip_blocked_ref",
    "staged_rows",
]

SOURCE = Path(__file__).parent / "csrc" / "sparse_gossip.cu"
_BUILD_DIR = Path(__file__).parent / "build"
BLOCK_ROWS = 8  # rows per block of the blocked layout (the reference's sublane count)
WINDOW_ROWS = 16  # destination rows of a work item of either kernel at most (csrc WROWS)

_lib: ctypes.CDLL | None = None


def sparse_gossip_ref(idx: torch.Tensor, val: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain scalar ELL: gather the K source rows of every row, then sum them
    in f32, weighted; output in P's dtype."""
    gathered = p.float()[idx.long()]  # (N, K, D)
    return (val.float().unsqueeze(-1) * gathered).sum(dim=1).to(p.dtype)


def sparse_gossip_blocked_ref(idx: torch.Tensor, val: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain blocked ELL: for each tile slot, gather every destination
    block's source block and add its (8, 8) weight tile times it, in f32;
    output in P's dtype."""
    nb, kb = idx.shape
    n, d = p.shape
    pf = p.float()
    if n < nb * BLOCK_ROWS:  # rows past N hold nothing, and weigh 0
        pf = torch.cat([pf, pf.new_zeros(nb * BLOCK_ROWS - n, d)])
    blocks = pf.reshape(nb, BLOCK_ROWS, d)
    tiles = val.float().reshape(nb, BLOCK_ROWS, kb, BLOCK_ROWS)
    out = pf.new_zeros(nb, BLOCK_ROWS, d)
    for s in range(kb):
        out += torch.bmm(tiles[:, :, s, :], blocks[idx[:, s].long()])
    return out.reshape(nb * BLOCK_ROWS, d)[:n].to(p.dtype)


def staged_rows(idx, val, n: int, window: int, *, blocked: bool) -> int:
    """Source row segments read for one column slab when each distinct source
    row of a window of ``window`` destination rows is read once: the count of
    distinct (row // window, source) pairs with a nonzero weight.

    ``window=1`` counts a row gather that reads every nonzero slot,
    ``window=BLOCK_ROWS`` a blocked kernel that reads each active column of
    each block's tiles, ``window=WINDOW_ROWS`` this file's kernels. idx and
    val are either layout (numpy arrays or CPU tensors); rows and sources at
    or past ``n`` are not counted.
    """
    idx, val = np.asarray(idx).astype(np.int64), np.asarray(val)
    if blocked:  # val[r, 8t + o] weighs source 8 idx[r // 8, t] + o
        kb = idx.shape[1]
        src = np.repeat(BLOCK_ROWS * np.repeat(idx, BLOCK_ROWS, axis=1)
                        + np.tile(np.arange(BLOCK_ROWS), kb), BLOCK_ROWS, axis=0)
    else:
        src = idx
    rows = np.broadcast_to(np.arange(src.shape[0])[:, None], src.shape)
    live = (val != 0) & (rows < n) & (src < n)
    return int(np.unique(rows[live] // window * n + src[live]).size)


def build() -> Path:
    """Compile ``csrc/sparse_gossip.cu`` into a shared library (cached by
    source hash) and return its path. Raises if ``nvcc`` is missing or fails."""
    return build_library(SOURCE, _BUILD_DIR)


def open_library(path: Path) -> ctypes.CDLL:
    """Load a library built from a version of ``csrc/sparse_gossip.cu`` and
    its kernels into the current card's CUDA context, without launching
    one, and let it set their shared-memory limits and read the SM count
    (so a CUDA graph capture can launch them). Raises on any CUDA error."""
    args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib = load_library(path, {
        "sparse_gossip_f32": args, "sparse_gossip_bf16": args,
        "sparse_gossip_blocked_f32": args, "sparse_gossip_blocked_bf16": args,
        "sparse_gossip_load": [],
    })
    lib.devices = set()  # the cards it is loaded on
    _load_on(lib, torch.device("cuda", torch.cuda.current_device()))
    return lib


def _load_on(lib: ctypes.CDLL, device: torch.device) -> None:
    """Load ``lib``'s kernels on ``device`` once (the kernels' shared-memory
    limits and occupancy are the card's own)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index in lib.devices:
        return
    with torch.cuda.device(device):
        rc = lib.sparse_gossip_load()
    if rc != 0:
        raise RuntimeError(f"sparse_gossip kernels failed to load on {device}: CUDA error {rc}")
    lib.devices.add(device.index)


def load(device: torch.device | None = None) -> ctypes.CDLL:
    """Build and load this file's library (``open_library``), once, and
    load its kernels on ``device`` too (a CUDA device; None: the current
    card only). A launch loads them on its tensors' card first if need be;
    a graph capture on a card should follow a ``load`` there."""
    global _lib
    if _lib is None:
        _lib = open_library(build())
    if device is not None:
        _load_on(_lib, device)
    return _lib


def _check(idx: torch.Tensor, val: torch.Tensor, p: torch.Tensor, name: str) -> None:
    if idx.dim() != 2 or val.dim() != 2 or p.dim() != 2:
        raise ValueError(f"{name} wants 2-D idx, val and P, got {tuple(idx.shape)}, "
                         f"{tuple(val.shape)} and {tuple(p.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} takes integer idx, got {idx.dtype}")
    if p.dtype is not torch.float32 and p.dtype is not torch.bfloat16:
        raise TypeError(f"{name} takes f32 or bf16 P, got {p.dtype}")
    if idx.device != p.device or val.device != p.device:
        raise ValueError(f"idx on {idx.device}, val on {val.device}, P on {p.device}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {p.device}")


def _layout_args(idx: torch.Tensor, val: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """idx as contiguous int32 and val as contiguous f32 starting on a
    16-byte boundary (the blocked kernel reads its weights 16 bytes at a
    time). Tiny (a few KB): copied only when a caller hands something else."""
    idx = idx.to(torch.int32).contiguous()
    val = val.to(torch.float32).contiguous()
    if val.data_ptr() % 16:
        val = val.clone()
    return idx, val


def _launch(name: str, idx, val, p, n: int, k: int) -> torch.Tensor:
    if not p.is_contiguous():
        raise ValueError(f"{name} wants a contiguous P (reshape the leaf first)")
    idx, val = _layout_args(idx, val)
    lib = _lib or load()
    dev = p.device
    _load_on(lib, dev)
    suffix = "f32" if p.dtype is torch.float32 else "bf16"
    fn = getattr(lib, f"{name}_{suffix}")
    out = torch.empty_like(p)
    args = (idx.data_ptr(), val.data_ptr(), p.data_ptr(), out.data_ptr(), n, k, p.shape[1])
    # The kernel launches on the CUDA runtime's current device: make it P's.
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(name)
    return out


def gossip_mix_sparse(idx: torch.Tensor, val: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """ELL ``W @ P`` with f32 accumulation, output in P's dtype.

    idx, val: (N, K) source rows and weights (``core.sparse.ell_from_csr``;
    padded slots weigh 0); p: (N, D) contiguous, f32 or bf16. CPU tensors
    take ``sparse_gossip_ref``.
    """
    _check(idx, val, p, "gossip_mix_sparse")
    n, k = idx.shape
    if val.shape != idx.shape or p.shape[0] != n:
        raise ValueError(f"gossip_mix_sparse: idx {tuple(idx.shape)}, val {tuple(val.shape)}, "
                         f"P {tuple(p.shape)} do not match")
    if p.device.type == "cpu":
        return sparse_gossip_ref(idx, val, p)
    return _launch("sparse_gossip", idx, val, p, n, k)


def gossip_mix_sparse_blocked(idx: torch.Tensor, val: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL ``W @ P`` with f32 accumulation, output in P's dtype.

    idx: (NB, KB) source-block ids; val: (NB*8, KB*8) stacked (8, 8) weight
    tiles (``core.sparse.block_ell_from_csr``); p: (N, D) contiguous, f32 or
    bf16, with NB = ceil(N / 8). CPU tensors take ``sparse_gossip_blocked_ref``.
    """
    _check(idx, val, p, "gossip_mix_sparse_blocked")
    nb, kb = idx.shape
    n = p.shape[0]
    if val.shape != (nb * BLOCK_ROWS, kb * BLOCK_ROWS) or nb != -(-n // BLOCK_ROWS):
        raise ValueError(f"gossip_mix_sparse_blocked: idx {tuple(idx.shape)}, val "
                         f"{tuple(val.shape)}, P {tuple(p.shape)} do not match")
    if p.device.type == "cpu":
        return sparse_gossip_blocked_ref(idx, val, p)
    return _launch("sparse_gossip_blocked", idx, val, p, n, kb)
