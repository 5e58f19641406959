"""The flash-attention kernel: build, wrapper and plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (and
the padding and head folding of its wrapper ``repro.kernels.ops.
flash_attention``). The kernel is CUDA C++ for ``sm_90a`` in
``csrc/flash_attention.cu`` (its header says what bounds it and how the
design answers that), built with ``nvcc`` at first use and bound with
``ctypes``.

Positions follow the TPU kernel: query ``i`` and key ``j`` both count from
0, so causality is ``j <= i`` (prefill calls it with S == T). The kernel
masks a ragged S and T itself; nothing is padded, transposed or copied.

``flash_attention`` takes the plain version only for tensors on the CPU. A
CUDA tensor always launches the kernel: a missing ``nvcc``, a failed build,
an unsupported layout or a refused launch raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.nvcc import build_library, load_library

__all__ = ["HEAD_DIMS", "SOURCE", "build", "flash_attention", "flash_attention_ref"]

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = Path(__file__).parent / "build"
HEAD_DIMS = (32, 64, 80, 128)  # the kernel's template instances

_lib: ctypes.CDLL | None = None


def _mask(s: int, t: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, T) True where query i may attend key j (positions from 0)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    ok = torch.ones(s, t, dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    return ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Plain version, in f32: q (B, S, H, hd), k/v (B, T, Hkv, hd) ->
    (B, S, H, hd) in q's dtype. Masked scores weigh exactly 0, and a query
    with no key to attend gives 0, as in the kernel."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, s, hkv, g, hd) * hd**-0.5
    logits = torch.einsum("bshgd,bthd->bhgst", qf, k.float())
    ok = _mask(s, t, causal, window, q.device)
    m = logits.masked_fill(~ok, -1e30).amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~ok, 0.0)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2).unsqueeze(-1).clamp_min(1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` into a shared library (cached by
    source hash) and return its path. Raises if ``nvcc`` is missing or fails."""
    return build_library(SOURCE, _BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        args = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr,
                i64, i64, i64, i64, i64,
                i64, i64, i64, i64, i64, i64, i64, i64, i64,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        _lib = load_library(build(), {"flash_attention_fwd": args})
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B, S, H, hd) and k, v (B, T, Hkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (same B and hd, H a multiple of Hkv)")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _aligned(x: torch.Tensor) -> bool:
    """The kernel moves 16 bytes of a row at a time (4 f32 or 8 bf16 values):
    the last stride is 1, and the other strides and the start are whole
    multiples of 16 bytes."""
    st, size = x.stride(), x.element_size()
    return st[3] == 1 and all(s * size % 16 == 0 for s in st[:3]) and x.data_ptr() % 16 == 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Causal (or windowed) GQA attention, scale ``hd**-0.5``, f32 softmax
    statistics and accumulation, output (B, S, H, hd) in q's dtype.

    q: (B, S, H, hd); k, v: (B, T, Hkv, hd), f32 or bf16; query head ``h``
    reads KV head ``h // (H // Hkv)``. CPU tensors take ``flash_attention_ref``.
    On the card hd must be one of ``HEAD_DIMS`` and every row contiguous, with
    strides and starts a multiple of 16 bytes (as ``attention_layer``
    produces them at every hd of ``HEAD_DIMS``).
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not all(_aligned(x) for x in (q, k, v)):
        raise ValueError("flash_attention wants rows of hd contiguous values with strides "
                         "(and starts) a multiple of 16 bytes; got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if b * h > 65535 or max(s, t) >= 2**31 - 64:
        raise ValueError(f"flash_attention: B*H={b * h} or S={s}, T={t} out of the kernel's range")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lib = _lib or _library()
    dev = q.device
    args = (0 if q.dtype is torch.float32 else 1, hd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, hkv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 0 if window is None else int(window), hd**-0.5)
    # The kernel launches on the CUDA runtime's current device: make it q's.
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = lib.flash_attention_fwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_attention_fwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    count_launch("flash_attention")
    return out
