"""The selective scan of a Mamba-1 mixer: build, wrapper and plain version.

``selective_scan(u, dt, dt_bias, a, bmat, cmat, d_skip, h0)`` discretises and
runs the recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t u_t`` with
``dt_t = softplus(dt + dt_bias)``, and returns ``y_t = C_t h_t + D u_t`` and
the last state. It replaces no TPU kernel: the reference scans
(B, S, d_inner, d_state) tensors with ``lax.associative_scan``, and so does
the plain version (``models.mamba.selective_scan_ref``), which holds about
20 GB a layer at d_inner 5120 and 4096 tokens. The kernel is CUDA C++ for
``sm_90a`` in ``csrc/selective_scan.cu`` (its header says what bounds it and
how its design answers that), forward and backward, built with ``nvcc`` at
first use and bound with ``ctypes``; it keeps the state in registers and
writes only y, the last state and the state at each 32-step chunk's start,
from which the backward recomputes each chunk.

CPU tensors take the plain version (today's discretisation and
``_ssm_chunked``, autograd through plain tensor ops); CUDA tensors launch the
kernels, or the call raises. On the card the call is a
``torch.autograd.Function``: its gradients of ``a``, ``d_skip`` and
``dt_bias`` are summed in a fixed order, so every run and every CUDA graph
replay gives the same bits. Each launch counts in ``kernels.LAUNCHES``
(``selective_scan``, forward and recompute; ``selective_scan_bwd``) and runs
inside a ``mamba.scan`` span (direction, layer, tokens).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.nvcc import build_library, load_library
from repro_torch.spans import span

__all__ = ["SOURCE", "MAX_STATE", "build", "load", "selective_scan"]

SOURCE = Path(__file__).parent / "csrc" / "selective_scan.cu"
_BUILD_DIR = Path(__file__).parent / "build"
MAX_STATE = 16
CHANNELS = 16  # channels a block of the kernel (its CH): the rows of the dB / dC parts

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``csrc/selective_scan.cu`` into a shared library (cached by
    source hash) and return its path. Raises if ``nvcc`` is missing or
    fails."""
    return build_library(SOURCE, _BUILD_DIR)


def load(device: torch.device | None = None) -> ctypes.CDLL:
    """Build and load the library once, and load its kernels on ``device``
    (None: the current card), so that a CUDA graph captured there can record
    a launch. A launch does this on its tensors' card itself."""
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        _lib = load_library(build(), {
            "selective_scan_fwd": [p] * 11 + [i64] * 4 + [p],
            "selective_scan_bwd": [p] * 18 + [i64] * 4 + [p],
            "selective_scan_load": [],
            "selective_scan_chunk": [],
        })
        _lib.devices = set()
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _lib.devices:
        with torch.cuda.device(index):
            rc = _lib.selective_scan_load()
        if rc != 0:
            raise RuntimeError(f"selective_scan failed to load on cuda:{index}: CUDA error {rc}")
        _lib.devices.add(index)
    return _lib


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dt, dt_bias, a, bmat, cmat, d_skip, h0, layer):
        b, s, d = u.shape
        n = a.shape[1]
        dev = u.device
        lib = load(dev)
        nc = -(-s // lib.selective_scan_chunk())
        y = torch.empty_like(u)
        h_last = torch.empty((b, d, n), dtype=torch.float32, device=dev)
        states = torch.empty((b, nc, d, n), dtype=torch.float32, device=dev)
        with span("mamba.scan", direction="forward", layer=layer, tokens=b * s), \
                torch.cuda.device(dev):
            rc = lib.selective_scan_fwd(
                u.data_ptr(), dt.data_ptr(), dt_bias.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                cmat.data_ptr(), d_skip.data_ptr(), _ptr(h0), y.data_ptr(), h_last.data_ptr(),
                states.data_ptr(), b, s, d, n, torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"selective_scan launch failed: CUDA error {rc}")
            count_launch("selective_scan")
        ctx.save_for_backward(u, dt, dt_bias, a, bmat, cmat, d_skip, states)
        ctx.has_h0, ctx.layer = h0 is not None, layer
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, dt_bias, a, bmat, cmat, d_skip, states = ctx.saved_tensors
        b, s, d = u.shape
        n = a.shape[1]
        dev = u.device
        lib = load(dev)
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        dh_last = None if dh_last is None else dh_last.contiguous()
        tiles = -(-d // CHANNELS)
        du, ddt = torch.empty_like(u), torch.empty_like(u)
        da = torch.empty((b, d, n), dtype=torch.float32, device=dev)
        dd = torch.empty((b, d), dtype=torch.float32, device=dev)
        dbias = torch.empty((b, d), dtype=torch.float32, device=dev)
        db = torch.empty((tiles, b, s, n), dtype=torch.float32, device=dev)
        dc = torch.empty((tiles, b, s, n), dtype=torch.float32, device=dev)
        dh0 = torch.empty((b, d, n), dtype=torch.float32, device=dev) if ctx.has_h0 else None
        with span("mamba.scan", direction="backward", layer=ctx.layer, tokens=b * s), \
                torch.cuda.device(dev):
            rc = lib.selective_scan_bwd(
                u.data_ptr(), dt.data_ptr(), dt_bias.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                cmat.data_ptr(), d_skip.data_ptr(), states.data_ptr(), dy.data_ptr(),
                _ptr(dh_last), du.data_ptr(), ddt.data_ptr(), da.data_ptr(), dd.data_ptr(),
                dbias.data_ptr(), db.data_ptr(), dc.data_ptr(), _ptr(dh0), b, s, d, n,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"selective_scan backward launch failed: CUDA error {rc}")
            count_launch("selective_scan_bwd")
        return (du, ddt, dbias.sum(0), da.sum(0), db.sum(0), dc.sum(0), dd.sum(0), dh0, None)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None, *, chunk: int = 256,
                   layer: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, di), h_last (B, di, n)), f32.

    u: (B, S, di) the mixer's input after the conv and SiLU, in any float
    dtype (the scan reads it in f32); dt: (B, S, di) before ``dt_bias`` and
    the softplus; dt_bias, d_skip: (di,); a: (di, n), ``-exp(a_log)``;
    bmat, cmat: (B, S, n); h0: (B, di, n) or None (zeros). The rest f32.
    CPU (and ``meta``) tensors take the plain version, whose in-chunk scan
    spans ``chunk`` steps; CUDA tensors launch the kernel (n <= 16), or the
    call raises.
    ``layer`` labels the spans."""
    args = (u, dt, dt_bias, a, bmat, cmat, d_skip)
    if not u.is_floating_point():
        raise TypeError(f"selective_scan takes a float u, got {u.dtype}")
    if u.dim() != 3 or dt.shape != u.shape or bmat.dim() != 3 or cmat.shape != bmat.shape:
        raise ValueError(f"selective_scan: u {tuple(u.shape)}, dt {tuple(dt.shape)}, B "
                         f"{tuple(bmat.shape)} and C {tuple(cmat.shape)} do not fit")
    if any(x.dtype is not torch.float32 for x in args[1:]) or (
            h0 is not None and h0.dtype is not torch.float32):
        raise TypeError("selective_scan takes f32 tensors")
    dev = u.device
    if dev.type in ("cpu", "meta"):  # meta: the dry-run's shapes, as the plain version gives them
        from repro_torch.models.mamba import selective_scan_ref

        return selective_scan_ref(*args, h0, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on CUDA, CPU or meta tensors, got {dev}")
    if any(x.device != dev for x in args) or (h0 is not None and h0.device != dev):
        raise ValueError("selective_scan: every tensor must be on one card")
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the selective scan kernel takes d_state up to {MAX_STATE}, got {n}")
    return _Scan.apply(u.float().contiguous(), *(x.contiguous() for x in args[1:]),
                       None if h0 is None else h0.contiguous(), layer)
