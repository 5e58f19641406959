"""Mamba (selective SSM) block. The port of ``repro/models/mamba.py``.

As in the reference, the recurrence ``h_t = a_t * h_{t-1} + b_t`` runs as a
chunked scan: within a chunk a log-depth parallel prefix scan with the
reference's ``combine``, and a Python loop carries the state from chunk to
chunk, so the largest state tensor is one chunk's (B, chunk, d_inner,
d_state). PyTorch has no associative scan: the in-chunk scan here is
``jax.lax.associative_scan``'s odd/even recursion written in plain tensor
ops (``_prefix_scan``).

The scan itself (discretisation, recurrence, read-out and the D skip) is
``kernels.ops.selective_scan``: on CPU tensors the plain version, which is
the chunked scan above, and on the card the hand-written CUDA selective scan,
which never holds a (B, S, d_inner, d_state) tensor. ``MambaSpec.inner_norms``
adds Jamba's RMSNorms on dt, B and C (arXiv:2403.19887, section 6.4) before
``dt_proj`` and the scan; off by default, as in the reference.

Decode (S == 1 with a cache) is the exact single step. A given cache
(``{"conv", "ssm"}``) is updated in place and returned, as the port's
attention caches are.

Dtypes are the reference's: the projections run in the param dtype, the
SSM (dt, a_bar, B x, C, the state) in f32, with the f32 leaves ``a_log``,
``dt_bias`` and ``d_skip`` inside a bf16 model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _ops
from repro_torch.models.layers import _full, _normal, rms_norm

__all__ = ["MambaSpec", "init_mamba", "init_mamba_cache", "mamba_block", "selective_scan_ref"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256
    inner_norms: bool = False  # RMSNorms on dt, B and C (Jamba), a port-only field

    def inner(self, d_model: int) -> int:
        return self.expand * d_model

    def rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, (d_model + 15) // 16)


def init_mamba(gen: torch.Generator | None, d_model: int, spec: MambaSpec, dtype,
               lead: tuple[int, ...] = ()) -> PyTree:
    """Weights drawn from ``gen`` on its device; ``lead`` prepends axes."""
    di, dr, n = spec.inner(d_model), spec.rank(d_model), spec.d_state
    dev = torch.device("meta") if gen is None else gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    norms = {}
    if spec.inner_norms:
        norms = {"dt_norm": _full(gen, lead + (dr,), 1.0, dtype),
                 "b_norm": _full(gen, lead + (n,), 1.0, dtype),
                 "c_norm": _full(gen, lead + (n,), 1.0, dtype)}
    return {
        "in_proj": _normal(gen, lead + (d_model, 2 * di), d_model**-0.5, dtype),
        "conv_w": _normal(gen, lead + (spec.d_conv, di), 0.2, dtype),
        "conv_b": _full(gen, lead + (di,), 0.0, dtype),
        "x_proj": _normal(gen, lead + (di, dr + 2 * n), di**-0.5, dtype),
        "dt_proj": _normal(gen, lead + (dr, di), dr**-0.5, dtype),
        "dt_bias": _full(gen, lead + (di,), -4.0, torch.float32),  # softplus(-4): small dt
        "a_log": a_log.expand(lead + (di, n)).contiguous(),
        "d_skip": _full(gen, lead + (di,), 1.0, torch.float32),
        "out_proj": _normal(gen, lead + (di, d_model), di**-0.5, dtype),
        **norms,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv over time. x: (B, S, di); w: (K, di). Returns
    (y, the last K-1 inputs: the next call's state)."""
    k = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(ctx[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    new_state = ctx[:, -(k - 1):, :] if k > 1 else None
    return (y + b[None, None, :]).to(x.dtype), new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[even0, odd0, even1, odd1, ...] along axis 1 (``even`` may be one longer)."""
    pairs = torch.stack([even[:, :odd.shape[1]], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == odd.shape[1] else torch.cat([pairs, even[:, -1:]], dim=1)


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) along axis 1 under the reference's
    ``combine((al, bl), (ar, br)) = (al * ar, bl * ar + br)``, by the
    odd/even recursion of ``jax.lax.associative_scan``: combine neighbouring
    pairs, scan the pairs (the prefixes that end at odd positions), then
    extend each to the even position after it. Log depth, O(length) work."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_odd = a[:, 1::2]
    oa, ob = _prefix_scan(a[:, 0:-1:2] * a_odd, b[:, 0:-1:2] * a_odd + b[:, 1::2])
    pa, pb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    a_even = a[:, 2::2]
    ea = torch.cat([a[:, :1], pa * a_even], dim=1)
    eb = torch.cat([b[:, :1], pb * a_even + b[:, 2::2]], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _ssm_chunked(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor, h0: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve h_t = a_t * h_{t-1} + bx_t, y_t = sum_n c_tn h_tn.
    a, bx: (B, S, di, n); c: (B, S, n); h0: (B, di, n). Returns (y, h_last)."""
    s = a.shape[1]
    pad = (-s) % chunk
    if pad:
        # a pads with 1 and bx with 0, as in the reference: the padded steps
        # carry the state through unchanged.
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
    h = h0
    hs = []
    for i in range(0, s + pad, chunk):
        aa, bb = _prefix_scan(a[:, i:i + chunk], bx[:, i:i + chunk])
        hc = aa * h[:, None] + bb  # h_t for every t of the chunk
        h = hc[:, -1]
        hs.append(hc)
    hs = torch.cat(hs, dim=1)[:, :s]
    return torch.einsum("bsdn,bsn->bsd", hs, c), h


def mamba_block(p: PyTree, x: torch.Tensor, spec: MambaSpec, *,
                cache: PyTree | None = None, eps: float = 1e-5,
                layer: int | None = None) -> tuple[torch.Tensor, PyTree | None]:
    """x: (B, S, d_model) -> (y, cache). cache = {"conv": (B, K-1, di),
    "ssm": (B, di, n)}, updated in place. ``eps`` is the inner norms'
    (``spec.inner_norms``); ``layer`` labels the scan's spans."""
    b, s, d = x.shape
    n = spec.d_state

    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = (xs @ p["x_proj"]).float()  # (B, S, dr + 2n)
    dr = spec.rank(d)
    dt, bmat, cmat = proj.split([dr, n, n], dim=-1)
    if spec.inner_norms:
        dt = rms_norm(dt, p["dt_norm"], eps)
        bmat = rms_norm(bmat, p["b_norm"], eps)
        cmat = rms_norm(cmat, p["c_norm"], eps)
    dt = dt @ p["dt_proj"].float()  # (B, S, di), before the bias and softplus
    a = -torch.exp(p["a_log"])  # (di, n)

    h0 = cache["ssm"].float() if cache is not None else None
    if s == 1 and cache is not None:
        dt = F.softplus(dt + p["dt_bias"])
        a_bar = torch.exp(dt[..., None] * a[None, None])  # (B, 1, di, n)
        bx = (dt[..., None] * bmat[:, :, None, :]) * xs.float()[..., None]
        h_last = a_bar[:, 0] * h0 + bx[:, 0]
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0])[:, None]
        y = y + p["d_skip"][None, None] * xs.float()
    else:
        y, h_last = _ops.selective_scan(xs, dt, p["dt_bias"], a, bmat, cmat,
                                        p["d_skip"], h0, chunk=spec.chunk, layer=layer)

    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_last)
    return y.to(x.dtype), cache


def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
                       a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                       d_skip: torch.Tensor, h0: torch.Tensor | None = None, *,
                       chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the selective scan, as the reference computes it:
    dt = softplus(dt + dt_bias), a_bar = exp(dt a), b x = dt B u, the chunked
    recurrence (``_ssm_chunked``), y = C h + D u. u, dt: (B, S, di); a:
    (di, n); bmat, cmat: (B, S, n); h0: (B, di, n) or None (zeros). u may
    be in the param dtype: it is taken to f32 where each term reads it, as
    the reference does. Returns (y (B, S, di), h_last (B, di, n)), f32."""
    dt = F.softplus(dt + dt_bias)
    a_bar = torch.exp(dt[..., None] * a[None, None])  # (B, S, di, n)
    bx = (dt[..., None] * bmat[:, :, None, :]) * u.float()[..., None]
    if h0 is None:
        h0 = torch.zeros((u.shape[0], u.shape[2], a.shape[1]), dtype=torch.float32,
                         device=u.device)
    y, h_last = _ssm_chunked(a_bar, bx, cmat, h0, chunk)
    return y + d_skip[None, None] * u.float(), h_last


def init_mamba_cache(batch: int, d_model: int, spec: MambaSpec, dtype, device,
                     lead: tuple[int, ...] = ()) -> PyTree:
    """Zero conv state (param dtype) and SSM state (f32); ``lead``
    prepends axes (the stacked group axis)."""
    di = spec.inner(d_model)
    return {
        "conv": torch.zeros(lead + (batch, spec.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, di, spec.d_state), dtype=torch.float32, device=device),
    }
