"""RWKV-6 ("Finch") block: token-shift mixing and the data-dependent-decay
WKV recurrence, plus RWKV's squared-relu channel mixing. The port of
``repro/models/rwkv.py``.

Per head of size D the time-mixing state is a (D, D) matrix S with a
per-token diagonal decay w_t:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

As in the reference, the recurrence runs chunk by chunk in the chunked
linear-attention form (an intra-chunk pairwise term under a decay-ratio
mask, an inter-chunk state term, both in f32), and a Python loop carries S
across chunks. Decode (S == 1 with a cache) is the exact single step. A
given cache is updated in place and returned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _full, _normal, rms_norm

__all__ = ["RWKVSpec", "init_rwkv", "init_rwkv_cache", "init_rwkv_ffn", "rwkv_block",
           "rwkv_ffn"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64
    # chunk * |log w|_max must stay below ~80 so the intra-chunk exp(-cum)
    # cannot overflow f32 (see the clamp in rwkv_block): 32 * 2 = 64 < 80.
    chunk: int = 32

    def heads(self, d_model: int) -> int:
        if d_model % self.head_dim:
            raise ValueError(f"d_model {d_model} is not a multiple of head_dim {self.head_dim}")
        return d_model // self.head_dim


def init_rwkv(gen: torch.Generator | None, d_model: int, spec: RWKVSpec, dtype,
              lead: tuple[int, ...] = ()) -> PyTree:
    """Weights drawn from ``gen`` on its device; ``lead`` prepends axes."""
    h, hd, lora = spec.heads(d_model), spec.head_dim, spec.decay_lora
    s = d_model**-0.5

    def lin(i, o, sc):
        return _normal(gen, lead + (i, o), sc, dtype)

    return {
        # token-shift interpolation factors per channel: r, k, v, g, w
        "mu": _full(gen, lead + (5, d_model), 0.5, dtype),
        "wr": lin(d_model, d_model, s),
        "wk": lin(d_model, d_model, s),
        "wv": lin(d_model, d_model, s),
        "wg": lin(d_model, d_model, s),
        "w_base": _full(gen, lead + (d_model,), -6.0, torch.float32),
        "w_lora_a": lin(d_model, lora, s),
        "w_lora_b": lin(lora, d_model, lora**-0.5),
        "u_bonus": _normal(gen, lead + (h, hd), 0.1, torch.float32),
        "wo": lin(d_model, d_model, s),
        "ln_w": _full(gen, lead + (d_model,), 1.0, dtype),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} for every t: zero (or ``prev``, the cache) at the first."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    first = (torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, w, u, s0, chunk):
    """Chunked WKV recurrence. r, k, v, w: (B, S, H, D), w the per-step
    decay in (0, 1); u: (H, D); s0: (B, H, D, D). Returns (out (B, S, H, D)
    f32, the last state)."""
    b, s, h, d = r.shape
    pad = (-s) % chunk
    if pad:
        zp = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, zp), F.pad(k, zp), F.pad(v, zp)
        w = F.pad(w, zp, value=1.0)
    nc = (s + pad) // chunk

    def resh(x):
        return x.reshape(b, nc, chunk, h, d).transpose(0, 1)

    rc, kc, vc, wc = map(resh, (r, k, v, w))
    logw = torch.log(torch.clamp_min(wc, 1e-12)).float()
    cum = torch.cumsum(logw, dim=2)  # (nc, B, C, H, D): log-decay through t
    rc, kc, vc = rc.float(), kc.float(), vc.float()
    c_idx = torch.arange(chunk, device=r.device)
    mask = (c_idx[:, None] > c_idx[None, :]).float()  # strictly earlier positions

    state = s0.float()
    outs = []
    for i in range(nc):
        rb, kb, vb, cumb = rc[i], kc[i], vc[i], cum[i]  # (B, C, H, D)
        cum_prev = cumb - logw[i]  # log prod_{j<t} w_j within the chunk
        q_dec = rb * torch.exp(cum_prev)
        # inter-chunk: o[t] = (r_t * exp(cum_prev_t)) @ S
        o_inter = torch.einsum("bchd,bhde->bche", q_dec, state)
        # intra-chunk: A[t, g] = sum_d r_t exp(cum_prev_t - cum_g) k_g for g < t,
        # and the bonus u at g == t.
        k_dec = kb * torch.exp(-cumb)
        att = torch.einsum("bchd,bghd->bhcg", q_dec, k_dec) * mask
        diag = (rb * u * kb).sum(dim=-1)  # (B, C, H)
        o_intra = torch.einsum("bhcg,bghe->bche", att, vb) + diag[..., None] * vb
        # S' = diag(prod_chunk w) S + sum_g exp(cum_last - cum_g) k_g^T v_g
        total = cumb[:, -1:]  # (B, 1, H, D)
        k_tail = kb * torch.exp(total - cumb)
        state = torch.exp(total[:, 0])[..., None] * state + torch.einsum(
            "bchd,bche->bhde", k_tail, vb)
        outs.append(o_inter + o_intra)
    out = torch.stack(outs).transpose(0, 1).reshape(b, nc * chunk, h, d)[:, :s]
    return out, state


def rwkv_block(p: PyTree, x: torch.Tensor, spec: RWKVSpec, *,
               cache: PyTree | None = None) -> tuple[torch.Tensor, PyTree | None]:
    """Time-mixing RWKV-6 block. cache = {"shift": (B, d), "wkv": (B, H, D, D)},
    updated in place."""
    b, s, d = x.shape
    h, hd = spec.heads(d), spec.head_dim
    prev = cache["shift"] if cache is not None else None
    xp = _token_shift(x, prev)

    def mix(i):
        mu = p["mu"][i][None, None]
        return x * mu + xp * (1.0 - mu)

    r = (mix(0) @ p["wr"]).reshape(b, s, h, hd)
    k = (mix(1) @ p["wk"]).reshape(b, s, h, hd)
    v = (mix(2) @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(mix(3) @ p["wg"])
    wx = mix(4).float()
    dec = p["w_base"] + torch.tanh(wx @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    # The per-step log-decay clamped so the chunked form's exp(-cumsum)
    # stays within f32 (chunk 32: exp(64) at most).
    dec = torch.clamp(dec, -20.0, math.log(2.0))
    w = torch.exp(-torch.exp(dec)).reshape(b, s, h, hd)  # decay in (0, 1)

    if cache is not None:
        s0 = cache["wkv"].float()
    else:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    if s == 1 and cache is not None:
        rf, kf, vf, wf = (t[:, 0].float() for t in (r, k, v, w))
        o = torch.einsum("bhd,bhde->bhe", rf, s0) + (
            (rf * p["u_bonus"] * kf).sum(dim=-1)[..., None] * vf)
        s_new = wf[..., None] * s0 + torch.einsum("bhd,bhe->bhde", kf, vf)
        out = o[:, None]
    else:
        out, s_new = _wkv_chunked(r, k, v, w, p["u_bonus"], s0, spec.chunk)

    out = rms_norm(out.reshape(b, s, d).to(x.dtype), p["ln_w"])
    y = (out * g) @ p["wo"]
    if cache is not None:
        cache["shift"].copy_(x[:, -1])
        cache["wkv"].copy_(s_new)
    return y.to(x.dtype), cache


def init_rwkv_cache(batch: int, d_model: int, spec: RWKVSpec, dtype, device,
                    lead: tuple[int, ...] = ()) -> PyTree:
    """Zero token-shift state (param dtype) and WKV state (f32); ``lead``
    prepends axes (the stacked group axis)."""
    h, hd = spec.heads(d_model), spec.head_dim
    return {
        "shift": torch.zeros(lead + (batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros(lead + (batch, h, hd, hd), dtype=torch.float32, device=device),
    }


# -- channel mixing (squared-relu FFN with token shift) ------------------------


def init_rwkv_ffn(gen: torch.Generator | None, d_model: int, d_ff: int, dtype,
                  lead: tuple[int, ...] = ()) -> PyTree:
    s = d_model**-0.5
    return {
        "mu": _full(gen, lead + (2, d_model), 0.5, dtype),
        "wk": _normal(gen, lead + (d_model, d_ff), s, dtype),
        "wv": _normal(gen, lead + (d_ff, d_model), d_ff**-0.5, dtype),
        "wr": _normal(gen, lead + (d_model, d_model), s, dtype),
    }


def rwkv_ffn(p: PyTree, x: torch.Tensor, *,
             cache: PyTree | None = None) -> tuple[torch.Tensor, PyTree | None]:
    """cache = {"shift": (B, d)}, updated in place."""
    prev = cache["shift"] if cache is not None else None
    xp = _token_shift(x, prev)
    mu_k, mu_r = p["mu"][0][None, None], p["mu"][1][None, None]
    xk = x * mu_k + xp * (1 - mu_k)
    xr = x * mu_r + xp * (1 - mu_r)
    k = torch.square(F.relu(xk @ p["wk"]))
    y = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    if cache is not None:
        cache["shift"].copy_(x[:, -1])
    return y.to(x.dtype), cache
