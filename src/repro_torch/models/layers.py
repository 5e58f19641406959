"""Transformer layers: norms, RoPE, GQA attention (dense, chunked, sliding
window, prefill and cached decode over a ring-buffer KV cache, int8 KV),
and the SwiGLU / GELU FFNs. The port of ``repro/models/layers.py``.

Conventions, as in the reference:

- Plain functions over explicit parameter dicts of tensors.
- Parameters live in the param dtype (bf16 at scale); matmuls run in it,
  norm statistics, softmax and RoPE in f32.
- Activations are (B, S, d); attention weights are (d, H*hd) etc., so the
  head axis is a trailing reshape.

One difference: the KV cache is updated in place. ``attention_layer`` with a
cache writes the new K/V rows and advances ``index`` inside the tensors it
was given, and returns the same dict. The reference rebuilds the whole ring
every decode step; in place, a step writes one row per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _ops

__all__ = [
    "AttnSpec",
    "attention",
    "attention_layer",
    "apply_rope",
    "chunked_attention",
    "dense_attention",
    "gelu_ffn",
    "init_attention",
    "init_ffn",
    "layer_norm",
    "norm",
    "rms_norm",
    "rope_freqs",
    "swiglu_ffn",
]

PyTree = Any
INT32_MAX = int(np.iinfo(np.int32).max)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def norm(x: torch.Tensor, p: PyTree, kind: str = "rms", eps: float = 1e-5) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["w"], eps)
    return layer_norm(x, p["w"], p["b"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Rotates the interleaved
    (even, odd) pairs and re-interleaves them (not HF's ``rotate_half``)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
               window: int | None) -> torch.Tensor:
    """(..., S, T) additive bias: 0 where attendable, -inf where masked.
    Positions compare in int64, so the int32 sentinels cannot overflow."""
    q = qpos.long()[..., :, None]
    k = kpos.long()[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, -torch.inf)


def _bias5(bias: torch.Tensor) -> torch.Tensor:
    """(S, T) or (B, S, T) bias -> broadcastable against (B, Hkv, g, S, T)."""
    return bias[None, None, None] if bias.dim() == 2 else bias[:, None, None]


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
) -> torch.Tensor:
    """Materialized-logits attention. q: (B,S,H,hd), k/v: (B,T,Hkv,hd)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, s, hkv, g, hd)
    logits = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) * hd**-0.5
    bias = _bias5(_mask_bias(qpos, kpos, causal=causal, window=window))
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    kv_chunk: int = 1024,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """2D-tiled online-softmax attention: a loop over query chunks, and in
    each a loop over KV chunks; the largest logits tile is
    (B, q_chunk, H, kv_chunk), never (S, T). Padded query positions are
    ``INT32_MAX - 1`` and padded key positions ``INT32_MAX``, as in the
    reference. Padded keys are never attended; the reference attends them
    (as zero keys) when ``causal`` is False and T is not a multiple of
    ``kv_chunk``."""
    b, s, h, hd = q.shape
    if s > q_chunk:
        pad_q = (-s) % q_chunk
        if pad_q:
            q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
            qpos = torch.cat([qpos, qpos.new_full((pad_q,), INT32_MAX - 1)])
        outs = [
            chunked_attention(
                q[:, i:i + q_chunk], k, v, qpos[i:i + q_chunk], kpos,
                causal=causal, window=window, kv_chunk=kv_chunk, q_chunk=q_chunk,
            )
            for i in range(0, s + pad_q, q_chunk)
        ]
        return torch.cat(outs, dim=1)[:, :s]
    t, hkv = k.shape[1], k.shape[2]
    t_real = t
    if t % kv_chunk:
        pad = (-t) % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, kpos.new_full((pad,), INT32_MAX)])
        t += pad
    g = h // hkv
    qf = (q.float() * hd**-0.5).reshape(b, s, hkv, g, hd)
    m = torch.full((b, s, hkv, g, 1), -torch.inf, device=q.device)
    l = torch.zeros((b, s, hkv, g, 1), device=q.device)
    acc = torch.zeros((b, s, hkv, g, hd), device=q.device)
    for c0 in range(0, t, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].float()
        vb = v[:, c0:c0 + kv_chunk].float()
        logits = torch.einsum("bshgd,bchd->bshgc", qf, kb)
        bias = _mask_bias(qpos, kpos[c0:c0 + kv_chunk], causal=causal, window=window)
        if c0 + kv_chunk > t_real:
            bias[:, t_real - c0:] = -torch.inf  # the padded keys
        # Finite mask value: a fully masked chunk must not poison the online
        # max with -inf (exp(-inf - -inf) = nan); what such a chunk adds is
        # wiped by `corr` once a real chunk arrives.
        bias = torch.clamp_min(bias, -1e9)
        logits = logits + bias[None, :, None, None, :]
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bshgc,bchd->bshgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    kv_chunk: int = 1024,
    dense_threshold: int = 2048 * 2048,
) -> torch.Tensor:
    """Materialized attention up to S*T = ``dense_threshold`` (and always for
    one query), the 2D-tiled online softmax above it."""
    s, t = q.shape[1], k.shape[1]
    if s * t <= dense_threshold or s == 1:
        return dense_attention(q, k, v, qpos, kpos, causal=causal, window=window)
    return chunked_attention(q, k, v, qpos, kpos, causal=causal, window=window,
                             kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    window: int | None = None
    use_rope: bool = True
    # Route prefill attention through the CUDA flash-attention kernel
    # (``kernels.ops.flash_attention``) instead of ``attention``.
    flash: bool = False


# Draws are made in slabs of at most this many values.
_DRAW_SLAB = 1 << 28


def _normal(gen: torch.Generator | None, shape: tuple[int, ...], scale: float,
            dtype) -> torch.Tensor:
    """N(0, scale^2) draws from ``gen`` on its device; ``gen=None`` gives a
    tensor on the ``meta`` device (shape and dtype only, nothing drawn).
    The draws go into the leaf slab by slab, straight into its dtype, so no
    f32 copy of a large leaf exists (arctic's expert stacks hold 4.5 G
    values); a leaf of at most 2^28 values is one slab."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW_SLAB):
        m = min(_DRAW_SLAB, flat.numel() - i)
        flat[i:i + m] = torch.randn(m, generator=gen, device=gen.device).mul_(scale)
    return out


def _full(gen: torch.Generator | None, shape: tuple[int, ...], value: float,
          dtype) -> torch.Tensor:
    """A constant leaf on ``gen``'s device (``meta`` for ``gen=None``)."""
    dev = torch.device("meta") if gen is None else gen.device
    return torch.full(shape, value, dtype=dtype, device=dev)


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
                   lead: tuple[int, ...] = ()) -> PyTree:
    """Projection weights drawn from ``gen`` on its device; ``lead`` prepends
    axes (the stacked group axis)."""
    h, hkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    s_in = d_model**-0.5
    s_out = (h * hd) ** -0.5
    return {
        "wq": _normal(gen, lead + (d_model, h * hd), s_in, dtype),
        "wk": _normal(gen, lead + (d_model, hkv * hd), s_in, dtype),
        "wv": _normal(gen, lead + (d_model, hkv * hd), s_in, dtype),
        "wo": _normal(gen, lead + (h * hd, d_model), s_out, dtype),
    }


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the head_dim axis.
    x: (B, S, Hkv, hd) -> (int8 values, f32 scales (B, S, Hkv, 1))."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _write_prefill(cache: PyTree, k: torch.Tensor, v: torch.Tensor, s: int) -> None:
    """Write the last min(S, T) prompt positions into their ring slots."""
    t = cache["k"].shape[1]
    m = min(s, t)
    slots = torch.as_tensor(np.arange(s - m, s) % t, device=k.device)
    kw, vw = k[:, s - m:], v[:, s - m:]
    if cache["k"].dtype == torch.int8:
        kq, ks = _quant_kv(kw)
        vq, vs = _quant_kv(vw)
        cache["k"][:, slots] = kq
        cache["v"][:, slots] = vq
        cache["k_scale"][:, slots] = ks
        cache["v_scale"][:, slots] = vs
    else:
        cache["k"][:, slots] = kw.to(cache["k"].dtype)
        cache["v"][:, slots] = vw.to(cache["v"].dtype)


def attention_layer(
    p: PyTree,
    x: torch.Tensor,
    spec: AttnSpec,
    *,
    positions: torch.Tensor | None = None,
    cache: PyTree | None = None,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, PyTree | None]:
    """GQA attention over (B, S, d).

    Modes:
    - full sequence (cache=None): self-attention over x.
    - prefill (cache given, S > 1): the whole prompt in one pass, positions
      from 0, into a fresh cache; the ring keeps the last min(S, T) tokens.
    - decode (cache given, S == 1): one query against the ring cache of
      length T; ``index`` is a scalar (shared position) or (B,) (per slot).
    - cross (cross_kv=(k, v)): cross-attention, no rope, cache unused.

    A given cache is updated in place and returned.
    """
    b, s, _ = x.shape
    h, hkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)

    if cross_kv is not None:
        k, v = cross_kv
        t = k.shape[1]
        qpos = torch.arange(s, device=x.device)
        kpos = torch.arange(t, device=x.device)
        out = attention(q, k, v, qpos, kpos, causal=False, window=None)
        return (out.reshape(b, s, h * hd) @ p["wo"]).to(x.dtype), None

    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)

    if cache is None:
        pos = torch.arange(s, device=x.device) if positions is None else positions
        if spec.use_rope:
            q = apply_rope(q, pos, spec.rope_theta)
            k = apply_rope(k, pos, spec.rope_theta)
        out = attention(q, k, v, pos, pos, causal=spec.causal, window=spec.window)
        return (out.reshape(b, s, h * hd) @ p["wo"]).to(x.dtype), None

    if s > 1:
        # Prefill. Contract (the reference's): the cache is fresh, positions
        # start at 0, and the ring keeps the last min(S, T) prompt tokens.
        # Right-padded rows are safe only for S <= T (their padded slots sit
        # at or past the written index, which decode treats as unwritten);
        # prefill_forward rejects padding with S > T.
        pos = torch.arange(s, device=x.device)
        if spec.use_rope:
            q = apply_rope(q, pos, spec.rope_theta)
            k = apply_rope(k, pos, spec.rope_theta)
        if spec.flash:
            out = _ops.flash_attention(q, k, v, causal=spec.causal, window=spec.window)
        else:
            out = attention(q, k, v, pos, pos, causal=spec.causal, window=spec.window)
        _write_prefill(cache, k, v, s)
        cache["index"] += s
        return (out.reshape(b, s, h * hd) @ p["wo"]).to(x.dtype), cache

    # Decode: one new token against the ring cache. ``index`` is the int32
    # absolute position of the new token: a scalar shared by the batch, or
    # (B,) per slot (the continuous-batching engine).
    index = cache["index"].clone()
    t = cache["k"].shape[1]
    per_slot = index.dim() == 1
    qpos = index[:, None] if per_slot else index[None]
    if spec.use_rope:
        q = apply_rope(q, qpos, spec.rope_theta)
        k = apply_rope(k, qpos, spec.rope_theta)
    slot = torch.remainder(index, t).long()  # ring slot (t == window for SWA)
    rows = torch.arange(b, device=x.device)

    def put(buf: torch.Tensor, val: torch.Tensor) -> None:
        if per_slot:
            buf[rows, slot] = val[:, 0].to(buf.dtype)
        else:
            buf.index_copy_(1, slot.reshape(1), val.to(buf.dtype))

    if cache["k"].dtype == torch.int8:
        # int8 KV: per-(token, head) absmax scales; the error is bounded by
        # 1/127 of the head's absmax.
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        put(cache["k"], kq)
        put(cache["v"], vq)
        put(cache["k_scale"], ks)
        put(cache["v_scale"], vs)
        ck = cache["k"].float() * cache["k_scale"]
        cv = cache["v"].float() * cache["v_scale"]
    else:
        put(cache["k"], k)
        put(cache["v"], v)
        ck, cv = cache["k"], cache["v"]
    cache["index"] += 1
    # Absolute position of each ring slot, given ``index`` was just written;
    # slots not yet written get INT32_MAX (in the future: never attended).
    slots = torch.arange(t, device=x.device)
    idx, sl = index.long(), slot
    if per_slot:
        idx, sl, slots = idx[:, None], sl[:, None], slots[None, :]
    kpos = idx + slots - sl - torch.where(slots > sl, t, 0)
    kpos = torch.where(kpos < 0, INT32_MAX, kpos)
    out = attention(q, ck, cv, qpos, kpos, causal=True, window=spec.window)
    y = (out.reshape(b, 1, h * hd) @ p["wo"]).to(x.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             lead: tuple[int, ...] = ()) -> PyTree:
    s_in = d_model**-0.5
    s_out = d_ff**-0.5
    return {
        "w_gate": _normal(gen, lead + (d_model, d_ff), s_in, dtype),
        "w_in": _normal(gen, lead + (d_model, d_ff), s_in, dtype),
        "w_out": _normal(gen, lead + (d_ff, d_model), s_out, dtype),
    }


def swiglu_ffn(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    return ((F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]).to(x.dtype)


def gelu_ffn(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """2-matrix GELU FFN (tanh approximation, as ``jax.nn.gelu``'s default);
    reuses w_in/w_out."""
    return (F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]).to(x.dtype)
