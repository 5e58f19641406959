"""One LM cohort member's first weights, made from the run's seed and the
configuration file's published numbers (nothing of the program).

The tree is laid out as the program and the plain reference read it:
``embed`` (vocab, d; tied, so also the output layer), ``final_norm``, and
``blocks["layer{i}"]`` for each layer of one period, every leaf with a
leading axis over the periods. A Jamba layer holds ``norm1``, ``norm2``, a
dense SwiGLU ``ffn`` and either ``attn`` (multi-query projections) or
``mamba`` (a Mamba-1 mixer with Jamba's RMSNorms on dt, B and C).

Draws, one ``torch.Generator`` on the run's device seeded from (seed, 5),
leaf after leaf in sorted path order:

- every projection and the embedding: a normal of std fan_in^-1/2 (the
  embedding's fan-in taken as d);
- the depthwise conv's taps: a normal of std 0.2; its bias 0;
- ``dt_bias``: Mamba's init, the inverse softplus of a dt drawn
  log-uniformly in [1e-3, 1e-1];
- ``a_log`` = log(1 .. d_state) in every channel (Mamba's S4D-real A),
  ``d_skip`` and every norm's weight 1.

Leaves are in ``param_dtype`` but ``a_log``, ``dt_bias`` and ``d_skip``, in
``ssm_param_dtype``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

__all__ = ["shapes", "init_member"]

_SLAB = 1 << 24
_SSM = ("a_log", "dt_bias", "d_skip")


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0] >> 1)


def shapes(conf: dict[str, Any]) -> dict[tuple[str, ...], tuple[int, ...]]:
    """Each leaf's path and shape, from the configuration's numbers."""
    d, v, f = conf["hidden_size"], conf["vocab_size"], conf["intermediate_size"]
    h, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // h
    n, k = conf["mamba_d_state"], conf["mamba_d_conv"]
    di = conf["mamba_expand"] * d
    dr = conf["mamba_dt_rank"] or math.ceil(d / 16)
    period, offset = conf["attn_layer_period"], conf["attn_layer_offset"]
    layers = conf["num_hidden_layers"]
    if layers % period:
        raise ValueError(f"{layers} layers are not whole periods of {period}")
    g = layers // period
    out = {("embed",): (v, d), ("final_norm", "w"): (d,)}
    for i in range(period):
        at = ("blocks", f"layer{i}")
        out.update({at + ("norm1", "w"): (g, d), at + ("norm2", "w"): (g, d),
                    at + ("ffn", "w_gate"): (g, d, f), at + ("ffn", "w_in"): (g, d, f),
                    at + ("ffn", "w_out"): (g, f, d)})
        if i == offset:
            out.update({at + ("attn", "wq"): (g, d, h * hd), at + ("attn", "wk"): (g, d, hkv * hd),
                        at + ("attn", "wv"): (g, d, hkv * hd), at + ("attn", "wo"): (g, h * hd, d)})
            continue
        m = at + ("mamba",)
        out.update({m + ("in_proj",): (g, d, 2 * di), m + ("conv_w",): (g, k, di),
                    m + ("conv_b",): (g, di), m + ("x_proj",): (g, di, dr + 2 * n),
                    m + ("dt_norm",): (g, dr), m + ("b_norm",): (g, n), m + ("c_norm",): (g, n),
                    m + ("dt_proj",): (g, dr, di), m + ("dt_bias",): (g, di),
                    m + ("a_log",): (g, di, n), m + ("d_skip",): (g, di),
                    m + ("out_proj",): (g, di, d)})
    return dict(sorted(out.items()))


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _SLAB):
        m = min(_SLAB, flat.numel() - i)
        flat[i:i + m] = torch.randn(m, generator=gen, device=device).mul_(std)
    return out


def _dt_bias(gen: torch.Generator, shape, device) -> torch.Tensor:
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo)
    return dt + torch.log(-torch.expm1(-dt))


def _leaf(gen, path, shape, dtype, device) -> torch.Tensor:
    name = path[-1]
    if name == "w" or name.endswith("_norm") or name == "d_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "conv_b":
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "conv_w":
        return _normal(gen, shape, 0.2, dtype, device)
    if name == "dt_bias":
        return _dt_bias(gen, shape, device).to(dtype)
    if name == "a_log":
        n = shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return a.expand(shape).to(dtype).contiguous()
    fan_in = shape[-1] if name == "embed" else shape[-2]
    return _normal(gen, shape, fan_in ** -0.5, dtype, device)


def init_member(conf: dict[str, Any], seed: int,
                device: torch.device) -> dict[tuple[str, ...], torch.Tensor]:
    """Each leaf's path and first weights, on ``device``."""
    dtype = getattr(torch, conf["param_dtype"])
    ssm = getattr(torch, conf["ssm_param_dtype"])
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 5))
    return {path: _leaf(gen, path, shape, ssm if path[-1] in _SSM else dtype, device)
            for path, shape in shapes(conf).items()}
