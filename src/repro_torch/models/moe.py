"""Mixture-of-Experts FFN: top-k router and capacity-based dispatch/combine.
The port of ``repro/models/moe.py``.

The formulation is the reference's (GShard/Switch): routing builds one-hot
dispatch and combine tensors, and the experts run as dense batched matmuls
over an explicit expert axis, with no gather or scatter. Tokens go in
routing groups of ``group_size``; each group has its own capacity, and a
token past its expert's capacity is dropped. The switch auxiliary loss is
returned beside the output, averaged over the groups.

The one-hots are comparisons with ``arange``, so nothing here waits on the
host: the fused LM path captures it in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.layers import _normal, init_ffn, swiglu_ffn

__all__ = ["MoESpec", "init_moe", "moe_ffn"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0
    # Routing-group size: the (Tg, E, Cg) one-hots exist per group, never
    # for the whole token stream.
    group_size: int = 2048


def init_moe(gen: torch.Generator | None, d_model: int, spec: MoESpec, dtype,
             lead: tuple[int, ...] = ()) -> PyTree:
    """Router (f32) and expert weights drawn from ``gen`` on its device;
    ``lead`` prepends axes (the stacked group axis)."""
    e, ff = spec.num_experts, spec.d_ff
    s_in = d_model**-0.5
    p = {
        "router": _normal(gen, lead + (d_model, e), s_in, torch.float32),
        "w_gate": _normal(gen, lead + (e, d_model, ff), s_in, dtype),
        "w_in": _normal(gen, lead + (e, d_model, ff), s_in, dtype),
        "w_out": _normal(gen, lead + (e, ff, d_model), ff**-0.5, dtype),
    }
    if spec.dense_residual:
        p["dense"] = init_ffn(gen, d_model, spec.dense_d_ff or spec.d_ff, dtype, lead)
    return p


def _capacity(tokens: int, spec: MoESpec) -> int:
    c = int(spec.capacity_factor * spec.top_k * tokens / spec.num_experts)
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index, as
    ``jax.lax.top_k`` (``torch.topk`` does not promise an order among equal
    values; zero padding rows are all ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_group(p: PyTree, xt: torch.Tensor, spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, run the experts and combine for one token group.
    xt: (Tg, d) -> (out (Tg, d), aux 0-dim f32)."""
    t, d = xt.shape
    e, k = spec.num_experts, spec.top_k
    c = _capacity(t, spec)

    logits = xt.float() @ p["router"]  # (Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (Tg, k)
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)

    # Position of each (token, choice) in its expert's capacity buffer: the
    # count of earlier assignments to that expert, token-major.
    onehot = (expert_idx[..., None] == torch.arange(e, device=xt.device)).to(torch.int32)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos = (pos_in_expert * onehot).sum(dim=-1)  # (Tg, k)
    keep = pos < c  # tokens past capacity are dropped

    pos_oh = (pos[..., None] == torch.arange(c, device=xt.device)).float() * keep[..., None]
    onehot_f = onehot.float()
    disp = torch.einsum("tke,tkc->tec", onehot_f, pos_oh)
    comb = torch.einsum("tke,tkc->tec", onehot_f * gate_vals[..., None], pos_oh)

    ex_in = torch.einsum("tec,td->ecd", disp, xt.float()).to(xt.dtype)
    h = F.silu(torch.bmm(ex_in, p["w_gate"])) * torch.bmm(ex_in, p["w_in"])
    ex_out = torch.bmm(h, p["w_out"])
    out = torch.einsum("tec,ecd->td", comb, ex_out.float()).to(xt.dtype)

    # Switch aux loss: E * sum_e (top-1 assignment share) * (mean prob).
    frac = onehot_f[:, 0, :].mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out, aux


def moe_ffn(p: PyTree, x: torch.Tensor, spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss).

    Tokens are flattened to T = B*S and routed in groups of
    ``spec.group_size`` (the last one zero-padded); capacity and dropping
    are per group. With several groups and autograd on, each group is
    checkpointed, as the reference's ``jax.checkpoint`` under ``lax.map``:
    only one group's dispatch tensors are alive at a time.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    g = min(spec.group_size, t)
    pad = (-t) % g
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ngroups = (t + pad) // g
    xg = xt.reshape(ngroups, g, d)

    if ngroups == 1:
        out, aux = _moe_group(p, xg[0], spec)
    else:
        outs, auxes = [], []
        for i in range(ngroups):
            if torch.is_grad_enabled():
                # No random op runs here, so no RNG state is stashed.
                o, a = torch.utils.checkpoint.checkpoint(
                    _moe_group, p, xg[i], spec, use_reentrant=False, preserve_rng_state=False)
            else:
                o, a = _moe_group(p, xg[i], spec)
            outs.append(o)
            auxes.append(a)
        out = torch.cat(outs)
        aux = torch.stack(auxes).mean()
    out = out[:t].reshape(b, s, d)

    if spec.dense_residual:
        out = out + swiglu_ffn(p["dense"], x)
    return out, aux
