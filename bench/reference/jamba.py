"""A plain PyTorch reference of AI21-Jamba2's hybrid block, trained as a DecAvg
cohort: the forward, the loss, the gradients and the rounds, written from the
published architecture (arXiv:2403.19887; the Jamba2 config) and nothing of
the port.

Plain ``torch`` in f32 (matmuls in full f32: the caller turns TF32 off), no
kernel, no cache, no batching across members: one member at a time, and
within a member one layer at a time (the forward keeps each layer's input;
the backward recomputes that layer with autograd on and takes its vector-
Jacobian product), so a full-width member fits on one card. The selective
scan runs sequentially in time: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t``
one step after another, with ``exp(dt A)`` and ``dt B u`` formed a block of
steps at a time.

Weights come in the port's tree layout (``embed``, ``blocks["layer{i}"]``
with a leading group axis, ``final_norm``), as the run's inputs, whatever
made them. Departures from the published model, each also the program's:

- the layer stack is the config's (one period of 14 in the benchmark);
- a leaf is stored in the dtype it was handed in (bf16 weights, f32
  ``a_log``, ``dt_bias`` and ``d_skip``): after each update and each gossip
  its f32 result is rounded to that dtype, as the configuration states its
  parameters, while every computation runs in f32;
- SGD with momentum 0.5 and a cosine LR schedule whose round-0 rate is 0
  (no warm-up rounds: ``min(round / 1, 1)``), DecAvg's Eq. 1 with equal data
  sizes: ``W_ij = 1 / (deg_i + 1)`` over the closed neighbourhood.

``precision="fp8"`` rounds every matmul's operands to float8 e4m3 first
(gradients pass straight through the rounding): the control reading, one
precision below the configuration's bf16.

This file is the program-independent reference of the CPU tests; the
benchmark keeps a copy as ``bench/reference/jamba.py``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Arch", "loss_and_grads", "forward_logits", "cohort_rounds", "eq1_matrix",
           "cosine_lr"]

SCAN_BLOCK = 256


class Arch:
    """The numbers the reference reads from a config: a dict or any object
    with the config's attribute names."""

    def __init__(self, cfg: Any, precision: str = "f32"):
        get = cfg.get if isinstance(cfg, dict) else (lambda k: getattr(cfg, k))
        mamba = get("mamba")
        mget = mamba.get if isinstance(mamba, dict) else (lambda k: getattr(mamba, k))
        self.d = int(get("d_model"))
        self.heads, self.kv_heads = int(get("num_heads")), int(get("num_kv_heads"))
        self.hd = int(get("head_dim")) or self.d // self.heads
        self.eps = float(get("norm_eps"))
        self.mixers = [s if isinstance(s, str) else s.mixer for s in get("pattern")]
        self.groups = int(get("num_layers")) // len(self.mixers)
        self.d_state = int(mget("d_state"))
        self.dt_rank = int(mget("dt_rank")) or math.ceil(self.d / 16)
        self.inner_norms = bool(mget("inner_norms"))
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision is f32 or fp8, not {precision!r}")
        self.precision = precision


def _q(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 in the forward; the identity's gradient."""
    return x + (x.to(torch.float8_e4m3fn).float() - x).detach()


def _mm(arch: Arch, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if arch.precision == "fp8":
        a, b = _q(a), _q(b)
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: x (B, S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = b
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
         cm: torch.Tensor, state_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y_t = sum_n C_tn h_tn, with h_t = exp(dt_t a) h_{t-1} + dt_t B_t u_t
    from h_{-1} = 0, one step after another. u, dt: (B, S, di); a: (di, n);
    bm, cm: (B, S, n). ``state_dtype`` rounds the state to that dtype after
    every step (a control reading below the scan's f32)."""
    b, s, di = u.shape
    h = u.new_zeros((b, di, a.shape[1]))
    ys = []
    for t0 in range(0, s, SCAN_BLOCK):
        sl = slice(t0, t0 + SCAN_BLOCK)
        decay = torch.exp(dt[:, sl, :, None] * a)
        push = (dt[:, sl, :, None] * bm[:, sl, None, :]) * u[:, sl, :, None]
        hs = []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + push[:, t]
            if state_dtype is not None:
                h = h.to(state_dtype).float()
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, dim=1), cm[:, sl]))
    return torch.cat(ys, dim=1)


def _mamba(arch: Arch, p: dict, x: torch.Tensor) -> torch.Tensor:
    n, dr = arch.d_state, arch.dt_rank
    xs, z = _mm(arch, x, p["in_proj"]).chunk(2, dim=-1)
    xs = F.silu(_conv(xs, p["conv_w"], p["conv_b"]))
    dt, bm, cm = _mm(arch, xs, p["x_proj"]).split([dr, n, n], dim=-1)
    if arch.inner_norms:
        dt = rms_norm(dt, p["dt_norm"], arch.eps)
        bm = rms_norm(bm, p["b_norm"], arch.eps)
        cm = rms_norm(cm, p["c_norm"], arch.eps)
    dt = F.softplus(_mm(arch, dt, p["dt_proj"]) + p["dt_bias"])
    y = scan(xs, dt, -torch.exp(p["a_log"]), bm, cm) + p["d_skip"] * xs
    return _mm(arch, y * F.silu(z), p["out_proj"])


def _attention(arch: Arch, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal multi-query / grouped attention with no positional encoding."""
    b, s, _ = x.shape
    h, hkv, hd = arch.heads, arch.kv_heads, arch.hd
    q = _mm(arch, x, p["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = _mm(arch, x, p["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _mm(arch, x, p["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    logits = _mm(arch, q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    out = _mm(arch, probs, v).transpose(1, 2).reshape(b, s, h * hd)
    return _mm(arch, out, p["wo"])


def _ffn(arch: Arch, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _mm(arch, F.silu(_mm(arch, x, p["w_gate"])) * _mm(arch, x, p["w_in"]), p["w_out"])


def _layer(arch: Arch, mixer: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm1"]["w"], arch.eps)
    x = x + (_attention(arch, p["attn"], h) if mixer == "attn" else _mamba(arch, p["mamba"], h))
    return x + _ffn(arch, p["ffn"], rms_norm(x, p["norm2"]["w"], arch.eps))


def _layers(arch: Arch, params: dict):
    """(mixer, that layer's leaves at its group, path) in stack order."""
    for g in range(arch.groups):
        for i, mixer in enumerate(arch.mixers):
            yield mixer, _index(params["blocks"][f"layer{i}"], g), (f"layer{i}", g)


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _loss(arch: Arch, params: dict, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, params["final_norm"]["w"], arch.eps)
    logits = _mm(arch, xn, params["embed"].T)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


@torch.no_grad()
def forward_logits(params: dict, cfg: Any, tokens: torch.Tensor,
                   precision: str = "f32") -> torch.Tensor:
    """(B, S, V) f32 logits of one member (its leaves read in f32)."""
    arch = Arch(cfg, precision)
    p = _f32(params)
    x = p["embed"][tokens.long()]
    for mixer, lp, _ in _layers(arch, p):
        x = _layer(arch, mixer, lp, x)
    return _mm(arch, rms_norm(x, p["final_norm"]["w"], arch.eps), p["embed"].T)


def loss_and_grads(params: dict, cfg: Any, tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "f32") -> tuple[float, dict]:
    """One member's mean next-token loss on (B, S) tokens and its gradient
    of every leaf (f32, in the tree's layout), a layer at a time."""
    arch = Arch(cfg, precision)
    p = _f32(params)
    grads = _zeros_like(p)
    with torch.no_grad():
        x = p["embed"][tokens.long()]
        inputs = []
        for mixer, lp, _ in _layers(arch, p):
            inputs.append(x)
            x = _layer(arch, mixer, lp, x)
    head = {"embed": p["embed"].detach().requires_grad_(True),
            "final_norm": {"w": p["final_norm"]["w"].detach().requires_grad_(True)}}
    xl = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = _loss(arch, head, xl, labels)
        loss.backward()
    grads["embed"] += head["embed"].grad
    grads["final_norm"]["w"] += head["final_norm"]["w"].grad
    dx = xl.grad
    for (mixer, lp, (name, g)), x_in in reversed(list(zip(_layers(arch, p), inputs))):
        leaves = {path: t.detach().requires_grad_(True) for path, t in _leaves(lp)}
        tree = _unflatten(leaves)
        xi = x_in.detach().requires_grad_(True)
        with torch.enable_grad():
            y = _layer(arch, mixer, tree, xi)
            torch.autograd.backward(y, dx)
        for path, t in leaves.items():
            node = grads["blocks"][name]
            for k in path[:-1]:
                node = node[k]
            node[path[-1]][g] += t.grad
        dx = xi.grad
        del y, leaves, tree
    grads["embed"].index_add_(0, tokens.reshape(-1).long(), dx.reshape(-1, dx.shape[-1]))
    return float(loss.detach()), grads


def _unflatten(leaves: dict) -> dict:
    out: dict = {}
    for path, t in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def eq1_matrix(adj: np.ndarray) -> np.ndarray:
    """DecAvg's Eq. 1 with equal data sizes and self-trust 1: each row
    averages the node's closed neighbourhood."""
    w = (np.asarray(adj) != 0).astype(np.float64)
    np.fill_diagonal(w, 1.0)
    return w / w.sum(axis=1, keepdims=True)


def cosine_lr(lr: float, total: int, r: int, final_frac: float = 0.1) -> float:
    """The cosine schedule with no warm-up rounds: ``min(r, 1)`` times the
    cosine from ``lr`` down to ``final_frac * lr`` over ``total`` rounds."""
    t = min(max(r / max(total, 1), 0.0), 1.0)
    return lr * min(float(r), 1.0) * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))


def _round_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.dtype)


def cohort_rounds(init: dict, cfg: Any, w: np.ndarray, batches, lrs, *, mu: float = 0.5,
                  precision: str = "f32") -> dict:
    """DecAvg over ``len(w)`` members that all start from ``init``: for each
    round ``r`` (tokens, labels) = ``batches[r]``, each (N, B, S), every member
    takes one SGD step with momentum ``mu`` at ``lrs[r]``, then every leaf is
    mixed, ``P <- W P``. Returns the members' params and momenta (lists of
    trees, each leaf in ``init``'s dtype and f32) and each round's losses."""
    n = len(w)
    params = [{path: t.clone() for path, t in _leaves(init)} for _ in range(n)]
    moms = [{path: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for path, t in _leaves(init)} for _ in range(n)]
    losses = []
    for (toks, labels), lr in zip(batches, lrs):
        row = []
        for i in range(n):
            loss, grads = loss_and_grads(_unflatten(params[i]), cfg, toks[i], labels[i], precision)
            row.append(loss)
            for path, g in _leaves(grads):
                m = moms[i][path].mul_(mu).add_(g)
                params[i][path] = _round_to(params[i][path].float() - lr * m, params[i][path])
            del grads
        losses.append(row)
        for path in params[0]:
            stack = [params[j][path].float() for j in range(n)]
            mixed = [sum(float(w[i, j]) * stack[j] for j in range(n) if w[i, j] != 0)
                     for i in range(n)]
            for i in range(n):
                params[i][path] = _round_to(mixed[i], params[i][path])
            del stack, mixed
    return {"params": [_unflatten(p) for p in params], "momentum": [_unflatten(m) for m in moms],
            "losses": losses}
