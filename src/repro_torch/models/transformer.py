"""Model assembly: decoder-only LMs (dense, MoE, SSM, hybrid), the
whisper-style encoder-decoder and the VLM backbone, all built from one
``ArchConfig``. The port of ``repro/models/transformer.py``.

Public API (plain functions over parameter dicts of tensors):
  init_params(generator, cfg, device=None)       -> params
  forward(params, cfg, tokens, ..., remat=False) -> (logits, moe_aux)
  encode(params, cfg, frames)                    -> encoder memory (enc-dec)
  init_cache(cfg, batch, cache_len, dtype, ...)  -> stacked per-layer caches
  prefill_forward(params, cfg, tokens, cache)    -> (last logits, cache)
  decode_step(params, cfg, token, cache)         -> (logits, cache)

A config's port-only fields (``use_rope``, ``tie_embeddings``,
``norm_eps``; ``MambaSpec.inner_norms``) are off by default, and every config
of the reference's zoo keeps them so: its tree and bits are the reference's.
Tied embeddings drop the ``lm_head`` leaf: logits are ``x @ embed.T``.

The layout is the reference's: ``params["blocks"]`` holds one subtree per
layer of the pattern, each leaf with a leading group axis G
(``cfg.num_groups``), so a JAX parameter tree carries over as it is. A
Python loop over G takes the place of the reference's ``lax.scan``. Caches
are stacked the same way, with real (not broadcast) tensors per group, and
are updated in place (see ``layers``, ``mamba``, ``rwkv``). The encoder's
blocks carry a leading layer axis (``cfg.enc_layers``), and the decoder's
cross-attention a leading group axis, as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe
from repro_torch.models import rwkv as Rk
from repro_torch.tree import tree_leaves

__all__ = [
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "init_params",
    "param_count",
    "prefill_forward",
]

PyTree = Any


def _attn_spec(cfg: ArchConfig, *, window: int | None, flash: bool = False) -> L.AttnSpec:
    return L.AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.hd,
        rope_theta=cfg.rope_theta,
        causal=True,
        window=window,
        use_rope=cfg.use_rope,
        flash=flash,
    )


def _head(params: PyTree, cfg: ArchConfig) -> torch.Tensor:
    """The (d, V) output projection: ``lm_head``, or the embedding's
    transpose when the config ties them."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_norm(cfg: ArchConfig, dtype, device, lead: tuple[int, ...] = ()) -> PyTree:
    p = {"w": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "ln":
        p["b"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device)
    return p


def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec, dtype) -> PyTree:
    lead = (cfg.num_groups,)
    dev = torch.device("meta") if gen is None else gen.device
    d = cfg.d_model
    p: PyTree = {"norm1": _init_norm(cfg, dtype, dev, lead),
                 "norm2": _init_norm(cfg, dtype, dev, lead)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(gen, d, _attn_spec(cfg, window=None), dtype, lead)
    elif spec.mixer == "mamba":
        p["mamba"] = Mb.init_mamba(gen, d, cfg.mamba, dtype, lead)
    elif spec.mixer == "rwkv":
        p["rwkv"] = Rk.init_rwkv(gen, d, cfg.rwkv, dtype, lead)
    if spec.ffn == "dense":
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, dtype, lead)
    elif spec.ffn == "moe":
        p["moe"] = Moe.init_moe(gen, d, cfg.moe, dtype, lead)
    elif spec.ffn == "rwkv":
        p["ffn"] = Rk.init_rwkv_ffn(gen, d, cfg.d_ff, dtype, lead)
    return p


def _init_encoder_and_cross(gen: torch.Generator, cfg: ArchConfig, dtype, dev) -> PyTree:
    """The enc-dec leaves: encoder blocks with a leading layer axis, and the
    decoder's cross-attention with a leading group axis."""
    d, e, g = cfg.d_model, (cfg.enc_layers,), (cfg.num_groups,)
    aspec = _attn_spec(cfg, window=None)
    encoder = {
        "blocks": {
            "attn": L.init_attention(gen, d, aspec, dtype, e),
            "ffn": L.init_ffn(gen, d, cfg.d_ff, dtype, e),
            "norm1": _init_norm(cfg, dtype, dev, e),
            "norm2": _init_norm(cfg, dtype, dev, e),
        },
        "final_norm": _init_norm(cfg, dtype, dev),
    }
    cross = {
        f"layer{i}": {"attn": L.init_attention(gen, d, aspec, dtype, g),
                      "norm": _init_norm(cfg, dtype, dev, g)}
        for i in range(cfg.period)
    }
    return {"encoder": encoder, "cross": cross}


def init_params(generator: torch.Generator | int, cfg: ArchConfig, device=None) -> PyTree:
    """The full parameter tree, drawn from ``generator`` (or a seed) on
    ``device`` (None: the card); layer leaves carry the leading group axis.
    The draws are the port's own: torch cannot give JAX's bits. On the
    ``meta`` device nothing is drawn: the tree holds the shapes and dtypes
    (the ``like`` of a checkpoint restore)."""
    dev = resolve_device(device)
    gen = generator
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    if gen is not None and gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params wanted on {dev}")
    dtype = cfg.dtype()
    scale = cfg.d_model**-0.5
    params = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), scale, dtype),
        "blocks": {f"layer{i}": _init_layer(gen, cfg, spec, dtype)
                   for i, spec in enumerate(cfg.pattern)},
        "final_norm": _init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), scale, dtype)
    if cfg.enc_dec:
        params.update(_init_encoder_and_cross(gen, cfg, dtype, dev))
    return params


def param_count(params: PyTree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _at(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a stacked tree (views; ``None`` leaves stay)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    return tree[g]


def _apply_layer(
    p: PyTree,
    x: torch.Tensor,
    cfg: ArchConfig,
    spec: LayerSpec,
    *,
    window: int | None,
    cache: PyTree | None,
    cross: PyTree | None,
    memory: torch.Tensor | None,
    positions: torch.Tensor | None,
    flash: bool = False,
    layer: int | None = None,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Pre-norm residual layer (``layer``: its index in the stack, a span
    label). Returns (x, new_cache, moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    eps = cfg.norm_eps
    h = L.norm(x, p["norm1"], cfg.norm, eps)
    mixer_cache = None if cache is None else cache["mixer"]
    if spec.mixer == "attn":
        aspec = _attn_spec(cfg, window=window, flash=flash)
        y, c = L.attention_layer(p["attn"], h, aspec, positions=positions, cache=mixer_cache)
    elif spec.mixer == "mamba":
        y, c = Mb.mamba_block(p["mamba"], h, cfg.mamba, cache=mixer_cache, eps=eps, layer=layer)
    else:  # rwkv
        y, c = Rk.rwkv_block(p["rwkv"], h, cfg.rwkv, cache=mixer_cache)
    new_cache: PyTree = {"mixer": c, "ffn": None}
    x = x + y

    if cross is not None and memory is not None:
        # Cross-attention over the encoder memory: its K/V projected on
        # every call, no rope, nothing cached.
        h = L.norm(x, cross["norm"], cfg.norm, eps)
        hkv, hd = cfg.num_kv_heads, cfg.hd
        b, t, _ = memory.shape
        mk = (memory @ cross["attn"]["wk"]).reshape(b, t, hkv, hd)
        mv = (memory @ cross["attn"]["wv"]).reshape(b, t, hkv, hd)
        y, _ = L.attention_layer(cross["attn"], h, _attn_spec(cfg, window=None),
                                 cross_kv=(mk, mv))
        x = x + y

    h = L.norm(x, p["norm2"], cfg.norm, eps)
    if spec.ffn == "dense":
        y = L.swiglu_ffn(p["ffn"], h) if cfg.ffn_act == "swiglu" else L.gelu_ffn(p["ffn"], h)
    elif spec.ffn == "moe":
        y, aux = Moe.moe_ffn(p["moe"], h, cfg.moe)
    elif spec.ffn == "rwkv":
        y, new_cache["ffn"] = Rk.rwkv_ffn(p["ffn"], h,
                                          cache=None if cache is None else cache["ffn"])
    else:
        y = torch.zeros_like(x)
    return x + y, new_cache, aux


def _apply_group(
    gp: PyTree,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    window: int | None,
    cache: PyTree | None,
    cross: PyTree | None,
    memory: torch.Tensor | None,
    positions: torch.Tensor | None,
    flash: bool = False,
    group: int = 0,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: PyTree = {}
    for i, spec in enumerate(cfg.pattern):
        name = f"layer{i}"
        x, c, aux = _apply_layer(
            gp[name], x, cfg, spec,
            window=window,
            cache=None if cache is None else cache[name],
            cross=None if cross is None else cross[name],
            memory=memory,
            positions=positions,
            flash=flash,
            layer=group * cfg.period + i,
        )
        new_cache[name] = c
        aux_total = aux_total + aux
    return x, new_cache, aux_total


def _groups(params: PyTree, cfg: ArchConfig, x: torch.Tensor, *, window, cache, memory,
            positions, flash: bool = False,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the layer groups in order (the reference's scan), ``cache`` (a
    stacked cache or None) updated in place. ``remat`` checkpoints each group
    (no cache): its activations are recomputed in the backward pass instead
    of kept, as the reference's ``jax.checkpoint`` of the scan body.
    ``memory`` is the encoder's output, attended by the cross-attention
    stack of an enc-dec model (ignored without one, as in the reference)."""
    if remat and cache is not None:
        raise ValueError("remat is for the training forward (cache=None)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        def group(x, g=g):
            y, _, a = _apply_group(
                _at(params["blocks"], g), x, cfg, window=window, cache=_at(cache, g),
                cross=_at(params.get("cross"), g), memory=memory, positions=positions,
                flash=flash, group=g,
            )
            return y, a

        if remat:
            # No random op runs in a layer, so no RNG state is stashed (that
            # would also read the generator during graph capture).
            x, a = torch.utils.checkpoint.checkpoint(
                group, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = group(x)
        aux = aux + a
    return x, aux


def _window(cfg: ArchConfig, window: int | None) -> int | None:
    return window if window is not None else (cfg.sliding_window if cfg.always_window else None)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def forward(
    params: PyTree,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    *,
    prefix_embeds: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
    window: int | None = None,
    remat: bool = False,
    last_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (logits (B, S_total, V) in the param dtype,
    moe_aux). ``prefix_embeds`` (B, P, d): continuous embeddings put ahead
    of the token embeddings (the VLM's patch stub), so S_total = P + S.
    ``memory`` (B, T, d): the encoder's output (enc-dec). ``remat``
    checkpoints each layer group (the training memory policy; the result is
    the same). ``last_only`` gives the last position's logits, (B, V),
    sliced before the head matmul. No operation here writes into a
    parameter or into a tensor autograd saved, so it can be differentiated."""
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _groups(params, cfg, x, window=_window(cfg, window), cache=None,
                     memory=memory, positions=positions, remat=remat)
    x = L.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    head = _head(params, cfg)
    if last_only:
        return x[:, -1] @ head, aux
    return x @ head, aux


def encode(params: PyTree, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (B, T, d):
    non-causal self-attention with rope and a GELU FFN per layer. Its
    attention is the port's: above 2048^2 logits the chunked loop, which
    (unlike the reference's) never attends the zero padding past T."""
    x = frames.to(cfg.dtype())
    spec = L.AttnSpec(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.hd, causal=False, use_rope=True,
                      rope_theta=cfg.rope_theta)
    enc = params["encoder"]
    for i in range(cfg.enc_layers):
        lp = _at(enc["blocks"], i)
        h = L.norm(x, lp["norm1"], cfg.norm)
        y, _ = L.attention_layer(lp["attn"], h, spec)
        x = x + y
        h = L.norm(x, lp["norm2"], cfg.norm)
        x = x + L.gelu_ffn(lp["ffn"], h)
    return L.norm(x, enc["final_norm"], cfg.norm)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ArchConfig,
    batch: int,
    cache_len: int,
    dtype=None,
    *,
    kv_quant: bool = False,
    per_slot: bool = False,
    device=None,
) -> PyTree:
    """Stacked per-group caches on ``device`` (None: the card): for each
    attention layer a ring buffer of ``cache_len`` positions (sliding-window
    callers pass the window); for a Mamba layer its conv and SSM states, for
    an RWKV layer its token shift and WKV state, and for an RWKV FFN its
    token shift. ``kv_quant`` stores int8 values and per-(token, head) f32
    scales. ``per_slot`` gives every batch row its own position counter
    (``index`` (G, batch) instead of (G,)), the continuous-batching engine's
    layout. Every group gets tensors of its own (the reference's
    ``broadcast_to`` would alias them under in-place writes)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype()
    g = cfg.num_groups
    kv_shape = (g, batch, cache_len, cfg.num_kv_heads, cfg.hd)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def one_layer(spec: LayerSpec) -> PyTree:
        ffn = ({"shift": zeros((g, batch, cfg.d_model), dtype)} if spec.ffn == "rwkv"
               else None)
        if spec.mixer == "mamba":
            return {"mixer": Mb.init_mamba_cache(batch, cfg.d_model, cfg.mamba, dtype, dev, (g,)),
                    "ffn": ffn}
        if spec.mixer == "rwkv":
            return {"mixer": Rk.init_rwkv_cache(batch, cfg.d_model, cfg.rwkv, dtype, dev, (g,)),
                    "ffn": ffn}
        index = zeros((g, batch) if per_slot else (g,), torch.int32)
        if kv_quant:
            mixer = {
                "k": zeros(kv_shape, torch.int8),
                "v": zeros(kv_shape, torch.int8),
                "k_scale": zeros(kv_shape[:-1] + (1,), torch.float32),
                "v_scale": zeros(kv_shape[:-1] + (1,), torch.float32),
                "index": index,
            }
        else:
            mixer = {"k": zeros(kv_shape, dtype), "v": zeros(kv_shape, dtype), "index": index}
        return {"mixer": mixer, "ffn": ffn}

    return {f"layer{i}": one_layer(spec) for i, spec in enumerate(cfg.pattern)}


def _cache_leaves(cache: PyTree, name: str) -> list[torch.Tensor]:
    """Every leaf called ``name`` in a cache tree."""
    out = []
    for key, val in cache.items():
        if isinstance(val, dict):
            out += _cache_leaves(val, name)
        elif key == name:
            out.append(val)
    return out


@torch.no_grad()
def prefill_forward(
    params: PyTree,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    cache: PyTree,
    *,
    length: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
    window: int | None = None,
    flash: bool = False,
) -> tuple[torch.Tensor, PyTree]:
    """Full-prompt prefill: one forward pass that writes the whole KV cache.

    tokens: (B, S), right-padded to a common S when lengths differ; length:
    (B,) true prompt lengths (default S). Returns the f32 logits of each
    row's last real token, (B, V), and the cache, filled in place: the state
    ``decode_step`` continues from. The cache must be fresh.

    As in the reference, padded positions get K/V entries that the written
    ``index`` (the true length) marks as unwritten, so decode never attends
    them; that needs S <= the ring length, so ``length`` with a prompt wider
    than the ring raises, as does a per-row ``length`` with a cache whose
    index is shared by the batch. Both are checked before anything is
    written. ``flash`` routes every attention layer through the CUDA
    flash-attention kernel (its plain version for CPU tensors).

    Recurrent mixers (mamba, rwkv) run the whole prompt through their
    chunked scans, so padding is not safe for them: give them exact
    lengths. MoE FFNs route the prompt in capacity-bounded groups, as
    ``forward`` does, while token-at-a-time decode routes each step as a
    group of its own: for MoE patterns the two legitimately differ.
    ``memory`` is the encoder's output for an enc-dec model.
    """
    if length is not None:
        rings = [k.shape[-3] for k in _cache_leaves(cache, "k")]  # (G, B, T, Hkv, hd)
        if rings and tokens.shape[1] > min(rings):
            raise ValueError(
                f"right-padded prefill (length given) needs padded width <= "
                f"the attention cache ring ({tokens.shape[1]} > {min(rings)}): "
                "with S > ring, padded K/V wraps below the written index and "
                "decode attends it as real past context — shorten the pad "
                "width or grow the cache"
            )
        length = torch.as_tensor(length, dtype=torch.int32, device=tokens.device)
        if length.dim() == 1 and any(i.dim() == 1 for i in _cache_leaves(cache, "index")):
            raise ValueError(
                "per-row prompt lengths need a per-slot cache "
                "(init_cache(..., per_slot=True)); this cache has a "
                "scalar index shared by the whole batch"
            )
    x = params["embed"][tokens]
    x, _ = _groups(params, cfg, x, window=_window(cfg, window), cache=cache,
                   memory=memory, positions=None, flash=flash)
    x = L.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if length is None:
        last = x[:, -1]
    else:
        lvec = torch.broadcast_to(length, x.shape[:1]).long()
        last = x[torch.arange(x.shape[0], device=x.device), lvec - 1]
        for index in _cache_leaves(cache, "index"):
            index.copy_(torch.broadcast_to(length, index.shape))
    # Slice before the head matmul: full-sequence logits are a large
    # transient for nothing.
    logits = (last @ _head(params, cfg)).float()
    return logits, cache


@torch.no_grad()
def decode_step(
    params: PyTree,
    cfg: ArchConfig,
    token: torch.Tensor,
    cache: PyTree,
    *,
    memory: torch.Tensor | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, PyTree]:
    """One-token decode. token: (B,) int. Returns (f32 logits (B, V), the
    cache, advanced in place)."""
    x = params["embed"][token][:, None, :]  # (B, 1, d)
    x, _ = _groups(params, cfg, x, window=_window(cfg, window), cache=cache,
                   memory=memory, positions=None)
    x = L.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, cache
