"""Pipeline-parallel decode with hand-written tensor parallelism.

The port of ``repro/serve/pipeline_manual.py``. Every mesh axis is
explicit, nothing is left to a partitioner:

- `data` axis = pipeline stages. Stage s owns layer groups
  [s*G/S, (s+1)*G/S); activation microgroups rotate through the stages
  (``serve/gpipe.py``).
- `model` axis = megatron TP: rank r owns query heads [r*H/tp, (r+1)*H/tp)
  and its column slab of the FFN, computes partial outputs, and
  ``psum("model")`` adds them (in rank order) after the attention
  out-projection and after the FFN down-projection. The embedding's feature
  dim is split over `model` too and gathered back (tiled ``all_gather``).
- `pod` axis (optional) = data parallelism: pod p decodes batch rows
  [p*B/pods, (p+1)*B/pods) with its own pipeline.
- KV cache: int8 values and f32 scales, global view (G, B, T, tp*kvr, hd),
  dim 3 split over `model`: rank r stores the kvr GQA KV heads its query
  heads attend to, kvr = max(1, (H/tp) / (H/hkv)) (ranks_per_kv = tp/hkv
  ranks keep a copy each of one head when tp > hkv).

The params and the cache are placed once per ``(pod, stage, rank)``
(``place``, or ``serve.pipeline.place(..., manual=True)``) under
``param_shardings`` and ``cache_shardings``: rank r's column slabs of
``wq`` and ``w_gate``/``w_in``, its row slabs of ``wo``/``w_out``, its KV
heads of the cache and their scales, and its columns of the embedding and
the head lie on its device, and its replica of the activations too. Each
rank reads the shared position from its own slab of ``index``. The two
``psum``s of a layer and the embedding's gather are the only traffic
inside a stage, and the activations' hop (one a lane) between stages.

Two departures from the reference, both where it is wrong:
- The reference keeps one KV head a rank, head (r*qh)//group, also when a
  rank's qh = H/tp query heads span more than one KV head (qh > H/hkv, e.g.
  llama3.2-1b at tp=2): its other query heads then attend the wrong keys,
  and its tokens differ from ``decode_step``'s. The port keeps the kvr heads
  they need; at kvr = 1 the layout and the result are the reference's.
- With pods, the reference passes the whole cache to every pod
  (replicated), so each pod writes its rows at the top of its own copy and
  the global view is pod 0's. The port gives pod p its own rows of the one
  global cache, the batch split the tokens already have.

Supported: decoder-only, uniform attention+dense pattern, num_groups %
stages == 0, H % tp == 0, and tp | hkv or hkv | tp.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mesh as mesh_mod
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SR
from repro_torch.models import layers as L
from repro_torch.serve import gpipe
from repro_torch.serve.pipeline import placed
from repro_torch.tree import tree_map_with_path

__all__ = [
    "kv_per_rank",
    "kv_heads",
    "init_kv_cache",
    "cache_shardings",
    "param_shardings",
    "place",
    "build_manual_pipeline_step",
]

PyTree = Any

_KV = ("k", "v", "k_scale", "v_scale")


def _check(cfg: ArchConfig, tp: int) -> None:
    if cfg.enc_dec or cfg.family in ("ssm", "hybrid", "moe"):
        raise ValueError(f"{cfg.arch_id}: manual pipeline supports dense decoder-only")
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.arch_id}: H={cfg.num_heads} % tp={tp} != 0")
    if tp % cfg.num_kv_heads and cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.arch_id}: kv heads {cfg.num_kv_heads} vs tp {tp}")


def kv_per_rank(cfg: ArchConfig, tp: int) -> int:
    """KV heads a TP rank stores: those its H/tp query heads attend to."""
    qh = cfg.num_heads // tp
    group = cfg.num_heads // cfg.num_kv_heads
    return max(1, qh // group)


def kv_heads(cfg: ArchConfig, tp: int) -> list[int]:
    """The model's KV head held in each column of dim 3 of the cache: rank
    r's kvr columns hold heads (r*qh)//group onwards."""
    qh, group, kvr = cfg.num_heads // tp, cfg.num_heads // cfg.num_kv_heads, kv_per_rank(cfg, tp)
    return [(r * qh) // group + j for r in range(tp) for j in range(kvr)]


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, tp: int, *,
                  device=None) -> PyTree:
    """Global-view cache on ``device`` (None: the card): (G, B, T, tp*kvr,
    hd) int8 values and (..., 1) f32 scales, dim 3 split over `model` so
    each rank holds its own KV heads, and the shared position (G,)."""
    dev = resolve_device(device)
    shape = (cfg.num_groups, batch, cache_len, tp * kv_per_rank(cfg, tp), cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        "index": torch.zeros((cfg.num_groups,), dtype=torch.int32, device=dev),
    }


def cache_shardings(mesh) -> PyTree:
    kv = SR.P("data", None, None, "model", None)
    return {"k": kv, "v": kv, "k_scale": kv, "v_scale": kv, "index": SR.P("data")}


def _placed_cache_specs(mesh) -> PyTree:
    """``cache_shardings`` with the batch over `pod`: the port gives pod p
    its own rows of the one global cache (the module's second departure)."""
    if "pod" not in mesh.shape:
        return cache_shardings(mesh)
    kv = SR.P("data", "pod", None, "model", None)
    return {"k": kv, "v": kv, "k_scale": kv, "v_scale": kv, "index": SR.P("data")}


def _block_spec(name: str, ndim: int) -> SR.PartitionSpec:
    spec = [None] * ndim
    spec[0] = "data"
    if name in ("wq", "w_gate", "w_in"):
        spec[-1] = "model"
    elif name in ("wo", "w_out"):
        spec[-2] = "model"
    # wk, wv, norms: replicated within the stage
    return SR.P(*spec)


def param_shardings(cfg: ArchConfig, mesh, params_shapes: PyTree) -> PyTree:
    """Pipeline layout: blocks' group axis over `data`; wq/wo and the FFN
    over `model`; wk/wv replicated (each rank computes every KV head of the
    new token, then keeps its own)."""

    def one(path, leaf):
        name = str(path[-1])
        if SR._path_str(path).startswith("blocks/"):
            return _block_spec(name, leaf.ndim)
        if name in ("embed", "lm_head"):
            spec = [None] * leaf.ndim
            spec[-1] = "model"  # d (embed) / V (head)
            return SR.P(*spec)
        return SR.P()

    return tree_map_with_path(one, params_shapes)


def place(cfg: ArchConfig, mesh, params: PyTree, cache: PyTree) -> tuple[SR.Placed, SR.Placed]:
    """The params and the cache placed once per (pod, stage, rank) for
    ``build_manual_pipeline_step(cfg, mesh)`` (see ``serve.pipeline.place``)."""
    return (SR.place(params, param_shardings(cfg, mesh, params), mesh),
            SR.place(cache, _placed_cache_specs(mesh), mesh))


def build_manual_pipeline_step(
    cfg: ArchConfig,
    mesh,
    *,
    window: int | None = None,
) -> Callable:
    """serve_step(params, token (B,), cache) -> (next_token (B,), cache)."""
    stages = mesh.shape["data"]
    tp = mesh.shape["model"]
    pods = mesh.shape.get("pod", 1)
    _check(cfg, tp)
    if cfg.num_groups % stages:
        raise ValueError(f"{cfg.arch_id}: {cfg.num_groups} groups % {stages} stages")
    qh = cfg.num_heads // tp  # query heads per rank
    hd = cfg.hd
    theta = cfg.rope_theta
    group = cfg.num_heads // cfg.num_kv_heads
    kvr = kv_per_rank(cfg, tp)
    heads = kv_heads(cfg, tp)
    per_stage = cfg.num_groups // stages
    axes = mesh.axis_names

    def coord(p, s, r):
        return tuple({"pod": p, "data": s, "model": r}[a] for a in axes)

    def layer_local(lp, x, kv, pos, r):
        """Rank r's part of one decoder layer on (mb, 1, d), ``lp`` its slab
        of the layer's weights: its query heads against its KV heads. ``kv``:
        its (mb, T, kvr, hd) slabs, written in place. Returns the rank's
        partial attention output."""
        h = L.norm(x, lp["norm1"], cfg.norm)
        mb = x.shape[0]
        q = (h @ lp["attn"]["wq"]).reshape(mb, 1, qh, hd)  # local q heads
        k_full = (h @ lp["attn"]["wk"]).reshape(mb, 1, cfg.num_kv_heads, hd)
        v_full = (h @ lp["attn"]["wv"]).reshape(mb, 1, cfg.num_kv_heads, hd)
        first = heads[r * kvr]  # the first kv head this rank's q heads use
        k_new = k_full[:, :, first:first + kvr]
        v_new = v_full[:, :, first:first + kvr]
        q = L.apply_rope(q, pos[None], theta)
        k_new = L.apply_rope(k_new, pos[None], theta)

        t = kv["k"].shape[1]
        slot = torch.remainder(pos, t).long().reshape(1)
        kq, ks = L._quant_kv(k_new)
        vq, vs = L._quant_kv(v_new)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            kv[name].index_copy_(1, slot, val)

        keys = kv["k"].float() * kv["k_scale"]  # (mb, T, kvr, hd)
        vals = kv["v"].float() * kv["v_scale"]
        # local query head i attends local KV head i // group
        kv_of_q = torch.arange(qh, device=x.device) // group
        keys, vals = keys[:, :, kv_of_q], vals[:, :, kv_of_q]  # (mb, T, qh, hd)
        slots = torch.arange(t, device=x.device)
        sl = slot[0]
        kpos = pos.long() + slots - sl - torch.where(slots > sl, t, 0)
        kpos = torch.where(kpos < 0, L.INT32_MAX, kpos)
        logits = torch.einsum("mqhd,mthd->mhqt", q.float(), keys) * hd**-0.5
        ok = kpos[None, None, None, :] <= pos
        if window is not None:
            ok &= kpos[None, None, None, :] > pos - window
        logits = torch.where(ok, logits, -torch.inf)
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("mhqt,mthd->mqhd", probs, vals)  # (mb, 1, qh, hd)
        return attn.reshape(mb, 1, qh * hd).to(x.dtype) @ lp["attn"]["wo"]

    def ffn_local(f, h):
        if cfg.ffn_act == "swiglu":
            return (F.silu(h @ f["w_gate"]) * (h @ f["w_in"])) @ f["w_out"]
        return F.gelu(h @ f["w_in"], approximate="tanh") @ f["w_out"]

    def add(xs, ys):
        """Each lane's residual add; lanes that share both tensors (ranks
        on one device) share the sum."""
        done: dict[tuple[int, int], torch.Tensor] = {}
        out = []
        for x, y in zip(xs, ys):
            key = (id(x), id(y))
            if key not in done:
                done[key] = x + y
            out.append(done[key])
        return out

    @torch.no_grad()
    def serve_step(params: PyTree, token: torch.Tensor, cache: PyTree):
        pp = placed(params, lambda t: param_shardings(cfg, mesh, t), mesh, "params")
        pc = placed(cache, _placed_cache_specs(mesh), mesh, "cache")
        b = token.shape[0]
        b_pod = b // pods
        mb = b_pod // stages
        tokens = []
        for p in range(pods):
            # devices[s][r]: the device of this pod's stage s, rank r
            devices = [[mesh.devices[coord(p, s, r)] for r in range(tp)] for s in range(stages)]
            at = [[pp.at(coord(p, s, r)) for r in range(tp)] for s in range(stages)]
            kv_at = [[pc.at(coord(p, s, r)) for r in range(tp)] for s in range(stages)]
            # each rank reads the shared position from its own slab of index
            pos = [[c["index"][0] for c in row] for row in kv_at]
            caches = [[{k: c[k] for k in _KV} for c in row] for row in kv_at]
            tok = token[p * b_pod:(p + 1) * b_pod]

            # embed: d split over `model`, every rank of stage 0 gathers the
            # columns (tiled all_gather), each its own replica
            x_local = [at[0][r]["embed"][tok.to(devices[0][r])] for r in range(tp)]
            x_groups = [mesh_mod.all_gather(x_local, dev, axis=1, shard=r)
                        .reshape(stages, mb, 1, -1).to(cfg.dtype())
                        for r, dev in enumerate(devices[0])]

            def apply_stage(s, x, kv_ranks, at=at, devices=devices, pos=pos):
                for j in range(per_stage):
                    lps = [tree_map_with_path(lambda _p, w, j=j: w[j], a["blocks"]["layer0"])
                           for a in at[s]]
                    parts = [layer_local(lps[r], x[r], {k: kv_ranks[r][k][j] for k in _KV},
                                         pos[s][r], r) for r in range(tp)]
                    x = add(x, mesh_mod.psum(parts, devices[s]))
                    parts = [ffn_local(lps[r]["ffn"], L.norm(x[r], lps[r]["norm2"], cfg.norm))
                             for r in range(tp)]
                    x = add(x, mesh_mod.psum(parts, devices[s]))
                return x, kv_ranks  # the ranks wrote their KV heads in place

            # the rank caches carry no index leaf (the shared position is
            # bumped below), so slice and write run on every leaf
            xs = gpipe.rotate(
                x_groups, caches, stages=stages,
                apply_fn=apply_stage,
                slice_fn=lambda c, m: gpipe.microbatch_slice(c, m, mb),
                write_fn=lambda c, new, m, act: gpipe.microbatch_write(c, new, m, mb, act),
                devices=devices,
            )
            # the head on stage 0's ranks, each its columns of the vocab,
            # the logits gathered on rank 0
            parts = [L.norm(xs[0][r], at[0][r]["final_norm"], cfg.norm) @ at[0][r]["lm_head"]
                     for r in range(tp)]
            logits = mesh_mod.all_gather(parts, devices[0][0], axis=-1, shard=0).float()
            tokens.append(torch.argmax(logits, dim=-1).to(torch.int32))
        for t in {id(i): i for i in (pc.at(c)["index"] for c in pc.coords)}.values():
            t.add_(1)
        return mesh_mod.all_gather(tokens, mesh.devices.flat[0], shard=0), cache

    return serve_step
