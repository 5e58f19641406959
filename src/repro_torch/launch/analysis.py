"""The dry-run's analytic roofline: step FLOPs, per-device HBM traffic and
per-device wire bytes of every (arch x shape x mesh) step, from the
configs and the sharding design.

The port of the analytic half of ``repro/launch/analysis.py``; its numbers
are the reference's, term for term. What the reference reads from a
compiled XLA program has no source here: ``analyze`` takes the per-device
argument bytes (counted from the sharding specs, ``dryrun.argument_bytes``)
and optional temporaries in place of ``memory_analysis()``, and the row's
XLA-only fields (``raw_cost_flops``, ``hlo_collectives``,
``collective_ops``, ``unknown_loops``) are None. The HLO parsers
(``collective_wire_bytes``, ``launch/hlo_walk.py``) are not ported: no
path of the port produces HLO.

- model FLOPs: 6·N·D with N = active params (MoE: top-k experts + shared).
- hardware rates: ``Roofline.finalize(hw)``, by default the H100's
  (``launch/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as M

__all__ = [
    "model_flops_per_step",
    "analytic_step_flops",
    "analytic_hbm_bytes_per_device",
    "active_param_count",
    "total_param_count",
    "analytic_collective_bytes",
    "Roofline",
    "analyze",
]


def model_flops_per_step(cfg: ArchConfig, tokens: int) -> float:
    """6 · N_active · tokens (the MODEL_FLOPS convention)."""
    return 6.0 * active_param_count(cfg) * tokens


def _attn_layer_count(cfg: ArchConfig) -> int:
    reps = cfg.num_layers // cfg.period
    return reps * sum(1 for s in cfg.pattern if s.mixer == "attn")


def analytic_step_flops(cfg: ArchConfig, *, kind: str, batch: int, seq: int,
                        cache_len: int = 0, window: int | None = None) -> float:
    """Whole-step FLOPs across all devices, from the workload math:
      param term      mult * 2 * N_active * tokens   (mult=3 for fwd+bwd)
      attention term  mult * 4 * B * S * T_eff * H * hd per attn layer
                      (QK^T + PV; causal halves T_eff)
      MoE dispatch    mult * 3 einsums * 2 * T * E * Cg * d per MoE layer
      rwkv/mamba scan small elementwise terms (included approximately)
    """
    mult = 3.0 if kind == "train" else 1.0
    tokens = batch if kind == "decode" else batch * seq
    total = mult * 2.0 * active_param_count(cfg) * tokens

    la = _attn_layer_count(cfg)
    h, hd = cfg.num_heads, cfg.hd
    if la:
        if kind == "decode":
            t_eff = min(cache_len, window) if window else cache_len
            total += mult * 4.0 * batch * t_eff * h * hd * la
        else:
            t_eff = min(seq, window) if window else seq
            # causal: average attended length ~ t_eff/2
            total += mult * 4.0 * batch * seq * (t_eff / 2.0) * h * hd * la

    if cfg.moe is not None:
        reps = cfg.num_layers // cfg.period
        lm = reps * sum(1 for s in cfg.pattern if s.ffn == "moe")
        tg = min(cfg.moe.group_size, tokens)
        cg = max(int(cfg.moe.capacity_factor * cfg.moe.top_k * tg / cfg.moe.num_experts), 1)
        # 3 one-hot einsums (dispatch-in, combine, expert-out gather), each
        # 2 * Tg * E * Cg * d per group -> 2 * T * E * Cg * d in total.
        total += mult * lm * 3.0 * 2.0 * tokens * cfg.moe.num_experts * cg * cfg.d_model

    # rwkv WKV chunked recurrence (D=head_dim): ~4*T*H*D^2 inter/state +
    # 4*T*C*H*D intra per layer
    if cfg.rwkv is not None:
        reps = cfg.num_layers // cfg.period
        lr = reps * sum(1 for s in cfg.pattern if s.mixer == "rwkv")
        hd_r = cfg.rwkv.head_dim
        heads = cfg.d_model // hd_r
        c = cfg.rwkv.chunk
        total += mult * lr * tokens * heads * (4.0 * hd_r * hd_r + 4.0 * c * hd_r)

    # mamba selective scan: ~10 elementwise ops per (t, di, n) element
    if cfg.mamba is not None:
        reps = cfg.num_layers // cfg.period
        lm_ = reps * sum(1 for s in cfg.pattern if s.mixer == "mamba")
        di = cfg.mamba.inner(cfg.d_model)
        total += mult * lm_ * 10.0 * tokens * di * cfg.mamba.d_state
    return total


def analytic_hbm_bytes_per_device(
    cfg: ArchConfig,
    *,
    kind: str,
    num_nodes: int,
    microbatches: int,
    arg_bytes: float,
    temp_bytes: float,
) -> float:
    """Per-device HBM traffic estimate for one step: weights re-streamed
    once per microbatch in fwd and once in bwd, optimizer state read and
    written once; transients written and read back about once."""
    if kind == "train":
        weight_passes = 2 * microbatches + 2  # fwd+bwd reads, grad+opt write
    else:
        weight_passes = 1
    return weight_passes * arg_bytes + 2.0 * temp_bytes


def _param_count(cfg: ArchConfig, *, active: bool) -> float:
    d = cfg.d_model
    # embeddings + head (both counted, the 6ND convention)
    total = 2.0 * cfg.vocab_size * d
    for spec in cfg.pattern:
        reps = cfg.num_layers // cfg.period
        if spec.mixer == "attn":
            mix = d * cfg.num_heads * cfg.hd * 2 + d * cfg.num_kv_heads * cfg.hd * 2
        elif spec.mixer == "mamba":
            di = cfg.mamba.inner(d)
            dr = cfg.mamba.rank(d)
            mix = d * 2 * di + di * (dr + 2 * cfg.mamba.d_state) + dr * di + di * d
        else:  # rwkv
            mix = 6 * d * d
        if spec.ffn == "dense":
            ffn = 3.0 * d * cfg.d_ff
        elif spec.ffn == "moe":
            experts = cfg.moe.top_k if active else cfg.moe.num_experts
            ffn = 3.0 * d * cfg.moe.d_ff * experts + d * cfg.moe.num_experts
            if cfg.moe.dense_residual:
                ffn += 3.0 * d * (cfg.moe.dense_d_ff or cfg.moe.d_ff)
        elif spec.ffn == "rwkv":
            ffn = 2.0 * d * cfg.d_ff + d * d
        else:
            ffn = 0.0
        total += reps * (mix + ffn)
    if cfg.enc_dec:
        total += cfg.enc_layers * (4 * d * d + 2.0 * d * cfg.d_ff)
        total += cfg.num_layers * 4 * d * d  # cross-attention
    return total


def active_param_count(cfg: ArchConfig) -> float:
    """Active params per token: full count minus non-selected experts."""
    return _param_count(cfg, active=True)


def total_param_count(cfg: ArchConfig) -> float:
    """Full parameter count (MoE: all experts)."""
    return _param_count(cfg, active=False)


def analytic_collective_bytes(
    cfg: ArchConfig,
    *,
    kind: str,
    batch: int,
    seq: int,
    num_nodes: int,
    microbatches: int,
    mesh_shape: dict[str, int],
    node_sharded: bool,
    layout: str = "tp",
    gossip: str = "dense",
    serve_layout: str = "sharded",
) -> dict[str, float]:
    """Per-device wire bytes per step, by source, from the sharding design:

      fsdp_ag   weight all-gathers over `data` (node-replicated archs only):
                one full re-gather per microbatch in fwd and again in bwd
                (remat), (Dd-1)/Dd of the TP-sharded member bytes.
      grad_rs   gradient reduce-scatter over `data`, once per microbatch.
      gossip    DecAvg mixing over a sharded node axis: all-gather of the
                other nodes' TP shards ((K-1)/K x K x member-TP bytes).
                Node-replicated archs mix locally: 0.
      tp_ar     Megatron-style activation all-reduces: ~6 per layer per
                microbatch (2 fwd, 2 remat re-fwd, 2 bwd), 2x payload each.
      moe_a2a   dispatch+combine all-to-alls: 2 x cf x k x token-bytes per
                MoE layer (x3 for train fwd+bwd).
      serve_ag  decode/prefill weight gathers (weights `data`-sharded in the
                serving layout): one full pass per step.
    """
    dm = mesh_shape.get("model", 1)
    dd = mesh_shape.get("data", 1)
    pods = mesh_shape.get("pod", 1)
    devices = dm * dd * pods
    bpp = 2.0 if cfg.param_dtype == "bfloat16" else 4.0
    p_total = total_param_count(cfg)
    member_tp = p_total * bpp / dm  # one member model after TP sharding
    d = cfg.d_model
    la = cfg.num_layers
    out: dict[str, float] = {}
    mult_train = 3.0 if kind == "train" else 1.0

    if kind == "train":
        tokens = batch * seq
        tokens_dev = tokens / max(devices / dm, 1)  # per device column
        if node_sharded and layout == "fsdp_model":
            # Small-arch layout: weights FSDP over `model`, batch-parallel
            # over `model` within each node; weights re-gathered per
            # microbatch (fwd + bwd), grads reduce-scattered; no activation
            # all-reduces.
            frac_m = (dm - 1) / dm if dm > 1 else 0.0
            member_full = p_total * bpp
            out["fsdp_ag"] = 2.0 * microbatches * member_full * frac_m
            out["grad_rs"] = microbatches * member_full * frac_m
            if gossip == "sparse":
                # edge-colored permutes: mean-degree neighbor shards move,
                # not (K-1) of them (ER at 2*p*: mean degree ~ 2 ln K)
                mean_deg = 2.0 * math.log(max(num_nodes, 2))
                out["gossip"] = mean_deg * member_full / dm
            else:
                out["gossip"] = (num_nodes - 1) * member_full / dm / max(num_nodes / dd, 1)
            out["tp_ar"] = 0.0
        elif node_sharded:
            # Node axis occupies `data`: weights TP-resident, grads
            # node-local; the gossip all-gather over the node axis moves
            # the params.
            out["fsdp_ag"] = 0.0
            out["grad_rs"] = 0.0
            out["gossip"] = (num_nodes - 1) * member_tp / max(num_nodes / dd, 1)
            out["tp_ar"] = 6.0 * la * 2.0 * tokens_dev * d * bpp
        else:
            frac = (dd - 1) / dd if dd > 1 else 0.0
            out["fsdp_ag"] = 2.0 * microbatches * num_nodes * member_tp * frac
            out["grad_rs"] = microbatches * num_nodes * member_tp * frac
            out["gossip"] = 0.0
            out["tp_ar"] = 6.0 * la * 2.0 * tokens_dev * d * bpp
    else:
        tokens = batch if kind == "decode" else batch * seq
        tokens_dev = tokens / max(devices / dm, 1)
        frac = (dd - 1) / dd if dd > 1 else 0.0
        if kind == "decode" and serve_layout == "pipeline":
            # weights and cache stay on their stage; (2S-1) activation hops
            # of one microgroup + the final logits psum.
            stages = dd
            mbb = max(batch // stages, 1)
            out["pipeline_permute"] = (2 * stages - 1) * mbb * d * bpp
            out["logits_psum"] = 2.0 * batch * d * bpp
            out["serve_ag"] = 0.0
        else:
            out["serve_ag"] = member_tp * frac  # weights re-streamed once
        out["tp_ar"] = 2.0 * la * 2.0 * tokens_dev * d * bpp

    if cfg.moe is not None:
        reps = cfg.num_layers // cfg.period
        lm = reps * sum(1 for s in cfg.pattern if s.ffn == "moe")
        k_eff = cfg.moe.capacity_factor * cfg.moe.top_k
        tokens_dev_m = (batch * (seq if kind != "decode" else 1)) / max(devices / dm, 1)
        out["moe_a2a"] = mult_train * lm * 2.0 * k_eff * tokens_dev_m * d * bpp
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh_name: str
    chips: int
    step_flops: float           # whole step, all devices (analytic)
    hbm_bytes_dev: float        # per-device HBM traffic estimate
    wire_bytes: float           # per device, analytic model
    wire_by_kind: dict[str, float]
    hlo_collectives: dict[str, float] | None  # XLA only: None here
    collective_ops: dict[str, int] | None     # XLA only: None here
    model_flops: float          # 6·N_active·D convention, whole step
    per_device_hbm: int         # per-device bytes: arguments (+ temporaries)
    raw_cost_flops: float | None  # XLA only: None here
    unknown_loops: int | None = None  # XLA only: None here
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self, hw: M.Hardware = M.H100) -> "Roofline":
        self.compute_s = self.step_flops / (self.chips * hw.peak_flops_bf16)
        self.memory_s = self.hbm_bytes_dev / hw.hbm_bw
        self.collective_s = self.wire_bytes / hw.link_bw
        return self

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / step FLOPs: the share of the executed compute that
        is the 6·N·D 'useful' part."""
        return self.model_flops / self.step_flops if self.step_flops else 0.0

    def row(self) -> dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh_name,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "step_flops": self.step_flops,
            "useful_ratio": self.useful_flops_ratio,
            "per_device_hbm_gb": self.per_device_hbm / 1e9,
            "wire_by_kind": self.wire_by_kind,
            "hlo_collectives": self.hlo_collectives,
            "collective_ops": self.collective_ops,
            "raw_cost_flops": self.raw_cost_flops,
            "unknown_loops": self.unknown_loops,
        }


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cfg: ArchConfig,
    kind: str,
    batch: int,
    seq: int,
    cache_len: int,
    window: int | None,
    num_nodes: int,
    microbatches: int,
    arg_bytes: float,
    model_flops: float,
    temp_bytes: float | None = None,
    layout: str = "tp",
    gossip: str = "dense",
    serve_layout: str = "sharded",
    hw: M.Hardware = M.H100,
) -> Roofline:
    """The row of one combination. ``arg_bytes``: per-device argument
    bytes; ``temp_bytes``: per-device temporaries where known (None: 0)."""
    arg_b = float(arg_bytes)
    temp_b = float(temp_bytes or 0.0)
    step_flops = analytic_step_flops(
        cfg, kind=kind, batch=batch, seq=seq, cache_len=cache_len, window=window
    )
    hbm_dev = analytic_hbm_bytes_per_device(
        cfg, kind=kind, num_nodes=num_nodes, microbatches=microbatches,
        arg_bytes=arg_b, temp_bytes=temp_b,
    )
    mesh_shape = (
        {"pod": 2, "data": 16, "model": 16} if chips == 512 else {"data": 16, "model": 16}
    )
    node_sharded = kind == "train" and num_nodes % mesh_shape["data"] == 0
    wire = analytic_collective_bytes(
        cfg, kind=kind, batch=batch, seq=seq, num_nodes=num_nodes,
        microbatches=microbatches, mesh_shape=mesh_shape,
        node_sharded=node_sharded, layout=layout, gossip=gossip,
        serve_layout=serve_layout,
    )
    return Roofline(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        chips=chips,
        step_flops=step_flops,
        hbm_bytes_dev=hbm_dev,
        wire_bytes=float(sum(wire.values())),
        wire_by_kind=wire,
        hlo_collectives=None,
        collective_ops=None,
        model_flops=model_flops,
        per_device_hbm=int(arg_b + temp_b),
        raw_cost_flops=None,
    ).finalize(hw)
