"""Production dry-run on torch's ``meta`` device: every (architecture x
input shape x mesh) step traces, and its per-device argument bytes and
analytic roofline come out, without a card.

The port of ``repro/launch/dryrun.py``. Where the reference lowers and
compiles each step for a 256- or 512-device mesh, the port:

- builds every argument as a ``meta`` tensor (shape and dtype, no storage)
  and its ``launch/sharding.PartitionSpec`` over the production mesh laid
  on the ``meta`` device;
- traces the step once on those tensors, which proves it runs and gives
  its outputs' shapes and dtypes (the counterpart of
  ``.lower().compile()``). The traced stack is cut to one period of layers
  at full width (``traced_layers``), as the reference's layer scan traces
  one body: at full depth some rows take hours. The pipeline decoder is
  cut to one period a stage;
- counts the per-device argument bytes of the full config exactly: for
  every input leaf the step reads, the largest ``local_slab`` over mesh
  positions, summed. That is XLA's ``argument_size_in_bytes``: ``jax.jit``
  drops the arguments a step never reads (``keep_unused=False``; e.g. the
  unused ``w_gate`` of whisper's gelu FFN, or its encoder in decode), and
  the trace records which leaves some operation reads (``Reads``);
- fills the reference's row (``analysis.analyze``). ``lower_s`` is the
  seconds of the build and trace; ``compile_s``, ``raw_cost_flops``,
  ``hlo_collectives``, ``collective_ops`` and ``unknown_loops`` have no
  source without XLA and are None; ``per_device_hbm_gb`` is the argument
  bytes alone (no compiler temporaries), so ``memory_s`` counts none.

Run (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --both-meshes
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
import traceback
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import analysis
from repro_torch.launch import shapes as SH
from repro_torch.launch import sharding as SR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_map, tree_map_with_path

__all__ = [
    "MICROBATCHES",
    "build_train",
    "build_prefill",
    "build_decode",
    "build_decode_pipeline",
    "build",
    "spec_pairs",
    "argument_bytes",
    "flat_leaves",
    "Reads",
    "Trace",
    "trace",
    "run_one",
    "main",
]

PyTree = Any
META = torch.device("meta")

# Per-arch gradient-accumulation factor for train_4k: bounds activation
# memory. Keys are arch ids; default 1.
MICROBATCHES = {
    "mistral-large-123b": 8,
    "internvl2-76b": 8,
    "dbrx-132b": 8,
    "arctic-480b": 16,
    "jamba-v0.1-52b": 4,
    "stablelm-3b": 2,
    "minicpm-2b": 2,
    "rwkv6-3b": 2,
    "llama3.2-1b": 2,
}


def _meta_params(cfg: ArchConfig) -> PyTree:
    return TF.init_params(0, cfg, device=META)


def build_train(cfg, mesh, shape, *, num_nodes, microbatches, layout="tp", gossip="dense"):
    """Returns (fn, args, in_specs, out_specs, donate)."""
    params = tree_map(
        lambda s: torch.empty((num_nodes,) + tuple(s.shape), dtype=s.dtype, device=META),
        _meta_params(cfg),
    )
    opt_dtype = getattr(torch, cfg.opt_dtype)
    if cfg.optimizer == "adamw":
        opt = adamw.init(params, dtype=opt_dtype)
    else:
        opt = sgd.init(params, dtype=opt_dtype)
    w_mix = torch.empty((num_nodes, num_nodes), dtype=torch.float32, device=META)
    batch = SH.train_inputs(cfg, shape, num_nodes, microbatches=microbatches)

    p_sh = SR.param_shardings(params, cfg, mesh, num_nodes=num_nodes)
    if cfg.optimizer == "adamw":
        opt_sh = adamw.AdamWState(mu=p_sh, nu=p_sh, count=SR.P())
    else:
        opt_sh = sgd.SGDState(momentum=p_sh)
    b_sh = SR.batch_shardings(batch, mesh, num_nodes=num_nodes, layout=layout)

    mix_fn = None
    if gossip == "sparse":
        # Topology-aware gossip: the DecAvg graph is an ER graph at 2*p*
        # over the cohort; only neighbor slabs move (edge-colored ppermute
        # schedule) instead of the dense node-axis all-gather.
        from repro_torch.core import decavg, mixing as MX, topology as TO

        if num_nodes != mesh.shape.get("data", 0):
            raise ValueError("sparse gossip requires num_nodes == |data|")
        colors = MX.edge_coloring(TO.make(f"er:n={num_nodes}", seed=0))

        def mix_fn(w, p):
            return decavg.mix_permute(w, p, colors, mesh=mesh, node_axis="data")

    fn = ST.build_train_step(
        cfg,
        num_nodes=num_nodes,
        microbatches=microbatches,
        optimizer=cfg.optimizer,
        acc_dtype=opt_dtype,  # grad accumulator follows the optimizer dtype
        mix_fn=mix_fn,
    )
    args = (params, opt, w_mix, batch)
    return fn, args, (p_sh, opt_sh, SR.P(), b_sh), (p_sh, opt_sh, SR.P()), (0, 1)


def build_prefill(cfg, mesh, shape):
    params = _meta_params(cfg)
    batch = SH.prefill_inputs(cfg, shape)
    p_sh = SR.param_shardings(params, cfg, mesh, num_nodes=None)
    b_sh = SR.prefill_shardings(batch, mesh)
    data = mesh.shape.get("data", 1)
    out_sh = SR.P("data" if shape.global_batch % data == 0 else None)
    return ST.build_prefill_step(cfg), (params, batch), (p_sh, b_sh), out_sh, ()


def build_decode(cfg, mesh, shape):
    params = _meta_params(cfg)
    inputs = SH.decode_inputs(cfg, shape)
    p_sh = SR.param_shardings(params, cfg, mesh, num_nodes=None)
    in_sh = SR.decode_shardings(inputs, cfg, mesh)
    window = cfg.sliding_window if shape.name == "long_500k" else None
    fn = ST.build_serve_step(cfg, window=window)
    args = [params, inputs["token"], inputs["cache"]]
    specs = [p_sh, in_sh["token"], in_sh["cache"]]
    if cfg.enc_dec:
        args.append(inputs["memory"])
        specs.append(in_sh["memory"])
    return fn, tuple(args), tuple(specs), (in_sh["token"], in_sh["cache"]), (2,)


def build_decode_pipeline(cfg, mesh, shape):
    """The pipeline serving layout: `data` axis = pipeline stages (weights
    and cache stay put, activations rotate), manual megatron TP over
    `model`, per-rank int8 KV-head cache (``serve/pipeline_manual.py``).
    The step gets the global trees on ``meta``, where every mesh position
    lies, and places them itself (``launch.sharding.place``: views), the
    placement a caller on cards makes once."""
    from repro_torch.serve import pipeline_manual as PM
    from repro_torch.serve.pipeline import build_pipeline_step

    clen = SH.decode_cache_len(cfg, shape)
    tp = mesh.shape["model"]
    params = _meta_params(cfg)
    p_sh = PM.param_shardings(cfg, mesh, params)
    cache = PM.init_kv_cache(cfg, shape.global_batch, clen, tp=tp, device=META)
    c_sh = PM.cache_shardings(mesh)
    token = torch.empty((shape.global_batch,), dtype=torch.int32, device=META)
    window = cfg.sliding_window if shape.name == "long_500k" else None
    fn = build_pipeline_step(cfg, mesh, manual=True, window=window)
    tok_sh = SR.P("pod") if "pod" in mesh.shape else SR.P()
    return fn, (params, token, cache), (p_sh, tok_sh, c_sh), (tok_sh, c_sh), (2,)


def build(cfg, mesh, shape, *, num_nodes=None, microbatches=1, layout="tp",
          gossip="dense", serve_layout="sharded"):
    """The builder ``shape.kind`` (and ``serve_layout``) selects."""
    if shape.kind == "train":
        return build_train(cfg, mesh, shape, num_nodes=num_nodes, microbatches=microbatches,
                           layout=layout, gossip=gossip)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    if serve_layout == "pipeline":
        return build_decode_pipeline(cfg, mesh, shape)
    return build_decode(cfg, mesh, shape)


# ---------------------------------------------------------------------------
# Argument bytes and output checks
# ---------------------------------------------------------------------------


def spec_pairs(tree: PyTree, specs: PyTree, path: tuple = ()):
    """(path, leaf, spec) for every tensor leaf of ``tree``, ``specs`` a tree
    of the same structure whose leaves are ``PartitionSpec``s. None leaves
    (empty subtrees) are skipped."""
    where = "/".join(map(str, path))
    if tree is None:
        return
    if isinstance(specs, SR.PartitionSpec):
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"{where}: one spec for a {type(tree).__name__}")
        yield path, tree, specs
    elif isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(f"{where}: keys {sorted(tree)} vs specs {sorted(specs)}")
        for k in sorted(tree):
            yield from spec_pairs(tree[k], specs[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and len(tree) == len(specs):
        for i, (t, s) in enumerate(zip(tree, specs)):
            yield from spec_pairs(t, s, path + (i,))
    else:
        raise ValueError(f"{where}: a {type(tree).__name__} against specs {specs!r}")


def flat_leaves(tree: PyTree) -> list[tuple[tuple, torch.Tensor]]:
    """(path, tensor) in ``jax.tree`` leaf order (dict keys sorted, None
    skipped)."""
    out: list[tuple[tuple, torch.Tensor]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _slab_bytes(leaf: torch.Tensor, spec, mesh) -> int:
    """The largest slab of ``leaf`` over mesh positions under ``spec`` (only
    the axes the spec names move the slab)."""
    used = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
    axes = [a for a in mesh.axis_names if a in used]
    best = 0
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        pos = {a: 0 for a in mesh.axis_names} | dict(zip(axes, idx))
        slab = SR.local_slab(leaf, spec, mesh, pos)
        best = max(best, slab.numel() * slab.element_size())
    return best


def argument_bytes(args: PyTree, specs: PyTree, mesh, *, read: set | None = None) -> int:
    """Per-device argument bytes: for every input leaf (whose path is in
    ``read``, where given) its largest slab over mesh positions, summed."""
    return sum(_slab_bytes(leaf, spec, mesh) for p, leaf, spec in spec_pairs(args, specs)
               if read is None or p in read)


def _metadata_only(func) -> bool:
    """Ops that take a tensor for its shape and dtype alone."""
    name = func._schema.name.split("::")[-1]
    return name.endswith("_like") or name.startswith("new_")


class Reads(TorchDispatchMode):
    """Records the paths of the argument leaves that a traced step reads:
    those some operation other than a view or a ``*_like``/``new_*``
    factory takes as an operand, directly or through views of them."""

    def __init__(self, args: PyTree):
        super().__init__()
        self._paths = {id(t): p for p, t in flat_leaves(args)}
        self._alias: dict[int, int] = {}
        self._views: list[torch.Tensor] = []  # keeps the ids of views unique
        self.read: set[tuple] = set()

    def _root(self, t: torch.Tensor) -> int:
        return self._alias.get(id(t), id(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        operands = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        if func.is_view:
            if operands:
                root = self._root(operands[0])
                for o in tree_flatten(out)[0]:
                    if isinstance(o, torch.Tensor):
                        self._alias[id(o)] = root
                        self._views.append(o)
        elif not _metadata_only(func):
            for a in operands:
                p = self._paths.get(self._root(a))
                if p is not None:
                    self.read.add(p)
        return out


def _expected_outputs(kind: str, args: tuple) -> PyTree:
    """What the step must return, as tensors of the right shapes and dtypes:
    train (params, opt_state, loss), prefill the (B,) tokens, decode (the
    next (B,) tokens, the cache)."""
    if kind == "train":
        return (args[0], args[1], torch.empty((), dtype=torch.float32, device=META))
    if kind == "prefill":
        b = next(iter(args[1].values())).shape[0]
        return torch.empty((b,), dtype=torch.int32, device=META)
    return (args[1], args[2])


def _check_outputs(out: PyTree, want: PyTree, out_specs: PyTree, mesh) -> None:
    got = [(p, tuple(x.shape), x.dtype) for p, x in flat_leaves(out)]
    exp = [(p, tuple(x.shape), x.dtype) for p, x in flat_leaves(want)]
    if got != exp:
        diff = [(g, e) for g, e in zip(got, exp) if g != e][:3]
        raise AssertionError(f"outputs differ from the expected ({len(got)} vs {len(exp)} "
                             f"leaves; first differences {diff})")
    for _p, leaf, spec in spec_pairs(out, out_specs):
        SR.local_slab(leaf, spec, mesh, {a: 0 for a in mesh.axis_names})


def traced_config(cfg: ArchConfig, *, stages: int = 1) -> ArchConfig:
    """``cfg`` at full width with its stack cut to one period a stage (and
    an encoder of one layer)."""
    layers = min(cfg.num_layers, cfg.period * stages)
    return dataclasses.replace(cfg, num_layers=layers, enc_layers=min(cfg.enc_layers, 1))


@dataclasses.dataclass
class Trace:
    arg_bytes: int        # per device, the full config's arguments
    outputs: PyTree       # the traced step's outputs (meta tensors)
    traced_layers: int    # decoder layers traced
    seconds: float        # build and trace of the traced config


def trace(cfg: ArchConfig, mesh, shape, *, full_depth: bool = False, **kw) -> Trace:
    """Count ``cfg``'s per-device argument bytes on ``mesh``, then trace its
    step on ``meta`` (cut to one period unless ``full_depth``) and check
    the outputs against the shapes, dtypes and specs they must have. ``kw``:
    ``build``'s options."""
    _fn, full_args, in_specs, _out_specs, _donate = build(cfg, mesh, shape, **kw)
    stages = mesh.shape["data"] if kw.get("serve_layout") == "pipeline" else 1
    cut = cfg if full_depth else traced_config(cfg, stages=stages)
    t0 = time.perf_counter()
    fn, args, _in, out_specs, _donate = build(cut, mesh, shape, **kw)
    with Reads(args) as reads:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    _check_outputs(out, _expected_outputs(shape.kind, args), out_specs, mesh)
    # The cut config's leaves have the full config's paths.
    arg_bytes = argument_bytes(full_args, in_specs, mesh, read=reads.read)
    return Trace(arg_bytes, out, cut.num_layers, seconds)


def run_one(arch: str, shape_name: str, *, multi_pod: bool, layout: str = "tp",
            microbatches: int | None = None, gossip: str = "dense",
            serve_layout: str = "sharded") -> dict[str, Any]:
    cfg = cfgbase.get(arch)
    shape = SH.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    num_nodes = cfg.num_nodes_multi_pod if multi_pod else cfg.num_nodes_single_pod

    mb = 1
    window = None
    cache_len = 0
    eff_seq = SH.WHISPER_DEC_LEN if cfg.enc_dec else shape.seq_len
    if shape.kind == "train":
        mb = microbatches or MICROBATCHES.get(cfg.arch_id, 1)
        model_flops = 6.0 * analysis.active_param_count(cfg) * shape.global_batch * eff_seq
    elif shape.kind == "prefill":
        model_flops = 2.0 * analysis.active_param_count(cfg) * shape.global_batch * eff_seq
    else:
        window = cfg.sliding_window if shape.name == "long_500k" else None
        cache_len = SH.decode_cache_len(cfg, shape)
        model_flops = 2.0 * analysis.active_param_count(cfg) * shape.global_batch

    tr = trace(cfg, mesh, shape, num_nodes=num_nodes, microbatches=mb, layout=layout,
               gossip=gossip, serve_layout=serve_layout)
    roof = analysis.analyze(
        arch=cfg.arch_id,
        shape=shape_name,
        mesh_name=mesh_name,
        chips=chips,
        cfg=cfg,
        kind=shape.kind,
        batch=shape.global_batch,
        seq=eff_seq,
        cache_len=cache_len,
        window=window,
        num_nodes=num_nodes,
        microbatches=mb,
        arg_bytes=tr.arg_bytes,
        model_flops=model_flops,
        layout=layout,
        gossip=gossip,
        serve_layout=serve_layout,
    )
    row = roof.row()
    row["layout"] = layout
    row.update(
        num_nodes=num_nodes,
        lower_s=round(tr.seconds, 3),
        compile_s=None,
        status="ok",
        traced_layers=tr.traced_layers,
    )
    return row


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp_model"])
    ap.add_argument("--microbatches", type=int, default=None, help="override per-arch default")
    ap.add_argument("--gossip", default="dense", choices=["dense", "sparse"])
    ap.add_argument("--serve-layout", default="sharded", choices=["sharded", "pipeline"])
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    archs = list(cfgbase.ASSIGNED_ARCHS) if args.all or not args.arch else [args.arch]
    shape_names = list(SH.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    results = []
    t_all = time.perf_counter()
    for arch in archs:
        for shape_name in shape_names:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch} x {shape_name} x {mesh_name}"
                try:
                    row = run_one(arch, shape_name, multi_pod=mp, layout=args.layout,
                                  microbatches=args.microbatches, gossip=args.gossip,
                                  serve_layout=args.serve_layout)
                    print(
                        f"[ok] {tag}: dominant={row['dominant']} "
                        f"compute={row['compute_s']:.3e}s memory={row['memory_s']:.3e}s "
                        f"collective={row['collective_s']:.3e}s "
                        f"hbm/dev={row['per_device_hbm_gb']:.2f}GB "
                        f"(trace {row['lower_s']}s, {row['traced_layers']} layers)",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — report and continue
                    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
                results.append(row)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")

    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} combinations traced on meta in "
          f"{time.perf_counter() - t_all:.1f} s")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
