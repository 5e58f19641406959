"""The LLM cohort's kind of run: DecAvg over transformer LM members on
synthetic token streams, through ``LMCohortTrainer.run_fused``.

The trainer is built as ``experiments.runner``'s LM path builds one for the
spec ``{"kind": "lm", "arch": <config's arch>, "full_scale": true, "nodes",
"batch", "seq", "compress"}`` on the traffic's topology, backend and rate.
Before call 0 every member's weights are overwritten with one member drawn
by ``bench/inputs/lm_member.py`` from the seed and the configuration file's
numbers (the program's tree must have its paths, shapes and dtypes). Each
call is one such spec's run of the traffic's ``rounds_per_call`` rounds
(its staging, each piece's eager first run and CUDA-graph capture); the
window's calls record nothing (``eval_every`` null: one chunk, no
evaluation). The state carries from call to call, and call k draws its
token batches with data seed ``seed + k``.

Set-up ends with call 0, which records every round, so that the program is
read after round ``check_round`` and its gossip. That is round 1: the cosine
schedule has no warm-up rounds, so round 0's rate is 0 and round 1 is the
first whose local step moves the weights (round 0 still fills the
momentum). The plain reference (``bench/reference/jamba.py``) replays call
0's rounds up to it from the same first weights and the token batches of
``bench/inputs/tokens.py``, the benchmark's copy of the streams. Four
numbers:

- ``loss``: the widest gap between a member's loss and the reference's, over
  the rounds up to ``check_round``.
- ``momentum``: for each leaf, the norm over the members of its momentum (0.5
  g_0 + g_1 after round 1), the program's against the reference's, as a
  share of the larger of that leaf's and the median leaf's reference norm;
  the worst leaf.
- ``param_change``: the same of each leaf's change from the first weights,
  after the round's gossip.
- ``scan``: the selective scan of member 0's first Mamba layer in call 0's
  last local step (on the card a replay of the captured graph), its inputs,
  y, the gradient arriving at y and the gradient it hands each input all
  recorded there (``_ScanTap``), against the reference's sequential scan
  in f32 on the recorded inputs and gradient: the widest gap over y and
  each input's gradient, as a share of each tensor's largest entry. The
  other numbers compare the whole bf16 step, whose rounding is as large as
  a scan state held in bf16 would add (PERF.md); this one sees the scan
  alone. With no scan recorded it reads infinity.

Leaves whose reference momentum is under a thousandth of the median leaf's
are left out of ``momentum`` and ``param_change``.

Faults (``FAULTS``, planted by ``planted``) and the control reading (the
reference with its matmuls in float8, one precision below the config's bf16,
and its scan's state in bf16) are for ``bench/calibrate_lm.py`` and the
tests; the benchmark's own runs plant none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from bench.harness import ROOT, Cell, sync
from bench.inputs import lm_member, tokens

__all__ = ["NUMBERS", "FAULTS", "Inputs", "Run", "setup", "planted", "evals_per_call",
           "scan_counts", "scan_work", "mix_work", "span_calls", "replay_ms", "restage_ms",
           "captures_per_call", "device_ms_by_kernel", "reference_side", "reference_scan",
           "scan_number", "scan_gap", "gaps"]

NUMBERS = ("loss", "momentum", "param_change", "scan")
FAULTS = ("still", "gossip", "norms", "bf16_state")
SCAN_KERNELS = ("scan_fwd", "scan_bwd")  # the selective scan's CUDA kernels
SCAN_INPUTS = ("u", "dt", "dt_bias", "a", "bmat", "cmat", "d_skip")
_CHUNK = 1 << 24


@dataclasses.dataclass
class Inputs:
    """What the run is made of, for the readers."""

    seed: int
    nodes: int
    batch: int
    seq: int
    vocab: int
    mamba_layers: int  # Mamba mixers a member
    d_inner: int
    d_state: int
    params: int = 0  # a member's parameters
    member_bytes: int = 0  # a member's parameters' bytes, each in its dtype
    nnz: int = 0  # nonzeros of the gossip matrix W

    @property
    def tokens_per_round(self) -> int:
        return self.nodes * self.batch * self.seq


def evals_per_call(traffic: dict) -> int:
    """Recorded (evaluated) rounds a window call: none for ``eval_every``
    null, else ``run``'s cadence."""
    rounds, every = int(traffic["rounds_per_call"]), traffic["eval_every"]
    if every is None:
        return 0
    return len([r for r in range(rounds) if r % int(every) == 0 or r == rounds - 1])


def program_config(cell: Cell):
    """The program's config of the cell's arch, held to the configuration
    file's published numbers."""
    from repro_torch.configs import base as cfgbase

    conf = cell.config
    cfg = cfgbase.get(conf["arch"])
    want = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "intermediate_size": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "num_hidden_layers": cfg.num_layers,
            "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": cfg.tie_embeddings}
    if cfg.mamba is not None:
        want.update({"mamba_d_state": cfg.mamba.d_state, "mamba_d_conv": cfg.mamba.d_conv,
                     "mamba_expand": cfg.mamba.expand,
                     "mamba_dt_rank": cfg.mamba.rank(cfg.d_model)})
    bad = {k: (conf.get(k), v) for k, v in want.items() if conf.get(k) != v}
    if bad:
        raise SystemExit(f"{cell.name}: the program's {cfg.arch_id} differs from the "
                         f"configuration file (file, program): {bad}")
    return cfg


def build_trainer(cell: Cell, cfg, seed: int, device: torch.device):
    """``LMCohortTrainer`` as ``experiments.runner._run_lm`` builds it for the
    cell's spec at full scale."""
    from repro_torch.train.trainer import LMCohortTrainer

    tr = cell.traffic
    trainer = LMCohortTrainer(
        tr["topology"], cfg, nodes=int(tr["nodes"]), batch=int(tr["batch"]),
        seq=int(tr["seq"]), lr=float(tr["lr"]), schedule=tr["schedule"],
        backend=tr["backend"], matrix="decavg", gossip_every=int(tr["gossip_every"]),
        compress=tr["compress"], faults=None, seed=seed, device=device,
    )
    if not trainer.supports_fused:
        raise RuntimeError(f"backend {trainer.mix_impl!r} has no run_fused")
    return trainer


def load_member(trainer, member: dict[tuple, torch.Tensor]) -> None:
    """Every member of the unsharded ``trainer`` set to ``member`` (path ->
    leaf), whose paths, shapes and dtypes must be the program's."""
    from repro_torch.tree import tree_leaves

    if trainer.sharded:
        raise SystemExit("the lm kind loads its first weights into an unsharded cohort only")
    prog = dict(zip(_paths(trainer.params), tree_leaves(trainer.params)))
    want = {p: (tuple(x.shape[1:]), x.dtype) for p, x in prog.items()}
    got = {p: (tuple(x.shape), x.dtype) for p, x in member.items()}
    if want != got:
        diff = {"/".join(p): (got.get(p), want.get(p)) for p in set(want) | set(got)
                if got.get(p) != want.get(p)}
        raise SystemExit(f"the program's member differs from the configuration's "
                         f"(drawn, program): {diff}")
    with torch.no_grad():
        for p, x in prog.items():
            x.copy_(member[p].expand_as(x))


def _paths(tree, prefix=()) -> list[tuple]:
    """Leaf paths in ``tree_leaves``'s order (keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _norm(x: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """||x - minus|| (``minus`` broadcast over the member axis) in float64,
    a slice of the members at a time."""
    x = x.reshape(x.shape[0], -1)
    rows = max(1, _CHUNK // max(1, x.shape[1]))
    total = 0.0
    for lo in range(0, x.shape[0], rows):
        part = x[lo:lo + rows].double()
        if minus is not None:
            part -= minus.reshape(1, -1).double()
        total += float((part * part).sum())
    return total ** 0.5


class Side:
    """One side's readings: each member's losses a round, and per leaf the
    norms of the change from the first weights and of the momentum."""

    def __init__(self, losses, change, momentum):
        self.losses = np.asarray(losses, dtype=np.float64)
        self.change = np.asarray(change)
        self.momentum = np.asarray(momentum)


class Run:
    """The trainer after call 0, the program's side of call 0 (``prog``) and
    the window's calls."""

    def __init__(self, cell: Cell, seed: int, devices: list[torch.device]):
        tr = cell.traffic
        self.cell, self.seed, self.devices = cell, seed, devices
        self.cfg = program_config(cell)
        self.rounds_per_call, self.every = int(tr["rounds_per_call"]), tr["eval_every"]
        self.check = int(tr["check_round"])
        if not 0 < self.check < self.rounds_per_call or int(tr["gossip_every"]) != 1:
            raise SystemExit(f"{cell.name}: check_round {self.check} must be a round after "
                             f"round 0 of a call that gossips every round")
        self.evals_per_call = evals_per_call(tr)
        self.gossip_per_call = self.rounds_per_call
        self.trainer = build_trainer(cell, self.cfg, seed, devices[0])
        self.param_count = self.trainer.member_params
        cfg = self.cfg
        mamba = sum(sp.mixer == "mamba" for sp in cfg.pattern) * cfg.num_groups
        self.inputs = Inputs(seed, int(tr["nodes"]), int(tr["batch"]), int(tr["seq"]),
                             cfg.vocab_size, mamba,
                             cfg.mamba.inner(cfg.d_model) if cfg.mamba else 0,
                             cfg.mamba.d_state if cfg.mamba else 0,
                             self.param_count, self.trainer.member_bytes,
                             int(np.count_nonzero(_matrix(tr["topology"]))))
        # The first weights, one member's (every member starts from them).
        member = lm_member.init_member(cell.config, seed, devices[0])
        load_member(self.trainer, member)
        self.paths = _paths(self.trainer.params)
        self.first = [member[p].to("cpu") for p in self.paths]
        del member
        self.calls = 0
        tap = _ScanTap()
        with tap.recording():
            self.prog = self._first_call()
        self.scan = tap.take()

    def _run(self, every: int | None, on_round=None) -> None:
        self.trainer.seed = self.seed + self.calls
        self.trainer.run_fused(self.rounds_per_call, eval_every=every, on_round=on_round)
        sync(self.devices)

    def call(self, on_round=None) -> None:
        self.calls += 1
        self._run(self.every, on_round)

    def _first_call(self) -> Side:
        from repro_torch.tree import tree_leaves

        losses: list[np.ndarray] = []
        state: list[Side] = []

        def on_round(rec) -> None:
            t = self.trainer
            if rec["round"] <= self.check:
                losses.append(t.node_losses.cpu().numpy().astype(np.float64))
            if rec["round"] == self.check:
                dev = self.devices[0]
                change = [_norm(p, q.to(dev)) for p, q in zip(tree_leaves(t.params), self.first)]
                mom = [_norm(m) for m in tree_leaves(t.opt_state)]
                state.append(Side(losses, change, mom))

        self._run(1, on_round)
        return state[0]

    def release(self) -> None:
        self.trainer = None

    def compare(self, device: torch.device, precision: str = "f32") -> dict[str, float]:
        out = gaps(self.prog, reference_side(self, device, precision))
        if self.cfg.mamba is not None:
            out["scan"] = scan_number(self.scan, device)
        return out


def setup(cell: Cell, seed: int, devices: list[torch.device],
          lap: Callable[[str], None]) -> Run:
    """The trainer from ``seed`` and call 0."""
    run = Run(cell, seed, devices)
    lap("trainer and call 0")
    return run


def _star(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.int64)
    adj[0, 1:] = adj[1:, 0] = 1
    return adj


def _adjacency(topology: str) -> np.ndarray:
    """The graph of a ``star:n=<n>`` spec, hub at node 0, as the registry
    names it; other families are not this kind's."""
    family, _, params = topology.partition(":")
    kw = dict(p.split("=") for p in params.split(",") if p)
    if family != "star" or set(kw) != {"n"}:
        raise SystemExit(f"the lm kind's reference knows the star graph only, not {topology!r}")
    return _star(int(kw["n"]))


def _matrix(topology: str) -> np.ndarray:
    from bench.reference import jamba as reference

    return reference.eq1_matrix(_adjacency(topology))


def reference_side(run: Run, device: torch.device, precision: str = "f32") -> Side:
    """The reference's replay of call 0 up to its ``check_round`` from the
    first weights and call 0's token batches, and its readings."""
    from bench.reference import jamba as reference

    inp, tr = run.inputs, run.cell.traffic
    rounds = range(run.check + 1)
    toks, labels = tokens.round_slab(inp.nodes, rounds, inp.batch, inp.seq, inp.vocab,
                                     seed=run.seed)
    batches = [(torch.as_tensor(toks[r], device=device), torch.as_tensor(labels[r], device=device))
               for r in rounds]
    first: dict = {}
    for path, x in zip(run.paths, run.first):
        node = first
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.to(device)
    lrs = [reference.cosine_lr(float(tr["lr"]), run.rounds_per_call, r) for r in rounds]
    out = reference.cohort_rounds(first, run.cfg, _matrix(tr["topology"]), batches, lrs,
                                  precision=precision)
    change, mom = [], []
    for path, x0 in zip(run.paths, run.first):
        x0 = x0.to(device)
        change.append(_norm(torch.stack([_at(p, path) for p in out["params"]]), x0))
        mom.append(_norm(torch.stack([_at(m, path) for m in out["momentum"]])))
    return Side(out["losses"], change, mom)


class _Tap(torch.autograd.Function):
    """The identity, whose backward hands the gradient it passes on to
    ``keep``."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.keep(g)
        return g, None


class _ScanTap:
    """Records one selective scan on the timed path: while ``recording``,
    the first call of ``ops.selective_scan`` with gradients on in each run
    of the local-step piece (``_LMFusedRounds._local``): member 0's first
    Mamba layer, in its forward (remat's recompute calls the scan again and
    is not recorded). Its inputs (u taken to f32, as the scan reads it), y,
    the gradient arriving at y (``gy``) and the gradient the scan hands each
    input (``g_<input>``) are copied into buffers made at the piece's first,
    eager run; in the captured graph the copies are part of every replay,
    so after a call the buffers hold its last round's."""

    def __init__(self):
        self.bufs: dict[str, torch.Tensor] = {}
        self.armed = False
        self.calls = 0

    def keep(self, name: str, x: torch.Tensor) -> None:
        x = x.detach()
        if name in self.bufs:
            self.bufs[name].copy_(x)
        else:
            self.bufs[name] = x.clone()

    def _scan(self, scan):
        def tapped(u, dt, dt_bias, a, bmat, cmat, d_skip, h0=None, **kw):
            first = self.armed and self.calls == 0 and torch.is_grad_enabled()
            self.calls += self.armed
            if not first:
                return scan(u, dt, dt_bias, a, bmat, cmat, d_skip, h0, **kw)
            ins = [u.float(), dt, dt_bias, a, bmat, cmat, d_skip]
            for name, x in zip(SCAN_INPUTS, ins):
                self.keep(name, x)
            ins = [_Tap.apply(x, functools.partial(self.keep, "g_" + name))
                   for name, x in zip(SCAN_INPUTS, ins)]
            y, h_last = scan(*ins, h0, **kw)
            self.keep("y", y)
            return _Tap.apply(y, functools.partial(self.keep, "gy")), h_last

        return tapped

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.kernels import ops
        from repro_torch.train import trainer as T

        scan, local = ops.selective_scan, T._LMFusedRounds._local

        def armed_local(rounds) -> None:
            self.armed, self.calls = True, 0
            try:
                local(rounds)
            finally:
                self.armed = False

        ops.selective_scan, T._LMFusedRounds._local = self._scan(scan), armed_local
        try:
            yield self
        finally:
            ops.selective_scan, T._LMFusedRounds._local = scan, local

    def take(self) -> dict[str, torch.Tensor] | None:
        """The recorded tensors on the host, or None where the scan's forward
        or backward was not recorded."""
        bufs, self.bufs = self.bufs, {}
        want = {*SCAN_INPUTS, "y", "gy", *("g_" + k for k in SCAN_INPUTS)}
        if set(bufs) != want:
            return None
        return {k: v.cpu() for k, v in bufs.items()}


def _program_scan(rec: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    return [rec["y"], *(rec["g_" + k] for k in SCAN_INPUTS)]


def reference_scan(rec: dict[str, torch.Tensor], device: torch.device,
                   state_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """The reference's y and gradients of (u, dt, dt_bias, A, B, C, D) of
    sum(y * gy) on the recorded inputs and ``gy``, on the host."""
    import torch.nn.functional as F

    from bench.reference import jamba as reference

    leaves = [rec[k].to(device).requires_grad_(True) for k in SCAN_INPUTS]
    u, dt, dt_bias, a, bm, cm, d_skip = leaves
    with torch.enable_grad():
        y = reference.scan(u, F.softplus(dt + dt_bias), a, bm, cm, state_dtype) + d_skip * u
        grads = torch.autograd.grad((y * rec["gy"].to(device)).sum(), leaves)
    return [t.detach().cpu() for t in (y, *grads)]


def scan_number(rec: dict[str, torch.Tensor] | None, device: torch.device,
                state_dtype: torch.dtype | None = None) -> float:
    """``scan``: the recorded scan against the reference's (infinity where
    none was recorded)."""
    if rec is None:
        return math.inf
    return scan_gap(_program_scan(rec), reference_scan(rec, device, state_dtype))


def scan_gap(got: list[torch.Tensor], want: list[torch.Tensor]) -> float:
    """The widest gap over y and the gradients, as a share of each tensor's
    largest entry."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def _leaf_gap(got: np.ndarray, want: np.ndarray, keep: np.ndarray) -> float:
    scale = np.maximum(want, np.median(want))
    return float(np.max(np.abs(got - want)[keep] / scale[keep]))


def gaps(prog: Side, ref: Side) -> dict[str, float]:
    """The three numbers, program against reference."""
    if prog.losses.shape != ref.losses.shape:
        raise ValueError(f"losses of {prog.losses.shape} against {ref.losses.shape}")
    keep = ref.momentum >= 1e-3 * np.median(ref.momentum)
    return {
        "loss": float(np.max(np.abs(prog.losses - ref.losses))),
        "momentum": _leaf_gap(prog.momentum, ref.momentum, keep),
        "param_change": _leaf_gap(prog.change, ref.change, keep),
    }


# -- faults -------------------------------------------------------------------


def _bf16_state_source() -> Path:
    """The selective scan kernel's source with its state rounded to bf16
    after every step, in the forward and in the backward's recompute,
    written beside the benchmark's caches."""
    from repro_torch.kernels import selective_scan as ssk

    src = ssk.SOURCE.read_text()
    steps = ("      h = a * h + (dv * s_B[tt][n]) * uv;\n",
             "        h = expf(dv * an) * h + (dv * s_B[tt][n]) * s_u[tt][cl];\n")
    if any(src.count(line) != 1 for line in steps):
        raise RuntimeError("the selective scan's source no longer has the steps the "
                           "bf16_state fault rounds")
    src = src.replace("#include <cstdint>\n", "#include <cstdint>\n#include <cuda_bf16.h>\n")
    for line in steps:
        pad = line[:len(line) - len(line.lstrip())]
        src = src.replace(line, line + pad + "h = __bfloat162float(__float2bfloat16(h));\n")
    path = ROOT / ".bench_cache" / "faults" / "selective_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def _stepwise_bf16(ssm):
    """The plain chunked scan run one step at a time, its state rounded to
    bf16 after each step."""

    def faulted(a, bx, c, h0, chunk):
        ys, h = [], h0
        for t in range(a.shape[1]):
            y, h = ssm(a[:, t:t + 1], bx[:, t:t + 1], c[:, t:t + 1], h, 1)
            h = h.to(torch.bfloat16).float()
            ys.append(y)
        return torch.cat(ys, dim=1), h

    return faulted


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted for the block (None: as it is):

    - ``still``: a local step that returns the state unchanged (and zero
      losses);
    - ``gossip``: every gossip exchange left out;
    - ``norms``: Jamba's inner RMSNorms on dt, B and C left out;
    - ``bf16_state``: the selective scan's state held in bf16: on the card
      the kernel built from a copy of its source that rounds the state after
      every step (``_bf16_state_source``), on the CPU the plain scan a step
      at a time (``_stepwise_bf16``).
    """
    if fault is None:
        yield
        return
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.models import mamba
    from repro_torch.train import trainer as T

    patches = []
    if fault == "still":
        patches.append((T.LMCohortTrainer, "_local_step",
                        lambda self, params, opt, toks, labels, lr:
                        torch.zeros(toks.shape[0], device=toks.device)))
    elif fault == "gossip":
        patches.append((T.LMCohortTrainer, "_gossip", lambda self, mix: None))
    elif fault == "norms":
        # The weights stay (a leaf autograd must reach), the normalising goes.
        patches.append((mamba, "rms_norm", lambda x, w, eps=1e-5: x * w.float()))
    elif fault == "bf16_state":
        # The wrapper builds and loads whatever SOURCE names on its next launch;
        # CPU tensors take the plain scan, here one step at a time.
        patches += [(ssk, "SOURCE", _bf16_state_source()), (ssk, "_lib", None),
                    (mamba, "_ssm_chunked", _stepwise_bf16(mamba._ssm_chunked))]
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


# -- what the readers share ----------------------------------------------------

_SPANS = "lm: span calls"  # keys no metric can have
_KERNELS = "lm: kernel ms"
SPAN_CALLS = 2


def _program_call(ctx) -> Callable[[], None]:
    tr, traffic = ctx.trainer, ctx.cell.traffic
    rounds, every = int(traffic["rounds_per_call"]), traffic["eval_every"]

    def call() -> None:
        tr.seed += 1  # fresh token batches, as the window's calls draw them
        tr.run_fused(rounds, eval_every=every)
        ctx.sync()

    return call


def span_calls(ctx) -> list | None:
    """The program's spans of ``SPAN_CALLS`` further calls of the cell (run
    once a traced run, then kept): a list of each call's finished spans, or
    None where the program has no spans or the cell runs on no card."""
    if _SPANS not in ctx._memo:
        ctx._memo[_SPANS] = _spans(ctx)
    return ctx._memo[_SPANS]


def _spans(ctx):
    if ctx.devices[0].type != "cuda" or ctx.trainer is None:
        return None
    try:
        from repro_torch import spans
    except ImportError as e:
        print(f"lm spans: no reading, the program has no spans: {e}", file=sys.stderr)
        return None
    call, out = _program_call(ctx), []
    spans.take()
    spans.enable()
    try:
        for _ in range(SPAN_CALLS):
            call()
            out.append(spans.take())
    finally:
        spans.disable()
    for k, got in enumerate(out):
        names = sorted({s.name for s in got})
        print(f"lm spans call {k}: " + ", ".join(
            f"{n} {sum(s.ms for s in got if s.name == n):.3f} ms x{sum(s.name == n for s in got)}"
            for n in names), file=sys.stderr)
    return out


def replay_ms(ctx, piece: str) -> float | None:
    """The median card ms of the ``piece.replay`` spans of ``piece``."""
    runs = span_calls(ctx)
    if not runs:
        return None
    ms = [s.attrs["device_ms"] for c in runs for s in c
          if s.name == "piece.replay" and s.attrs.get("piece") == piece and "device_ms" in s.attrs]
    return statistics.median(ms) if ms else None


def restage_ms(ctx) -> float | None:
    """The host's ms a call in re-staging (``bench/spans.py``'s ``RESTAGE``
    spans: the program, the staging, each piece's eager run and capture,
    releasing the graphs), the median over the span calls."""
    from bench.spans import RESTAGE

    runs = span_calls(ctx)
    if not runs:
        return None
    return statistics.median(sum(s.ms for s in c if s.name in RESTAGE) for c in runs)


def captures_per_call(ctx) -> float | None:
    """``piece.capture`` spans a call, over the span calls."""
    runs = span_calls(ctx)
    if not runs:
        return None
    return sum(s.name == "piece.capture" for c in runs for s in c) / len(runs)


def device_ms_by_kernel(ctx) -> tuple[dict[str, float], int] | None:
    """Card ms by kernel name over one further call under ``torch.profiler``
    (graph replays carry no host spans, so the device trace names the
    kernels), and the call's rounds; run once a traced run."""
    if _KERNELS not in ctx._memo:
        ctx._memo[_KERNELS] = _kernels(ctx)
    return ctx._memo[_KERNELS]


def _kernels(ctx):
    if ctx.devices[0].type != "cuda" or ctx.trainer is None:
        return None
    call = _program_call(ctx)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        call()
    events = prof.profiler.kineto_results.events()
    ms: dict[str, float] = {}
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            ms[ev.name()] = ms.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:8]
    print(f"lm profiled call {time.perf_counter() - t0:.3f} s; card ms by kernel: "
          + "; ".join(f"{k[:80]} {v:.2f}" for k, v in top), file=sys.stderr)
    return ms, int(ctx.cell.traffic["rounds_per_call"])


def scan_counts(b: int, s: int, d: int, n: int) -> dict[str, int]:
    """The selective scan's work on (B, S, d_inner, d_state), whatever
    implements it: its inputs read once and outputs written once in f32, and
    its f32 operations (an exp or a product 1, a multiply-add 2) for each
    (t, d, n). Forward: u and dt (B, S, d) and B, C (B, S, n) in, y out; 7
    operations (dt A, its exp, dt B, times u, a h + b x, C h summed). The
    backward, recomputing the states: dy, u, dt, B, C in, du, d dt, dB, dC
    out; 26 operations (the forward's first five again, then C dy + carry,
    g h', the three terms of d dt, dA's product and sum, du's, dB's and dC's
    products and sums, and the carry a g)."""
    bsd, bsn = b * s * d, b * s * n
    return {"fwd_bytes": 4 * (3 * bsd + 2 * bsn), "fwd_ops": 7 * bsd * n,
            "bwd_bytes": 4 * (5 * bsd + 4 * bsn), "bwd_ops": 26 * bsd * n}


def scan_work(inputs: Inputs, rounds: int, evals: int) -> dict[str, int]:
    """The scan work of a call of ``rounds`` rounds with ``evals`` recorded
    rounds: in each round each member's Mamba layers run the forward twice
    (the forward, and its recompute under remat) and the backward once; each
    recorded round's evaluation (none in the window's calls) runs the
    forward once more."""
    one = scan_counts(inputs.batch, inputs.seq, inputs.d_inner, inputs.d_state)
    layers = inputs.nodes * inputs.mamba_layers
    fwd = layers * (2 * rounds + evals)
    bwd = layers * rounds
    return {"bytes": fwd * one["fwd_bytes"] + bwd * one["bwd_bytes"],
            "ops": fwd * one["fwd_ops"] + bwd * one["bwd_ops"]}


def mix_work(inputs: Inputs) -> dict[str, int]:
    """A gossip round's work, whatever implements it: each member's
    parameters read once and written once in their dtypes, each nonzero of
    W read once (an f32 value and an int32 column), and a multiply and an
    add for each nonzero of W and each parameter."""
    return {"bytes": 2 * inputs.nodes * inputs.member_bytes + 8 * inputs.nnz,
            "ops": 2 * inputs.nnz * inputs.params}
