#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--baseline DIR] [--pipeline-train]

``--baseline DIR`` names a directory holding other versions of
gossip_mix.cu, sparse_gossip.cu and flash_attention.cu (an earlier commit's,
say): phases 4, 8 and 11 then also time them, in turns with the current ones
(baseline, current, current, baseline), on the same inputs in the same
process. ``--pipeline-train`` runs only phase 21's train step, which the
full run starts as a child process.

Phases, in order; any failure exits non-zero, and no phase catches and
carries on:

1. device   -- the machine's fingerprint (core.machine: host, torch and
               CUDA versions, each card's name and power limit), and the
               first card's name and power limit as nvidia-smi gives them;
2. build    -- compile every CUDA source of the port (gossip_mix.cu,
               sparse_gossip.cu and flash_attention.cu), one nvcc each,
               started together, and print ptxas's registers, spills and
               shared memory of each kernel, and the sparse kernels'
               dynamic shared memory and blocks a SM;
3. kernel   -- the gossip_mix kernel against its plain version on the card, at
               the main path's 8 leaf shapes, a ragged shape, (1, 1) and an
               N=300 ring (whole zero W tiles), in f32 (3e-5) and bf16 (2e-2),
               with tile skipping on and off;
4. times    -- times of one gossip round's 8 launches: kernel, plain
               version, torch.matmul, and the least time the card could
               take for the same work (bytes; the f32-FMA and 3xTF32
               operation counts beside). Each is timed twice: eagerly (CUDA
               events around launches from Python, the host's launch cost
               included) and on the device alone (CUDA events around the
               replay of a CUDA graph of the same launches);
5. main     -- the paper's DecAvg run through run_spec at full width (BA
               N=100, the 784-512-256-128-10 MLP, backend "pallas"): records
               stream, accuracy is finite and above chance, the kernel ran
               8 times per gossip round, and the run agrees with the dense
               backend;
6. checks   -- the port's smoke preset and its qualitative checks (printed,
               not asserted: the port's RNG differs from JAX's);
7. sparse   -- both sparse kernels against their plain versions, in f32
               (3e-5) and bf16 (2e-2): the three large_n layouts (ws, torus,
               caveman at N=1024) at the 4 leaf widths of the 784-64-10
               MLP, a ragged N=1001, D=1, graphs whose windows lap the
               staging ring (er p=0.02, ws rewired at beta=1), a star (one
               source row in every window), and a period stack from
               stack_block_ell with unequal tile counts;
8. stimes   -- times of one large_n gossip round (4 leaves, f32) and of its
               widest leaf (1024 x 50176) for each layout: each sparse
               kernel and torch.sparse.mm on a CSR W on the device alone
               (CUDA-graph replay) and eagerly, the plain version eagerly,
               beside the least time the card could take, a plain copy of
               the widest leaf (clone), and the source rows read a column
               slab (this design's and a design's that reads each row per
               destination row or 8-row block);
9. large_n  -- the large_n preset's three N=1024 hub_focused runs through
               run_spec on backend sparse_pallas: fused, the blocked kernel
               launched 4 times per gossip round, records finite; the same
               runs on backend sparse agree (per node within 3 of 1000 test
               examples, consensus 1e-3 relative); sparse loop and fused
               runs are bit-identical; dense loop and fused runs of the
               paper's N=100 run agree within 1e-6; and one gossip round of
               each layout through mix_sparse_pallas(blocked=False) (the row
               gather kernel) agrees with mix_sparse;
9b. sharded -- the node-sharded backends (plain PyTorch, no kernel
               launches): one mix of the large_n preset's BA N=4096 graph
               (784-64-10 MLP leaves, f32) on sparse_sharded over the
               default mesh (one shard per card) and over 8 shards on the
               card under both halo schedules, each identical to sparse;
               sharded (both schedules, N=100, 4 shards) and permute
               (ring:n=16, 16 shards) within 1e-5 of dense; one N=4096
               round on the device alone for sparse and each sparse_sharded
               mesh (S = 1, 2, 4, 8, 16) beside the bytes bound and the
               halo wire; the preset's
               N=4096 run through run_spec as written (fused, finite, its
               rounds/s and its own peak memory), the same spec on sparse with
               identical records, both through the trainer with identical
               params and momentum; and the large_n_smoke preset through
               run_sweep (every run fused);
10. flash    -- the flash-attention kernel against its plain version, in f32
               (3e-5) and bf16 (3e-2): the reference's four test cases, the
               engine's llama3.2-1b shapes (1, S, 32, 8, 64) for S = 128 to
               1024 and (4, 2048, 32, 8, 64), hd 80 and 128, ragged S=1001,
               S=2, and the zoo's hd-128 GQA groups 6, 7 and 8 (48, 56 and
               64 query heads over 8 KV heads, S=512) and group 7 at S=333;
11. ftimes   -- times at (1, 1024, 32, 8, 64) in bf16, eagerly and on the
               device alone, as in phase 4: the kernel, its plain version
               and scaled_dot_product_attention, beside the least time the
               card could take; the kernel against scaled_dot_product_attention
               at the engine's other admission buckets, S = 128, 256 and 512;
               the kernel, its plain version and scaled_dot_product_attention
               at dbrx's prefill (1, 1024, 48, 8, 128) beside the bound; and
               the host's time to launch one call;
12. serve    -- llama3.2-1b at full width (16 layers, d_model 2048, bf16,
               weights from seed 0) through Engine(slots=4, cache_len=1024):
               8 requests of 37 to 1000 prompt tokens, 16 new tokens each,
               greedy, cold and then warm; in the warm run the kernel
               launched once per layer per admission (128);
               each request's prefill logits through the kernel within 0.1 of
               the plain path's; time to first token, decode tokens/s and
               peak memory printed; the same requests with the weights in f32
               give the same tokens through the kernel and without it;
13. cli      -- python -m repro_torch.launch.serve with its defaults, on the
               card;
14. faults   -- the paper's N=100 run (full width) under churn (the top
               quarter of hubs killed at round 3), stragglers (a fifth of
               the nodes 2 rounds stale) and edge drops, through run_spec on
               the dense and sparse backends, loop and fused: records carry
               alive_count and alive_min is 75; loop and fused within 1e-6,
               the backends within 1e-5, dead nodes' params and momentum
               bit-unchanged from their death; the churn_smoke preset
               through run_sweep (hub_kill_hurts_more and its two AUCs
               printed, not asserted); one faulted gossip round's device
               time beside an unfaulted one, at N=100 on dense and at BA
               N=4096 on sparse (with its renormalization's time, summed
               slot by slot and as one row reduction);
15. compress -- CHOCO top-k gossip: the N=100 run on pallas (the loop) with
               compress=1.0 equals the uncompressed run (rtol 1e-5, atol
               1e-6), compress=0.25 through run_spec stays finite with 8
               gossip_mix launches a gossip round; the large_n ws N=1024 run
               on sparse_pallas, fused, compress=0.25, with 4 blocked-kernel
               launches a gossip round, agrees per node with the sparse
               backend's CHOCO run (phase 9's criterion); one CHOCO round's
               device time (top-k plus mix) at both sizes.

16. lm       -- LLM cohorts, reduced llama3.2-1b members (f32): the lm_smoke
               preset through run_sweep (6 runs, fused dense; its
               lm_gossip_spreads gate true, its margin printed); the ring:n=4
               run on dense, pallas (loop) and sparse_pallas, loop and fused,
               with compress off and 0.25: loop vs fused within 1e-6, the
               backends within 1e-5 over 3 rounds with compress off (the
               6-round gap printed), gossip_mix and the
               blocked kernel launched once per leaf per gossip round, and
               both held to W @ P on the 12 trained leaves (N=4, f32); hubs
               killed at round 0 on BA N=8: their params and both moments
               bit-unchanged, loop and fused;
17. lm_full  -- llama3.2-1b at full width (16 layers, d_model 2048, bf16,
               1.498 B parameters a member), 2 members on a ring, 4 steps,
               through python -m repro_torch.launch.train --full-scale on
               pallas (the loop, gossip_mix) and sparse_pallas (fused, the
               blocked kernel), CHOCO on (auto: 0.1), lr 3e-5: exit 0, finite
               records, 12 launches a gossip round, the loss falls from the
               first step to the last; peak memory and rounds/s printed;
               then one full-width round split on the device into
               forward+backward, AdamW, CHOCO (and its mix alone) and the
               rest, the references' gossip through gossip_mix, the blocked
               kernel and torch.matmul beside the bytes bound, both kernels
               held to W @ P on the 12 f32 references (N=2, D up to 268.4 M;
               the blocked kernel's one block has 6 padding rows) and on
               uniform rows of the widest leaf's shape, and the
               fused path's full-width round (sparse_pallas, CUDA graphs);
18. route    -- python -m repro_torch.experiments.serve_eval with its
               defaults (train a star cohort, checkpoint, params-only
               restore, route): router_beats_round_robin and the serve
               accuracies printed;
19. zoo      -- first each zoo arch's reduced config in f32: chunked prefill
               against token-by-token prefill at 2e-5 and 4 decode steps
               alike (jamba with dense FFNs; the MoE archs excepted, their
               routing groups differ), the Engine's tokens identical to
               generate's (internvl2; the MoE archs' agreement printed) and
               identical through the flash kernel and the plain path. Then
               each arch at full width (bf16, weights drawn on the card from
               seed 0, each freed before the next): rwkv6-3b (32 layers),
               whisper-base (6 + 6, encoder over 1500 stub frames) and
               jamba-v0.1-52b (8 of 32 layers) through generate, batch 4 x
               512 prompt tokens (whisper 432) + 16; dbrx-132b (2 of 40),
               arctic-480b (1 of 35) and internvl2-76b (4 of 80) through
               Engine(slots=4, cache_len=1024), 4 requests of 37 to 512
               tokens + 16, cold then warm, flash launched once per layer per
               admission, each request's bf16 prefill logits through the
               kernel within 0.1 of the plain path. Logits finite; parameter
               counts, prefill ms, decode tokens/s and peak memory printed,
               and torch.profiler over one prefill and one decode step (an
               admitting and a decoding Engine step);
20. zoo_lm   -- python -m repro_torch.launch.train --arch A for every zoo arch
               (reduced members, 4 on a ring, 3 steps, batch 2 x 64 tokens,
               CHOCO auto) on sparse_pallas (fused) and, for jamba and dbrx,
               on pallas (the loop), 4 processes at a time: exit 0, finite
               records, one launch per leaf per gossip round; then each
               arch's loop and fused runs on sparse_pallas in process within
               1e-6, the fused one's blocked launches counted;
21. pipeline -- llama3.2-1b at full width and depth (16 layers, d_model
               2048, 1.498 B parameters, weights from seed 0; no kernel
               launches) through launch.steps and both pipeline decoders,
               every mesh position on the card. In f32, batch 8, cache 1024,
               16 decode steps teacher-forced with the plain step's tokens:
               build_serve_step with the plain and the int8 cache, the auto
               variant on (data 4, model 1) and (4, 2) with both caches, the
               manual variant on (4, 2), (2, 8) and (pod 2, 2, 2); tokens
               equal the serve step's (int8 for the manual variant) except
               where its top-2 logit gap is below 1e-4 (rows and smallest gap
               printed); the auto variant's plain cache within 1e-5 of the
               serve step's, an int8 cache's first group within one level
               (scales 1e-5 relative; every group's levels printed), index
               advanced once a step; the auto variant's whole int8 cache
               within one level of the microgroup control (build_serve_step
               over each microgroup's rows alone, the caches concatenated;
               scales 1e-5 relative). build_prefill_step on 4 x 512-token
               prompts gives generate's first tokens (ms printed). In bf16:
               decode tokens/s of the serve step and both variants at (4, 2),
               each alone over 16 steps after a warm-up, with torch.profiler
               over one step and the share of tokens each shares with the
               plain step, free-running (printed, not asserted). Then
               build_train_step in a child process (this script with
               --pipeline-train, expandable segments on): 2 members, AdamW,
               2 microbatches of 2 x 128 tokens a member, W all 0.5, lr
               3e-5, 4 steps on one batch: the loss falls, peak memory
               printed;
22. dryrun   -- the production dry-run (launch.dryrun.run_one, traced on the
               ``meta`` device, no kernel): every arch at decode_32k and
               long_500k on both production meshes, and llama3.2-1b's
               train_4k and prefill_32k on (16, 16), each row ok, dominant
               term and per-device argument GB printed; then the dry-run held
               to the card on a (1, 1) mesh, llama3.2-1b at full width: the
               decode step (batch 8, cache 1024) and the prefill step (4 x
               512) built on ``meta`` and on the card, where the rise in
               allocated memory must be the dry-run's argument bytes within
               512 bytes a leaf (expandable segments on, so every block is
               its request rounded up to 512) and the real step's outputs
               must have the dry-run's shapes and dtypes (peak printed beside
               the argument bytes); the train step's arguments (2 members,
               AdamW) the same way, without running the step;
23. paper    -- the paper preset through run_sweep on the card (21 runs of
               40 rounds at N=100, dense): every run finishes on the card,
               and hub_beats_edge, hub_beats_edge_by_family and
               gossip_learns_g2 equal the reference's own sweep of the
               preset; rounds/s printed. Then the paper's grid through
               examples/torch_topology_study.py at its defaults (ER, BA, SBM
               x splits: 14 runs at N=50, 25 rounds, dense): each run's final
               accuracy, Table 1 and both qualitative claims lines printed
               (not asserted, as in the reference's), records finite, Table
               1's confusion rows summing to 1, wall time printed. Then the
               other three examples (examples/torch_*.py) at their smallest
               sizes, at once, on the card: exit 0.

The card's name and power limit (nvidia-smi) stand beside the numbers of
phases 17 to 23. A ``[walltime]`` line follows each phase.

The line before the last is a JSON object with one entry per kernel (its
launches: those of every path above that runs it, each path's counts set to
0 just before it and read just after); the last line is {"ok": true,
"device": {...}}. Without a CUDA card, or without
the repo beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
MLP_DIMS = (784, 512, 256, 128, 10)
# (N, D) of each flattened leaf of the paper MLP, in the trainer's leaf order.
LEAF_D = tuple(d for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]) for d in (b, a * b))
MAIN_SPEC = dict(
    topology="ba:n=100,m=2", partitioner="hub_focused", rounds=6, eval_every=2,
    batch_size=32, lr=0.05, momentum=0.9,
)
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# The large_n preset: N=1024 graphs and the 784-64-10 MLP, whose flattened
# leaves (trainer order: b, w of each layer) have these widths.
LARGE_N_TOPOLOGIES = ("ws:n=1024,k=8,beta=0.1", "torus:rows=32,cols=32",
                      "caveman:cliques=128,size=8")
LARGE_N_DIMS = (784, 64, 10)
LARGE_N_LEAF_D = tuple(d for a, b in zip(LARGE_N_DIMS[:-1], LARGE_N_DIMS[1:]) for d in (b, a * b))
# Flash attention (B, S, H, Hkv, hd, window): the reference's test cases, the
# engine's llama3.2-1b prefill shapes, the other head dims, ragged and tiny S,
# and the zoo's hd-128 GQA groups: 6 (dbrx, 48/8), 7 (arctic, 56/8: odd, so
# a block's second warpgroup idles on the last head) and 8 (internvl2, 64/8).
FLASH_ENGINE_CASES = [(1, s, 32, 8, 64, None) for s in (128, 256, 512, 1024)] + [
    (4, 2048, 32, 8, 64, None)]
FLASH_ZOO_CASES = [(1, 512, 48, 8, 128, None), (1, 512, 56, 8, 128, None),
                   (1, 512, 64, 8, 128, None), (1, 333, 56, 8, 128, None)]
FLASH_CASES = [(1, 64, 4, 2, 32, None), (2, 100, 8, 2, 32, None), (1, 128, 4, 4, 64, 48),
               (1, 96, 8, 1, 32, 16), *FLASH_ENGINE_CASES, (1, 256, 32, 32, 80, None),
               (1, 256, 96, 8, 128, None), (1, 1001, 32, 8, 64, None), (1, 2, 32, 8, 64, None),
               *FLASH_ZOO_CASES]
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
SERVE_LENS = (37, 100, 128, 200, 333, 512, 777, 1000)
SERVE_MAX_NEW = 16
# Slice E: the fault spec of phase 14 (hubs killed at round 3 of MAIN_SPEC's
# 6, stragglers, edge drops) and the CHOCO top-k fraction of phase 15.
FAULT_SPEC = ("churn:p_leave=1.0,p_join=0.0,frac=0.25,start=3@targeted=hubs;"
              "straggler:frac=0.2,delay=2;drop:p_edge=0.05")
CHOCO_K = 0.25
# bf16 logits through the kernel vs the plain path: both compute attention in
# f32 and round it to bf16, so they differ where the f32 results straddle a
# bf16 rounding boundary (1 ulp = 2^-8 relative); logits are about N(0, 1)
# at this init, with maxima near 5.
SERVE_LOGIT_TOL = 0.1
# Slice D: the reduced LM runs of phase 16 (the lm_smoke preset's member,
# batch and seq), its fault spec (a quarter of the BA hubs dead from round
# 0), and the full-width runs of phase 17.
LM_TOPOLOGY = "ring:n=4"
LM_FAULTS = "churn:p_leave=1.0,p_join=0.0,frac=0.25@targeted=hubs"
LM_FULL_STEPS = 4
# The full-width runs' learning rate. The CLI's default, 3e-4 under the
# cosine schedule with no warmup, overshoots a freshly drawn full-width
# member from its second AdamW step (`tools/lm_full_probe.py` runs the
# default and a same-batch probe of both rates); 3e-5 trains it.
LM_FULL_LR = 3e-5
LM_BACKEND_ROUNDS = 3
# Slice G, phase 19: each zoo arch at full width (bf16, weights from seed 0)
# with its depth cut to (layers run), served through generate or the Engine.
ZOO_RUNS = (("rwkv6-3b", 32, "generate"), ("whisper-base", 6, "generate"),
            ("jamba-v0.1-52b", 8, "generate"), ("dbrx-132b", 2, "engine"),
            ("arctic-480b", 1, "engine"), ("internvl2-76b", 4, "engine"))
ZOO_BATCH = 4
ZOO_PROMPT = 512
ZOO_ENGINE_LENS = (37, 128, 333, 512)
WHISPER_FRAMES = 1500  # a 30 s window
# Phase 20: the zoo's LM cohorts through launch.train (reduced members), the
# decoder-only archs: a cohort's batches carry no encoder frames, so whisper
# is refused (the reference's whisper cohort stops at KeyError 'frames').
# 8 steps at a rate for each optimizer at which the loss falls: the cosine
# schedule's first step has lr 0, and at the CLI's default 3e-4 SGD moves the
# loss less than its spread from one round's batch to the next.
ZOO_LM_ARCHS = ("jamba-v0.1-52b", "dbrx-132b", "arctic-480b", "rwkv6-3b", "internvl2-76b")
ZOO_LM_STEPS = 8
ZOO_LM_LR = {"sgd": 0.1, "adamw": 3e-3}
ZOO_LM_ARGS = ("--nodes", "4", "--topology", "ring", "--steps", str(ZOO_LM_STEPS),
               "--batch", "2", "--seq", "64")
# In process, loop against fused over the reference's parity horizon.
ZOO_LM_ROUNDS = 3
# Phase 21 (slice G2): llama3.2-1b at full width through the step builders
# and both pipeline decoders, every mesh position on the one card.
PIPE_BATCH = 8
PIPE_CACHE = 1024
PIPE_STEPS = 16
PIPE_AUTO_MESHES = ((4, 1), (4, 2))
PIPE_MANUAL_MESHES = (((4, 2), ("data", "model")), ((2, 8), ("data", "model")),
                      ((2, 2, 2), ("pod", "data", "model")))
# A chosen token may differ from the plain step's only where the plain step's
# top-2 logit gap at that row is below this.
PIPE_GAP = 1e-4
PIPE_PREFILL = (4, 512)
PIPE_TRAIN_STEPS = 4
# Each member's 4 x 128 tokens a step in 2 microbatches (the grads summed in
# an f32 accumulator, 12 GB more than one): 71.942 GiB of the card's 79.179.
# After phases 1-20 in one process it ran out of memory (allocator
# fragmentation), so it runs in a child process with expandable segments.
PIPE_TRAIN_MICROBATCHES = 2
PIPE_TRAIN_ROWS = 4
PIPE_TRAIN_SEQ = 128
# Phase 22 (slice H): the dry-run's rows, traced on ``meta`` (the host), for
# every arch at these shapes on both production meshes and llama3.2-1b's
# train and prefill rows on (16, 16); then its argument bytes and outputs
# held to the card at phase 21's sizes (decode batch 8, cache 1024; prefill
# 4 x 512; train 2 members, AdamW, 4 x 128 tokens a member). The caching
# allocator rounds every block up to a multiple of 512 bytes.
DRY_SHAPES = ("decode_32k", "long_500k")
DRY_LLAMA_ROWS = ("train_4k", "prefill_32k")
DRY_PREFILL = (4, 512)
DRY_ALLOC_SLACK = 512
# Phase 23: the qualitative checks of the reference's own paper sweep, run
# on the CPU with `python -m repro.experiments.sweep --preset paper
# --processes 8` on commit 2164295 (21 runs, 40 rounds, dense).
PAPER_REF_CHECKS = {"hub_beats_edge": True, "hub_beats_edge_by_family": {"ba": True, "er": True},
                    "gossip_learns_g2": True}
# Then the paper's grid through examples/torch_topology_study.py at its
# defaults (14 runs, N=50, 25 rounds; its records under results/paper_torch/).
STUDY_RUNS = 14
# The port's examples at their smallest sizes, on the card (script,
# arguments, a line the output must hold).
EXAMPLE_RUNS = (
    ("torch_quickstart.py", ("--nodes", "10", "--rounds", "2", "--train-per-class", "60",
                             "--test-per-class", "10"), "mean recall on never-seen classes"),
    ("torch_serve_decode.py", ("--gen", "4"), "through a 16-slot ring cache"),
    ("torch_decentralized_llm.py", ("--steps", "3", "--seq", "16", "--batch", "2"),
     "consensus distance across nodes"),
)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


class Laps:
    """Wall time of each phase: ``lap(name)`` prints the time since the
    previous lap (or the start), and the total."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        phase("walltime", f"{name}: {now - self.last:.2f} s (total {now - self.t0:.2f} s)")
        self.last = now


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the device alone: ``reps`` calls
    captured in one CUDA graph, replayed ``rounds`` times between CUDA
    events, so the host's launch cost between kernels does not count."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * reps)


def in_turns(module, baseline, fn, timer) -> tuple[list[float], list[float]]:
    """Times of ``fn`` through ``module``'s kernel library and, when a
    baseline library is given, through that one too, in the order baseline,
    current, current, baseline. Returns (current times, baseline times)."""
    if baseline is None:
        return [timer(fn)], []
    current = module._lib
    got = {"current": [], "baseline": []}
    try:
        for which in ("baseline", "current", "current", "baseline"):
            module._lib = current if which == "current" else baseline
            got[which].append(timer(fn))
    finally:
        module._lib = current
    return got["current"], got["baseline"]


def load_baseline(directory: Path | None):
    """The baseline versions of gossip_mix.cu, sparse_gossip.cu and
    flash_attention.cu in ``directory``, built and loaded like the current
    ones (three Nones without a directory)."""
    if directory is None:
        return None, None, None
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import sparse_gossip as sg
    from repro_torch.kernels.nvcc import build_library, load_library

    build_dir = ROOT / "src" / "repro_torch" / "kernels" / "build" / "baseline"
    sources = [directory / m.SOURCE.name for m in (gm, sg, fa)]
    with ThreadPoolExecutor(max_workers=3) as pool:
        paths = list(pool.map(lambda src: build_library(src, build_dir), sources))
    libs = []
    for module, names, path in zip((gm, fa), (("gossip_mix_f32", "gossip_mix_bf16"),
                                              ("flash_attention_fwd",)), paths[::2]):
        current = module._library()
        libs.append(load_library(path, {n: getattr(current, n).argtypes for n in names}))
    return libs[0], sg.open_library(paths[1]), libs[1]


def kernel_resources(report: list[str]) -> list[str]:
    """One line per kernel from ptxas's report: the kernel and its template
    arguments (as mangled), registers, spills and static shared memory."""
    out = []
    for line in report:
        entry = re.search(r"Compiling entry function .*?\d((?:gossip|flash|ell|blocked|window)\w*?_kernel)"
                          r"(?:I(\w*?)E)?E*v", line)
        if entry:
            out.append(f"{entry.group(1)}<{entry.group(2) or ''}>:")
        elif out:
            out[-1] += " " + line.rstrip(".")
    return out


def sparse_occupancy(lib) -> list[str]:
    """The sparse kernels' dynamic shared memory and blocks a SM, as the
    library recorded them when it was loaded."""
    fn = lib.sparse_gossip_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = []
    for blocked in (0, 1):
        for bf16 in (0, 1):
            for bulk in (1, 0):
                smem, blocks = ctypes.c_int(), ctypes.c_int()
                if fn(blocked, bf16, bulk, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
                    fail("sparse_gossip_occupancy failed")
                out.append(f"window_kernel<{'blocked' if blocked else 'ell'}, "
                           f"{'bf16' if bf16 else 'f32'}, {'bulk' if bulk else 'loads'}>: "
                           f"{smem.value} bytes dynamic shared memory, {blocks.value} blocks a SM")
    return out


def spread(times: list[float]) -> str:
    return "-".join(f"{t:.4f}" for t in sorted(times)) if times else "n/a"


def main_path_w(dev):
    """The main path's mixing matrix: decavg weights over the BA graph with
    the hub_focused partition's data sizes, exactly as the runner builds it."""
    from repro_torch.core import topology
    from repro_torch.core.decavg import GossipEngine
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.experiments.runner import build_partition
    from repro_torch.experiments.spec import ExperimentSpec

    spec = ExperimentSpec(**MAIN_SPEC)
    ds = make_mnist_like(**spec.data)
    parts = build_partition(spec, topology.make_schedule(spec.topology, seed=spec.seed).graph_at(0),
                            ds.y_train)
    sizes = np.array([len(p) for p in parts], dtype=np.float64)
    return GossipEngine(spec.topology, data_sizes=sizes, backend="dense", seed=spec.seed,
                        device=dev).w


def ring_w(n: int, dev) -> torch.Tensor:
    w = torch.zeros(n, n)
    for i in range(n):
        for j in (i - 1, i, i + 1):
            w[i, j % n] = 1.0 / 3.0
    return w.to(dev)


def block_sparse_w(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    w = torch.rand(n, n, generator=gen, device=dev)
    w[: n // 2, n // 2:] = 0.0
    w += torch.eye(n, device=dev)
    return w / w.sum(dim=1, keepdim=True)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory with other versions of gossip_mix.cu, sparse_gossip.cu and "
                         "flash_attention.cu to time in turns with the current ones")
    ap.add_argument("--pipeline-train", action="store_true",
                    help="run only phase 21's build_train_step (the full run starts it as a "
                         "child process)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.machine import machine_fingerprint

    # The machine's fingerprint; its first card's name and power limit
    # (nvidia-smi's) stand beside every number below.
    fingerprint = machine_fingerprint()
    smi = f"{fingerprint['devices'][0]}, {fingerprint['power_limit'][0]}"
    if args.pipeline_train:
        from repro_torch.configs import base as cfgbase

        pipeline_train(cfgbase.get("llama3.2-1b"), torch.device("cuda"), smi)
        return 0
    from repro_torch.experiments import analysis, presets, runner
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import sparse_gossip as sg
    from repro_torch.kernels.nvcc import ptxas_report
    from repro_torch.train.trainer import DecentralizedTrainer

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    laps = Laps()

    # 1. device
    phase("device", f"torch: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase("device", "fingerprint " + json.dumps(fingerprint))
    print(smi, flush=True)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = [f.result() for f in [pool.submit(m.build) for m in (gm, sg, fa)]]
    gm._library()
    sg.load()
    fa._library()
    phase("build", f"{', '.join(lib.name for lib in libs)} built and loaded in "
                   f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in kernel_resources(ptxas_report(lib)):
            phase("build", line)
    for line in sparse_occupancy(sg.load()):
        phase("build", line)
    base_gm, base_sg, base_fa = load_baseline(args.baseline)
    if args.baseline is not None:
        phase("build", f"baseline sources from {args.baseline} built and loaded")

    laps.lap("1-2 device, build")

    # 3. kernel against plain, on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    w_main = main_path_w(dev)
    cases = [(f"leaf(100,{d})", w_main, d) for d in LEAF_D]
    cases += [("ragged(130,513)", block_sparse_w(130, gen, dev), 513),
              ("(1,1)", torch.ones(1, 1, device=dev), 1),
              ("ring(300,65536)", ring_w(300, dev), 65536)]
    main_err = 0.0
    for name, w, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            p = (torch.rand(w.shape[1], d, generator=gen, device=dev) * 2 - 1).to(dtype)
            want = gm.gossip_mix_ref(w, p).float()
            for skip in (True, False):
                got = gm.gossip_mix(w, p, block_sparse=skip)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape:
                    fail(f"{name} {dtype}: got {got.dtype} {tuple(got.shape)}")
                err = float((got.float() - want).abs().max())
                phase("kernel", f"{name:18s} {str(dtype):15s} skip={int(skip)} "
                                f"max_abs_err={err:.3e} (tol {TOL[dtype]:g})")
                if not err <= TOL[dtype]:
                    fail(f"{name} {dtype} skip={skip}: max_abs_err {err} > {TOL[dtype]}")
                if name.startswith("leaf") and dtype == torch.float32:
                    main_err = max(main_err, err)

    laps.lap("3 kernel")

    # 4. times of one gossip round at the main path's shapes (f32), eagerly
    # (host launch included) and on the device alone (graph replay)
    leaves = [torch.rand(100, d, generator=gen, device=dev) * 2 - 1 for d in LEAF_D]
    kernel_round = lambda: [gm.gossip_mix(w_main, p) for p in leaves]  # noqa: E731
    plain_round = lambda: [gm.gossip_mix_ref(w_main, p) for p in leaves]  # noqa: E731
    lib_round = lambda: [torch.matmul(w_main, p) for p in leaves]  # noqa: E731
    round_dev = lambda fn: device_ms(fn, reps=5)  # noqa: E731
    eager_k, eager_base = in_turns(gm, base_gm, kernel_round, time_ms)
    dev_k, dev_base = in_turns(gm, base_gm, kernel_round, round_dev)
    t_kernel = sum(dev_k) / len(dev_k)
    t_plain, t_plain_e = round_dev(plain_round), time_ms(plain_round)
    t_lib, t_lib_e = round_dev(lib_round), time_ms(lib_round)
    nnz = int((w_main != 0).sum())
    n = w_main.shape[0]
    d_total = sum(LEAF_D)
    bytes_moved = 4 * (2 * n * d_total + len(LEAF_D) * n * n)
    ops = 2 * nnz * d_total  # the multiply-adds this W needs; dense would be 2*n*n*D
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    dense_ops_ms = 2 * n * n * d_total / F32_FLOP_PER_S * 1e3
    tf32x3_ops_ms = 3 * 2 * n * n * d_total / TF32_FLOP_PER_S * 1e3
    for d, p in zip(LEAF_D, leaves):
        tk = device_ms(lambda p=p: gm.gossip_mix(w_main, p))
        tl = device_ms(lambda p=p: torch.matmul(w_main, p))
        leaf_bound = 4 * 2 * n * d / HBM_BYTES_PER_S * 1e3
        phase("times", f"leaf(100,{d}) on the device: kernel {tk:.4f} ms, torch.matmul {tl:.4f} ms, "
                       f"bytes bound {leaf_bound:.4f} ms")
    w_ring = ring_w(300, dev)
    p_ring = torch.rand(300, 401408, generator=gen, device=dev)
    t_skip = time_ms(lambda: gm.gossip_mix(w_ring, p_ring, block_sparse=True))
    t_noskip = time_ms(lambda: gm.gossip_mix(w_ring, p_ring, block_sparse=False))
    phase("times", f"ring(300,401408): skip on {t_skip:.4f} ms, skip off {t_noskip:.4f} ms")
    phase("times", f"gossip round (8 leaves, {n * d_total} f32 values) on the device: kernel "
                   f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, torch.matmul {t_lib:.4f} ms; "
                   f"eagerly: kernel {spread(eager_k)} ms, plain {t_plain_e:.4f} ms, torch.matmul "
                   f"{t_lib_e:.4f} ms; bound {bound:.4f} ms (bytes {t_bytes:.4f} ms, nnz(W)={nnz} "
                   f"ops {t_ops:.4f} ms, dense f32-FMA ops {dense_ops_ms:.4f} ms, dense 3xTF32 ops "
                   f"{tf32x3_ops_ms:.4f} ms)")
    if dev_base:
        phase("times", f"gossip round in turns (baseline, current, current, baseline): on the "
                       f"device baseline {spread(dev_base)} ms, current {spread(dev_k)} ms; eagerly "
                       f"baseline {spread(eager_base)} ms, current {spread(eager_k)} ms")

    laps.lap("4 times")

    # 5. the main path, through the entry point a user calls
    with tempfile.TemporaryDirectory() as tmp:
        spec = ExperimentSpec(**MAIN_SPEC, backend="pallas")
        store = ResultsStore(str(Path(tmp) / "main.jsonl"))
        reset_launches()
        t0 = time.perf_counter()
        out = runner.run_spec(spec, store, raise_on_error=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        records = store.curves(spec.run_id)
        eval_rounds = [r for r in range(spec.rounds)
                       if r % spec.eval_every == 0 or r == spec.rounds - 1]
        if [r["round"] for r in records] != eval_rounds:
            fail(f"records for rounds {[r['round'] for r in records]}, want {eval_rounds}")
        for r in records:
            for key in ("mean_acc", "min_acc", "g2_acc_spread", "consensus_mean"):
                if not math.isfinite(r[key]):
                    fail(f"round {r['round']}: {key} = {r[key]}")
        final = out["final"]
        if not final["mean_acc"] > 0.11:  # chance is 0.10
            fail(f"final mean_acc {final['mean_acc']} is not above chance")
        gossip_rounds = spec.rounds  # gossip_every = 1
        want = len(LEAF_D) * gossip_rounds
        if launches["gossip_mix"] != want:
            fail(f"gossip_mix launched {launches['gossip_mix']} times, want {want}")
        if final["device"] != kind or final["framework"] != "torch":
            fail(f"run_end.final says {final['framework']} on {final['device']}")
        phase("main", f"{spec.run_id}: {len(records)} records, final mean_acc "
                      f"{final['mean_acc']:.4f}, g2_acc_spread {final['g2_acc_spread']:.4f}, "
                      f"consensus_mean {final['consensus_mean']:.4f}; gossip_mix launches "
                      f"{launches['gossip_mix']} = 8 x {gossip_rounds}; {spec.rounds / wall:.3f} "
                      f"rounds/s ({wall:.2f} s, data and set-up included)")

        # Same spec, dense backend: the streamed records agree. Accuracy
        # within 3 test examples of 1000 and consensus to 1e-3: the two
        # backends sum W @ P in different orders (f32 either way), and six
        # rounds of SGD carry the rounding differences along.
        dense_spec = ExperimentSpec(**MAIN_SPEC, backend="dense")
        runner.run_spec(dense_spec, store, raise_on_error=True)
        acc_tol, cons_rtol = 3e-3, 1e-3
        for a, b in zip(records, store.curves(dense_spec.run_id)):
            for key in ("mean_acc", "min_acc", "max_acc", "g2_acc_spread"):
                if abs(a[key] - b[key]) > acc_tol:
                    fail(f"round {a['round']} {key}: pallas {a[key]} vs dense {b[key]}")
            if abs(a["consensus_mean"] - b["consensus_mean"]) > cons_rtol * b["consensus_mean"]:
                fail(f"round {a['round']} consensus: {a['consensus_mean']} vs {b['consensus_mean']}")

    # Per node: the same run through the trainer for both backends.
    per_node = {}
    for backend in ("pallas", "dense"):
        from repro_torch.core import topology
        from repro_torch.data.loader import NodeLoader
        from repro_torch.data.synthetic import make_mnist_like

        s = ExperimentSpec(**MAIN_SPEC, backend=backend)
        ds = make_mnist_like(**s.data)
        sched = topology.make_schedule(s.topology, seed=s.seed)
        parts = runner.build_partition(s, sched.graph_at(0), ds.y_train)
        loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=s.batch_size,
                            seed=s.seed + 1, device=dev)
        tr = DecentralizedTrainer(sched, loader, lr=s.lr, momentum=s.momentum,
                                  mix_impl=backend, seed=s.seed, device=dev)
        per_node[backend] = tr.run(s.rounds, eval_every=s.rounds,
                                   x_test=ds.x_test, y_test=ds.y_test)[-1]
    acc_diff = float(np.abs(per_node["pallas"].per_node_acc - per_node["dense"].per_node_acc).max())
    cons_diff = float(np.max(np.abs(per_node["pallas"].consensus - per_node["dense"].consensus)
                             / per_node["dense"].consensus))
    phase("main", f"pallas vs dense after {MAIN_SPEC['rounds']} rounds: per-node accuracy "
                  f"max diff {acc_diff:.4f} (tol {acc_tol}), consensus max rel diff "
                  f"{cons_diff:.2e} (tol {cons_rtol})")
    if acc_diff > acc_tol or cons_diff > cons_rtol:
        fail("pallas and dense backends disagree per node")

    laps.lap("5 main")

    # 6. the smoke preset's qualitative checks (recorded, not asserted)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "smoke.jsonl")
        summary = runner.run_sweep(presets.get_preset("smoke"), path)
        if summary["failed"]:
            errors = [r for r in ResultsStore(path).records()
                      if r.get("kind") == "run_end" and r.get("status") != "completed"]
            fail(f"smoke preset runs failed: {errors}")
        checks = analysis.qualitative_checks(analysis.summarize(ResultsStore(path)))
        phase("checks", "smoke preset (seed 0): " + json.dumps(
            {k: checks.get(k) for k in ("hub_beats_edge", "hub_beats_edge_by_family",
                                        "gossip_learns_g2")}))

    laps.lap("6 checks")

    # 7-9. slice B: the sparse kernels and the large-N path
    sparse_err = sparse_kernel_checks(dev, gen)
    laps.lap("7 sparse")
    sparse_times = sparse_round_times(dev, gen, base_sg)
    laps.lap("8 stimes")
    large_n_launches = large_n_main_path(dev, kind)
    laps.lap("9 large_n")
    sharded_main_path(dev, kind, smi)
    laps.lap("9b sharded")

    # 10-13. slice C: the flash-attention kernel and serving
    flash_err = flash_kernel_checks(dev, gen)
    laps.lap("10 flash")
    flash_times = flash_attention_times(dev, gen, base_fa)
    laps.lap("11 ftimes")
    flash_launches = serve_main_path(dev)
    laps.lap("12 serve")
    serve_cli()
    laps.lap("13 cli")

    # 14-15. slice E: faults and CHOCO compressed gossip
    faults_main_path(dev, kind)
    laps.lap("14 faults")
    choco_launches = compress_main_path(dev, kind)
    laps.lap("15 compress")
    # 16-18. slice D: LLM-cohort training, then routing over a trained cohort
    lm_launches, lm_err = lm_main_path(dev)
    laps.lap("16 lm")
    full_launches, full_err = lm_full_width(dev, smi)
    laps.lap("17 lm_full")
    route_cli(smi)
    laps.lap("18 route")
    # 19-20. slice G: the rest of the model zoo, served and trained
    zoo_flash = zoo_main_path(dev, smi)
    laps.lap("19 zoo")
    zoo_lm_launches, zoo_lm_err = zoo_lm_main_path(dev, smi)
    laps.lap("20 zoo_lm")
    # 21. slice G2: the step builders and the pipeline-parallel decoders
    pipeline_main_path(dev, smi)
    laps.lap("21 pipeline")
    # 22. slice H: the dry-run on meta, held to the card
    dryrun_rows()
    dryrun_card_check(dev, smi)
    laps.lap("22 dryrun")
    # 23. the paper preset on the card (owed since slice A), and the examples
    paper_sweep(kind, smi)
    topology_study(smi)
    examples_on_card(smi)
    laps.lap("23 paper, examples")
    path_launches = {**large_n_launches, "gossip_mix": launches["gossip_mix"],
                     "flash_attention": flash_launches + zoo_flash}
    for part in (choco_launches, lm_launches, full_launches, zoo_lm_launches):
        for name, n in part.items():
            path_launches[name] += n

    def entry(name, source, replaces, t, err):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }

    print(json.dumps({"kernels": [
        entry("gossip_mix", "src/repro_torch/kernels/csrc/gossip_mix.cu",
              "src/repro/kernels/gossip_mix.py:106",
              {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": bound,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": t_lib},
              max(main_err, lm_err["gossip_mix"], full_err["gossip_mix"],
                  zoo_lm_err["gossip_mix"])),
        entry("sparse_gossip_blocked", "src/repro_torch/kernels/csrc/sparse_gossip.cu",
              "src/repro/kernels/sparse_gossip.py:129", sparse_times["sparse_gossip_blocked"],
              max(sparse_err["sparse_gossip_blocked"], lm_err["sparse_gossip_blocked"],
                  full_err["sparse_gossip_blocked"], zoo_lm_err["sparse_gossip_blocked"])),
        entry("sparse_gossip", "src/repro_torch/kernels/csrc/sparse_gossip.cu",
              "src/repro/kernels/sparse_gossip.py:196", sparse_times["sparse_gossip"],
              sparse_err["sparse_gossip"]),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:101", flash_times, flash_err),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def sparse_layouts(spec: str, dev) -> tuple[dict, object]:
    """Both kernels' layouts of a topology's decavg W (uniform data sizes),
    as (wrapper, plain version, idx, val) per kernel, and the CSR."""
    from repro_torch.core import sparse, topology
    from repro_torch.kernels import sparse_gossip as sg

    csr = sparse.csr_from_graph(topology.make(spec, seed=0))
    idx, val = sparse.ell_from_csr(csr)
    bell = sparse.block_ell_from_csr(csr)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return {
        "sparse_gossip_blocked": (sg.gossip_mix_sparse_blocked, sg.sparse_gossip_blocked_ref,
                                  t(bell.idx), t(bell.val)),
        "sparse_gossip": (sg.gossip_mix_sparse, sg.sparse_gossip_ref, t(idx), t(val)),
    }, csr


def sparse_kernel_checks(dev, gen) -> dict[str, float]:
    """Phase 7: each sparse kernel against its plain version; returns each
    kernel's largest f32 error at the large_n shapes."""
    from repro_torch.core import sparse, topology
    from repro_torch.kernels import sparse_gossip as sg

    cases = [(spec, d) for spec in LARGE_N_TOPOLOGIES for d in LARGE_N_LEAF_D]
    cases += [("ring:n=1001", 513), ("ring:n=1001", 1), ("ws:n=1024,k=8,beta=0.1", 1),
              ("er:n=1024,p=0.02", 640), ("ws:n=1024,k=8,beta=1.0", 640), ("star:n=1024", 64)]
    errs = {"sparse_gossip_blocked": 0.0, "sparse_gossip": 0.0}
    layouts = {}
    for spec, d in cases:
        if spec not in layouts:
            layouts[spec] = sparse_layouts(spec, dev)
        kernels, csr = layouts[spec]
        n = csr.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            p = (torch.rand(n, d, generator=gen, device=dev) * 2 - 1).to(dtype)
            for name, (fn, ref, idx, val) in kernels.items():
                got = fn(idx, val, p)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != p.shape:
                    fail(f"{name} {spec} D={d}: got {got.dtype} {tuple(got.shape)}")
                err = float((got.float() - ref(idx, val, p).float()).abs().max())
                if not err <= TOL[dtype]:
                    fail(f"{name} {spec} D={d} {dtype}: max_abs_err {err} > {TOL[dtype]}")
                if spec in LARGE_N_TOPOLOGIES and dtype == torch.float32:
                    errs[name] = max(errs[name], err)
        phase("sparse", f"{spec:28s} D={d:6d}: both kernels within tolerance, f32 and bf16")
    # A period stack (@rewire: three periods with unequal tile counts): each
    # period's slice, extra all-zero tiles included, against the plain version.
    sched = topology.make_schedule("ws:n=1024,k=8,beta=0.3@rewire=1", seed=0)
    csrs = [sparse.csr_from_graph(sched.graph_at(r)) for r in range(3)]
    kbs = [sparse.block_ell_from_csr(c).max_blocks_per_row for c in csrs]
    idx_st, val_st = (torch.as_tensor(a, device=dev) for a in sparse.stack_block_ell(csrs))
    p = torch.rand(1024, 640, generator=gen, device=dev)
    for t in range(3):
        got = sg.gossip_mix_sparse_blocked(idx_st[t], val_st[t], p)
        err = float((got - sg.sparse_gossip_blocked_ref(idx_st[t], val_st[t], p)).abs().max())
        if not err <= TOL[torch.float32]:
            fail(f"stacked period {t}: max_abs_err {err}")
    phase("sparse", f"period stack of 3 (own KB {kbs}, stacked {idx_st.shape[2]}): "
                    "blocked kernel within 3e-5 on every period")
    return errs


def sparse_round_times(dev, gen, baseline=None) -> dict[str, dict]:
    """Phase 8: one large_n gossip round (4 leaves, f32) and its widest leaf
    per layout, each sparse kernel on the device alone and eagerly (in turns
    with the baseline library when one is given), beside the plain version,
    torch.sparse.mm, the bound and the source rows read a slab. The ws round
    on the device alone is the one the kernels line reports."""
    from repro_torch.core import sparse
    from repro_torch.kernels import sparse_gossip as sg

    out = {}
    d_total, d_wide = sum(LARGE_N_LEAF_D), max(LARGE_N_LEAF_D)
    round_dev = lambda fn: device_ms(fn, reps=5)  # noqa: E731
    for spec in LARGE_N_TOPOLOGIES:
        kernels, csr = sparse_layouts(spec, dev)
        n = csr.shape[0]
        leaves = [torch.rand(n, d, generator=gen, device=dev) * 2 - 1 for d in LARGE_N_LEAF_D]
        wide = leaves[LARGE_N_LEAF_D.index(d_wide)]
        w_csr = torch.as_tensor(sparse.csr_to_dense(csr)).to_sparse_csr().to(dev)
        lib_round = lambda: [torch.sparse.mm(w_csr, p) for p in leaves]  # noqa: E731
        t_lib, t_lib_e = round_dev(lib_round), time_ms(lib_round)
        t_lib_wide = device_ms(lambda: torch.sparse.mm(w_csr, wide))
        t_copy_wide = device_ms(lambda: wide.clone())  # the same bytes read and written
        t_ops = 2 * csr.nnz * d_total / F32_FLOP_PER_S * 1e3
        for name, (fn, ref, idx, val) in kernels.items():
            blocked = name == "sparse_gossip_blocked"
            kernel_round = lambda: [fn(idx, val, p) for p in leaves]  # noqa: E731
            dev_k, dev_base = in_turns(sg, baseline, kernel_round, round_dev)
            eager_k, eager_base = in_turns(sg, baseline, kernel_round, time_ms)
            wide_k, wide_base = in_turns(sg, baseline, lambda: fn(idx, val, wide), device_ms)
            t_k = sum(dev_k) / len(dev_k)
            t_p = time_ms(lambda: [ref(idx, val, p) for p in leaves], reps=5, warmup=1)
            # Each input read once (P, and the layout once a leaf), each output
            # written once; the multiply-adds this W needs: 2 per entry per column.
            layout_bytes = idx.numel() * idx.element_size() + val.numel() * val.element_size()
            t_bytes = (4 * 2 * n * d_total + len(LARGE_N_LEAF_D) * layout_bytes) / HBM_BYTES_PER_S * 1e3
            wide_bound = max((4 * 2 * n * d_wide + layout_bytes) / HBM_BYTES_PER_S * 1e3,
                             2 * csr.nnz * d_wide / F32_FLOP_PER_S * 1e3)
            times = {"ms": t_k, "plain_ms": t_p, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": t_lib}
            idx_h, val_h = idx.cpu(), val.cpu()
            rows_old = sg.staged_rows(idx_h, val_h, n, sg.BLOCK_ROWS if blocked else 1,
                                      blocked=blocked)
            rows_new = sg.staged_rows(idx_h, val_h, n, sg.WINDOW_ROWS, blocked=blocked)
            phase("stimes", f"{spec:28s} {name:22s} round on the device: kernel {spread(dev_k)} ms, "
                            f"torch.sparse.mm {t_lib:.4f} ms; eagerly: kernel {spread(eager_k)} ms, "
                            f"plain {t_p:.4f} ms, torch.sparse.mm {t_lib_e:.4f} ms; bound "
                            f"{times['bound_ms']:.4f} ms (bytes {t_bytes:.4f}, nnz={csr.nnz} ops "
                            f"{t_ops:.4f})")
            phase("stimes", f"{spec:28s} {name:22s} leaf ({n},{d_wide}) on the device: kernel "
                            f"{spread(wide_k)} ms, torch.sparse.mm {t_lib_wide:.4f} ms, a copy of "
                            f"the leaf (clone) {t_copy_wide:.4f} ms, bound {wide_bound:.4f} ms; "
                            f"source rows read a slab: {rows_new} in {sg.WINDOW_ROWS}-row windows, "
                            f"{rows_old} one "
                            f"{'8-row block' if blocked else 'destination row'} at a time "
                            f"(N = {n})")
            if dev_base:
                phase("stimes", f"{spec:28s} {name:22s} in turns (baseline, current, current, "
                                f"baseline): round on the device baseline {spread(dev_base)} ms, "
                                f"current {spread(dev_k)} ms; eagerly baseline "
                                f"{spread(eager_base)} ms, current {spread(eager_k)} ms; leaf "
                                f"({n},{d_wide}) baseline {spread(wide_base)} ms, current "
                                f"{spread(wide_k)} ms")
            if spec == LARGE_N_TOPOLOGIES[0]:
                out[name] = times
    return out


def large_n_trainer(spec, dev):
    """The runner's trainer for ``spec``, built the same way, with its test set."""
    from repro_torch.core import topology
    from repro_torch.data.loader import NodeLoader
    from repro_torch.data.synthetic import make_mnist_like
    from repro_torch.experiments import runner
    from repro_torch.train.trainer import DecentralizedTrainer

    ds = make_mnist_like(**spec.data)
    sched = topology.make_schedule(spec.topology, seed=spec.seed)
    parts = runner.build_partition(spec, sched.graph_at(0), ds.y_train)
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=spec.batch_size,
                        seed=spec.seed + 1, device=dev)
    tr = DecentralizedTrainer(
        sched, loader, lr=spec.lr, momentum=spec.momentum, mix_impl=spec.backend,
        sparse_p_chunk=spec.model.get("sparse_p_chunk"), compress=spec.model.get("compress"),
        faults=spec.faults, seed=spec.seed, in_dim=ds.x_train.shape[1],
        hidden=spec.model.get("hidden"), num_classes=ds.num_classes,
        class_groups=runner.default_class_groups(ds.num_classes), device=dev,
    )
    return tr, ds


def large_n_main_path(dev, kind: str) -> dict[str, int]:
    """Phase 9; returns each sparse kernel's launches on its path."""
    from repro_torch.core import sparse
    from repro_torch.experiments import presets, runner
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    specs = [dataclasses.replace(s, backend="sparse_pallas")
             for s in presets.get_preset("large_n")
             if s.partitioner == "hub_focused" and s.topology in LARGE_N_TOPOLOGIES]
    if len(specs) != 3:
        fail(f"large_n preset has {len(specs)} hub_focused N=1024 runs, want 3")
    launches = {"sparse_gossip_blocked": 0, "sparse_gossip": 0}
    acc_tol, cons_rtol = 3e-3, 1e-3
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(str(Path(tmp) / "large_n.jsonl"))
        for spec in specs:
            reset_launches()
            t0 = time.perf_counter()
            out = runner.run_spec(spec, store, raise_on_error=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(LAUNCHES)
            final = out["final"]
            records = store.curves(spec.run_id)
            want = len(LARGE_N_LEAF_D) * spec.rounds  # gossip_every = 1
            if got["sparse_gossip_blocked"] != want or final["fused"] is not True:
                fail(f"{spec.topology}: fused={final['fused']}, sparse_gossip_blocked launched "
                     f"{got['sparse_gossip_blocked']} times, want fused and {want}")
            if [r["round"] for r in records] != list(range(spec.rounds)):
                fail(f"{spec.topology}: records for rounds {[r['round'] for r in records]}")
            for r in records:
                for key in ("mean_acc", "min_acc", "g2_acc_spread", "consensus_mean"):
                    if not math.isfinite(r[key]):
                        fail(f"{spec.topology} round {r['round']}: {key} = {r[key]}")
            if final["device"] != kind or final["backend"] != "sparse_pallas":
                fail(f"run_end.final says {final['backend']} on {final['device']}")
            launches["sparse_gossip_blocked"] += got["sparse_gossip_blocked"]
            phase("large_n", f"{spec.run_id}: fused, {len(records)} records, final mean_acc "
                             f"{final['mean_acc']:.4f}, g2_acc_spread {final['g2_acc_spread']:.4f}, "
                             f"consensus_mean {final['consensus_mean']:.4g}; sparse_gossip_blocked "
                             f"launches {got['sparse_gossip_blocked']} = 4 x {spec.rounds}; "
                             f"{spec.rounds / wall:.3f} rounds/s ({wall:.2f} s, set-up included)")
            # Same spec, backend sparse: the records and every node agree.
            plain = dataclasses.replace(spec, backend="sparse")
            runner.run_spec(plain, store, raise_on_error=True)
            for a, b in zip(records, store.curves(plain.run_id)):
                for key in ("mean_acc", "min_acc", "max_acc", "g2_acc_spread"):
                    if abs(a[key] - b[key]) > acc_tol:
                        fail(f"{spec.topology} round {a['round']} {key}: {a[key]} vs {b[key]}")
                if abs(a["consensus_mean"] - b["consensus_mean"]) > cons_rtol * b["consensus_mean"]:
                    fail(f"{spec.topology} round {a['round']} consensus differs")
            last = {}
            for s in (spec, plain):
                tr, ds = large_n_trainer(s, dev)
                last[s.backend] = tr.run_fused(s.rounds, eval_every=s.rounds,
                                               x_test=ds.x_test, y_test=ds.y_test)[-1]
            acc_diff = float(np.abs(last["sparse_pallas"].per_node_acc
                                    - last["sparse"].per_node_acc).max())
            cons_diff = float(np.max(np.abs(last["sparse_pallas"].consensus - last["sparse"].consensus)
                                     / last["sparse"].consensus))
            phase("large_n", f"{spec.topology}: sparse_pallas vs sparse per node: accuracy max diff "
                             f"{acc_diff:.4f} (tol {acc_tol}), consensus max rel diff {cons_diff:.2e} "
                             f"(tol {cons_rtol})")
            if acc_diff > acc_tol or cons_diff > cons_rtol:
                fail(f"{spec.topology}: sparse_pallas and sparse disagree per node")

    # sparse: the per-round loop and the captured fused run, to the bit.
    plain = dataclasses.replace(specs[0], backend="sparse")
    runs = {}
    for path in ("run", "run_fused"):
        tr, ds = large_n_trainer(plain, dev)
        getattr(tr, path)(plain.rounds, eval_every=plain.rounds, x_test=ds.x_test, y_test=ds.y_test)
        runs[path] = tree_leaves(tr.params) + tree_leaves(tr.momentum)
    same = all(torch.equal(a, b) for a, b in zip(runs["run"], runs["run_fused"]))
    phase("large_n", f"{plain.topology} sparse: loop and fused bit-identical: {same}")
    if not same:
        fail("sparse loop and fused runs differ")

    # dense at N=100 (the paper's run, full width): loop and fused within 1e-6.
    from repro_torch.experiments.spec import ExperimentSpec

    main = ExperimentSpec(**MAIN_SPEC, backend="dense")
    runs = {}
    for path in ("run", "run_fused"):
        tr, ds = large_n_trainer(main, dev)
        getattr(tr, path)(main.rounds, eval_every=main.rounds, x_test=ds.x_test, y_test=ds.y_test)
        runs[path] = tree_leaves(tr.params)
    diff = max(float((a - b).abs().max()) for a, b in zip(runs["run"], runs["run_fused"]))
    phase("large_n", f"{main.topology} dense, {main.rounds} rounds: loop vs fused max abs diff "
                     f"{diff:.3e} (tol 1e-6)")
    if not diff <= 1e-6:
        fail(f"dense loop and fused runs differ by {diff}")

    # The row gather kernel: one gossip round of each layout through
    # mix_sparse_pallas(blocked=False), against mix_sparse.
    gen = torch.Generator(device=dev).manual_seed(7)
    for spec in LARGE_N_TOPOLOGIES:
        _, csr = sparse_layouts(spec, dev)
        n = csr.shape[0]
        params = {"layers": [
            {"b": torch.rand(n, b, generator=gen, device=dev),
             "w": torch.rand(n, a, b, generator=gen, device=dev)}
            for a, b in zip(LARGE_N_DIMS[:-1], LARGE_N_DIMS[1:])
        ]}
        want = sparse.mix_sparse(csr, params)
        reset_launches()
        got = sparse.mix_sparse_pallas(csr, params, blocked=False)
        torch.cuda.synchronize()
        launches["sparse_gossip"] += LAUNCHES["sparse_gossip"]
        if LAUNCHES["sparse_gossip"] != len(LARGE_N_LEAF_D):
            fail(f"{spec}: sparse_gossip launched {LAUNCHES['sparse_gossip']} times, want 4")
        err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        phase("large_n", f"{spec}: mix_sparse_pallas(blocked=False) vs mix_sparse max abs err "
                         f"{err:.3e} (tol 3e-5), sparse_gossip launches 4")
        if not err <= TOL[torch.float32]:
            fail(f"{spec}: row gather kernel round differs from mix_sparse by {err}")
    return launches


def sharded_main_path(dev, kind: str, smi: str) -> None:
    """Phase 9b: the node-sharded backends, and the large_n preset's N=4096
    sparse_sharded run at full size. Plain PyTorch: no kernel launches."""
    from repro_torch.core import decavg, mesh, mixing, sparse, topology
    from repro_torch.experiments import presets, runner
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    reset_launches()
    gen = torch.Generator(device=dev).manual_seed(9)
    card = torch.device("cuda", torch.cuda.current_device())
    (big,) = [s for s in presets.get_preset("large_n") if s.backend == "sparse_sharded"]
    n = topology.make(big.topology, seed=big.seed).num_nodes
    params = mlp_tree(n, LARGE_N_DIMS, gen, dev)
    p_total = sum(LARGE_N_LEAF_D)

    def engine(backend, shards=None, halo="auto"):
        m = None if shards is None else mesh.Mesh([card] * shards, ("data",))
        return decavg.GossipEngine(big.topology, backend=backend, mesh=m, halo_schedule=halo,
                                   seed=big.seed, device=dev)

    # 1. One mix at N=4096 on each mesh and halo schedule: sparse's bits.
    sparse_eng = engine("sparse")
    want = sparse_eng.mix(params)
    engines = {"S=1 (local_mesh)": engine("sparse_sharded")}
    for halo in ("allgather", "ring"):
        engines[f"S=8 {halo}"] = engine("sparse_sharded", 8, halo)
    if engines["S=1 (local_mesh)"].mesh.shape != {"data": torch.cuda.device_count()}:
        fail(f"default mesh {engines['S=1 (local_mesh)'].mesh} is not one shard per card")
    for name, eng in engines.items():
        got = eng.mix(params)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        phase("sharded", f"{big.topology} sparse_sharded {name}: one mix (4 leaves, f32) "
                         f"identical to sparse: {same}")
        if not same:
            fail(f"sparse_sharded {name} differs from sparse by {max_diff(got, want)}")
        del got
    # sharded at the paper's N=100 and permute on a 16-shard ring, against dense.
    for spec, backend, shards, scheds in (
        (MAIN_SPEC["topology"], "sharded", 4, ("allgather", "reduce_scatter")),
        ("ring:n=16", "permute", 16, (None,)),
    ):
        small = mlp_tree(topology.make(spec).num_nodes, LARGE_N_DIMS, gen, dev)
        dense = decavg.GossipEngine(spec, backend="dense", device=dev).mix(small)
        for sched in scheds:
            eng = decavg.GossipEngine(spec, backend=backend, device=dev,
                                      mesh=mesh.Mesh([card] * shards, ("data",)),
                                      sharded_schedule=sched or "reduce_scatter")
            err = max_diff(eng.mix(small), dense)
            phase("sharded", f"{spec} {backend} {sched or ''} on {shards} shards: max abs diff "
                             f"from dense {err:.3e} (tol 1e-5)")
            if not err <= 1e-5:
                fail(f"{backend} {sched} differs from dense by {err}")
    colors = len(mixing.edge_coloring(topology.make("ring:n=16")))
    phase("sharded", f"ring:n=16 permute: {colors} colors, one ppermute each")

    # 2. One N=4096 gossip round on the device alone (CUDA-graph replay),
    # for sparse and each mesh; the halo's modeled wire a shard beside it.
    def round_ms(eng) -> float:
        return device_ms(lambda: eng.mix(params), reps=2, rounds=3)

    bound = 2 * n * p_total * 4 / HBM_BYTES_PER_S * 1e3
    phase("sharded", f"one {big.topology} round (4 leaves, {n * p_total} f32 values) on the "
                     f"device: sparse {round_ms(sparse_eng):.4f} ms, sparse_sharded S=1 "
                     f"(local_mesh) {round_ms(engines['S=1 (local_mesh)']):.4f} ms; bytes bound "
                     f"(P read and written once) {bound:.4f} ms; {smi}")
    for shards in (2, 4, 8, 16):
        got = {halo: round_ms(engines.get(f"S={shards} {halo}") or engine(
            "sparse_sharded", shards, halo)) for halo in ("allgather", "ring")}
        wire = sparse.halo_wire_bytes(engine("sparse_sharded", shards).sharded_csr(), p_total)
        phase("sharded", f"S={shards}: allgather {got['allgather']:.4f} ms, ring "
                         f"{got['ring']:.4f} ms; halo wire a shard {wire['allgather'] / 2**20:.2f} "
                         f"MiB allgather, {wire['ring'] / 2**20:.2f} MiB ring")
    del engines, sparse_eng, want, params
    gc.collect()
    torch.cuda.empty_cache()

    # 3. The N=4096 run exactly as the preset writes it, then on sparse.
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(str(Path(tmp) / "large_n_4096.jsonl"))
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        t0 = time.perf_counter()
        out = runner.run_spec(big, store, raise_on_error=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        final, records = out["final"], store.curves(big.run_id)
        if final["fused"] is not True or final["backend"] != "sparse_sharded":
            fail(f"{big.run_id}: fused={final['fused']} backend={final['backend']}")
        if final["device"] != kind or [r["round"] for r in records] != list(range(big.rounds)):
            fail(f"{big.run_id}: device {final['device']}, rounds {[r['round'] for r in records]}")
        for r in records:
            for key in ("mean_acc", "min_acc", "g2_acc_spread", "consensus_mean"):
                if r[key] is None or not math.isfinite(r[key]):
                    fail(f"{big.run_id} round {r['round']}: {key} = {r[key]}")
        phase("sharded", f"{big.run_id} ({big.topology}, {big.rounds} rounds, train_per_class "
                         f"{big.data['train_per_class']}, sparse_p_chunk "
                         f"{big.model['sparse_p_chunk']}): fused sparse_sharded, final mean_acc "
                         f"{final['mean_acc']:.4f}, g2_acc_spread {final['g2_acc_spread']:.4f}, "
                         f"consensus_mean {final['consensus_mean']:.4g}; {big.rounds / wall:.3f} "
                         f"rounds/s ({wall:.2f} s, data and set-up included); the run's own peak "
                         f"device memory {peak:.3f} GiB (above the {held / 2**30:.3f} GiB "
                         f"already held when it started); {smi}")
        plain = dataclasses.replace(big, backend="sparse")
        t0 = time.perf_counter()
        runner.run_spec(plain, store, raise_on_error=True)
        wall_plain = time.perf_counter() - t0
        for a, b in zip(records, store.curves(plain.run_id)):
            keys = set(a) - {"wall_s", "run_id"}
            if any(a[k] != b[k] for k in keys):
                fail(f"round {a['round']}: sparse_sharded {a} vs sparse {b}")
        phase("sharded", f"same spec on sparse: records identical; {plain.rounds / wall_plain:.3f} "
                         f"rounds/s ({wall_plain:.2f} s)")
    last = {}
    for s in (big, plain):
        tr, ds = large_n_trainer(s, dev)
        tr.run_fused(s.rounds)
        last[s.backend] = tree_leaves(tr.params) + tree_leaves(tr.momentum)
        del tr, ds
    same = all(torch.equal(a, b) for a, b in zip(last["sparse_sharded"], last["sparse"]))
    diff = max(float((a - b).abs().max()) for a, b in zip(last["sparse_sharded"], last["sparse"]))
    phase("sharded", f"{big.topology} trainer run_fused: sparse_sharded and sparse params and "
                     f"momentum identical: {same} (max abs diff {diff:.3e})")
    if not same:
        fail(f"sparse_sharded and sparse runs differ by {diff}")
    del last
    gc.collect()
    torch.cuda.empty_cache()

    # 4. The large_n_smoke preset through run_sweep.
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "large_n_smoke.jsonl")
        specs = presets.get_preset("large_n_smoke")
        summary = runner.run_sweep(specs, path)
        finals = ResultsStore(path).finals()
        if summary["failed"] or len(finals) != len(specs):
            fail(f"large_n_smoke: {summary}")
        for s in specs:
            f = finals[s.run_id]["final"]
            if f["fused"] is not True or f["backend"] != s.backend:
                fail(f"large_n_smoke {s.run_id}: fused={f['fused']} backend={f['backend']}")
        phase("sharded", f"large_n_smoke: {len(specs)} runs completed, all fused ("
                         + ", ".join(f"{s.backend}: mean_acc {finals[s.run_id]['final']['mean_acc']:.4f}"
                                     for s in specs) + ")")
    if any(LAUNCHES.values()):
        fail(f"the sharded phase launched a hand-written kernel: {dict(LAUNCHES)}")


def max_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def mlp_tree(n: int, dims, gen, dev) -> dict:
    """A node-stacked MLP parameter tree with values in [-1, 1)."""
    return {"layers": [
        {"b": torch.rand(n, b, generator=gen, device=dev) * 2 - 1,
         "w": torch.rand(n, a, b, generator=gen, device=dev) * 2 - 1}
        for a, b in zip(dims[:-1], dims[1:])
    ]}


def faults_main_path(dev, kind: str) -> None:
    """Phase 14: the paper's run under faults, loop and fused, dense and sparse."""
    from repro_torch.core import decavg, faults, sparse, topology
    from repro_torch.experiments import analysis, presets, runner
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.tree import tree_leaves, tree_map

    churn = faults.parse_faults(FAULT_SPEC)[0].params
    start = int(churn["start"])
    n = topology.make_schedule(MAIN_SPEC["topology"], seed=0).num_nodes
    n_dead = math.ceil(float(churn["frac"]) * n)  # the hub pool, all killed (p_leave=1)
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(str(Path(tmp) / "faults.jsonl"))
        for backend in ("dense", "sparse"):
            for fused in (False, True):
                spec = ExperimentSpec(**MAIN_SPEC, backend=backend, faults=FAULT_SPEC,
                                      model={} if fused else {"fused": False})
                t0 = time.perf_counter()
                final = runner.run_spec(spec, store, raise_on_error=True)["final"]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                records = store.curves(spec.run_id)
                for r in records:
                    for key in ("mean_acc", "g2_acc_spread", "consensus_mean"):
                        if not math.isfinite(r[key]):
                            fail(f"faults {backend}: round {r['round']} {key} = {r[key]}")
                alive = [r.get("alive_count") for r in records]
                if None in alive or final["alive_min"] != n - n_dead or final["fused"] is not fused:
                    fail(f"faults {backend} fused={fused}: alive_count {alive}, final "
                         f"alive_min {final.get('alive_min')}, fused {final['fused']}")
                if final["device"] != kind or final["churn_rounds"] != [start]:
                    fail(f"faults {backend}: device {final['device']}, churn_rounds "
                         f"{final['churn_rounds']}")
                phase("faults", f"{spec.run_id} {backend} {'fused' if fused else 'loop'}: "
                                f"alive_count {alive}, alive_min {final['alive_min']}, "
                                f"churn_rounds {final['churn_rounds']}, recovery_rounds "
                                f"{final['recovery_rounds']}, final mean_acc "
                                f"{final['mean_acc']:.4f}, g2_acc_spread "
                                f"{final['g2_acc_spread']:.4f}; {spec.rounds / wall:.3f} rounds/s "
                                f"({wall:.2f} s, set-up included)")

    # The same runs through the trainer: params and momentum compared.
    states, dead_rows = {}, 0
    for backend in ("dense", "sparse"):
        for path in ("run", "run_fused"):
            spec = ExperimentSpec(**MAIN_SPEC, backend=backend, faults=FAULT_SPEC)
            tr, ds = large_n_trainer(spec, dev)
            before = {}

            def snap(m, tr=tr, before=before):
                if m.round == start - 1:  # the state the dead nodes must keep
                    before["p"] = tree_map(torch.clone, tr.params)
                    before["m"] = tree_map(torch.clone, tr.momentum)

            getattr(tr, path)(spec.rounds, eval_every=1, x_test=ds.x_test, y_test=ds.y_test,
                              on_round=snap)
            torch.cuda.synchronize()
            dead = torch.as_tensor(~tr.engine.fault_trace.alive(spec.rounds - 1), device=dev)
            dead_rows = int(dead.sum())
            frozen = all(torch.equal(a[dead], b[dead]) for a, b in zip(
                tree_leaves(before["p"]) + tree_leaves(before["m"]),
                tree_leaves(tr.params) + tree_leaves(tr.momentum)))
            if dead_rows != n_dead or not frozen:
                fail(f"faults {backend} {path}: {dead_rows} dead nodes, frozen {frozen}")
            states[backend, path] = (tr.params, tr.momentum)
    diffs = {b: max(max_diff(states[b, "run"][0], states[b, "run_fused"][0]),
                    max_diff(states[b, "run"][1], states[b, "run_fused"][1]))
             for b in ("dense", "sparse")}
    across = max_diff(states["dense", "run_fused"][0], states["sparse", "run_fused"][0])
    phase("faults", f"loop vs fused max abs diff: dense {diffs['dense']:.3e}, sparse "
                    f"{diffs['sparse']:.3e} (tol 1e-6); dense vs sparse {across:.3e} (tol 1e-5); "
                    f"the {dead_rows} dead nodes' params and momentum bit-unchanged from round "
                    f"{start - 1} in all four runs")
    if max(diffs.values()) > 1e-6 or across > 1e-5:
        fail("faulted runs disagree")

    # The churn_smoke preset (recorded, not asserted: the port's RNG differs).
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "churn.jsonl")
        t0 = time.perf_counter()
        summary = runner.run_sweep(presets.get_preset("churn_smoke"), path)
        wall = time.perf_counter() - t0
        if summary["failed"] or summary["ran"] != 4:
            fail(f"churn_smoke runs failed: {summary}")
        checks = analysis.qualitative_checks(analysis.summarize(ResultsStore(path)))
        phase("faults", f"churn_smoke preset ({summary['ran']} runs, {wall:.2f} s): " + json.dumps(
            {k: checks.get(k) for k in ("hub_kill_hurts_more", "hub_kill_auc_g2_spread",
                                        "leaf_kill_auc_g2_spread")}))

    # One gossip round at N=100 on the device alone: faulted against plain.
    spec = ExperimentSpec(**MAIN_SPEC, backend="dense", faults=FAULT_SPEC)
    tr, _ = large_n_trainer(spec, dev)
    prog = tr.engine.program(spec.rounds)
    gen = torch.Generator(device=dev).manual_seed(14)
    params = mlp_tree(tr.num_nodes, MLP_DIMS, gen, dev)
    hist = faults.init_history(params, prog.delay_max + 1)
    r_t = torch.tensor(start, device=dev)
    faulted = lambda: prog.apply_period(  # noqa: E731
        params, 0, r=r_t, pub=faults.publish(hist, r_t, prog.f_delay))
    plain = lambda: decavg.mix_dense(prog.w[0], params)  # noqa: E731
    p_in = tree_map(torch.clone, params)

    def bookkeeping():  # the faulted round's other work: snapshot, freeze, ring push
        for a, b in zip(tree_leaves(p_in), tree_leaves(params)):
            a.copy_(b)
        frozen = faults.where_alive(prog.alive_at(r_t), params, p_in)
        faults.push(frozen, hist, r_t)

    t_f, t_p, t_b = device_ms(faulted, reps=5), device_ms(plain, reps=5), device_ms(bookkeeping, reps=5)
    phase("faults", f"one N={tr.num_nodes} gossip round (8 leaves, f32) on the device: faulted "
                    f"(renormalized, stale publishes, dead rows passed) {t_f:.4f} ms, plain "
                    f"torch.matmul mix {t_p:.4f} ms; the faulted round's params bookkeeping "
                    f"(snapshot, where_alive, ring push) {t_b:.4f} ms")
    del tr, prog, params, hist, p_in

    # The faulted sparse round at BA N=4096 (K = 117 slots, the hubs' rows):
    # its renormalization sums each row slot by slot, K+1 launches, where a
    # single row reduction would pick its summation order by shape.
    eng = decavg.GossipEngine("ba:n=4096,m=2", backend="sparse", faults=FAULT_SPEC, device=dev)
    sp = eng.program(start + 1)
    val, keep = sp.ell_val[0], sp.f_keep[start]
    params = mlp_tree(eng.num_nodes, LARGE_N_DIMS, gen, dev)
    r_t = torch.tensor(start, device=dev)

    def one_reduction():
        vk = val * keep
        rowsum = vk.sum(dim=1)
        ok = rowsum > 0
        return vk * (torch.where(ok, 1.0, 0.0) / torch.where(ok, rowsum, 1.0))[:, None], ok

    t_slots = device_ms(lambda: faults.renorm_ell(val, keep), reps=5)
    t_one = device_ms(one_reduction, reps=5)
    t_f = device_ms(lambda: sp.apply_period(params, 0, r=r_t), reps=2)
    t_p = device_ms(lambda: sparse.mix_ell(sp.ell_idx[0], val, params), reps=2)
    phase("faults", f"one BA N=4096 sparse gossip round (K={val.shape[1]}, 4 leaves, f32) on "
                    f"the device: faulted {t_f:.4f} ms, plain {t_p:.4f} ms; its renormalization "
                    f"summed slot by slot {t_slots:.4f} ms, as one row reduction {t_one:.4f} ms")
    del eng, sp, params


def compress_main_path(dev, kind: str) -> dict[str, int]:
    """Phase 15; returns each kernel's launches on the CHOCO paths."""
    from repro_torch.core import decavg
    from repro_torch.experiments import presets, runner
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    launches = {"gossip_mix": 0, "sparse_gossip_blocked": 0}
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(str(Path(tmp) / "choco.jsonl"))
        spec = ExperimentSpec(**MAIN_SPEC, backend="pallas", model={"compress": CHOCO_K})
        reset_launches()
        t0 = time.perf_counter()
        final = runner.run_spec(spec, store, raise_on_error=True)["final"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["gossip_mix"] = LAUNCHES["gossip_mix"]
        want = len(LEAF_D) * spec.rounds
        records = store.curves(spec.run_id)
        finite = all(math.isfinite(r[k]) for r in records
                     for k in ("mean_acc", "g2_acc_spread", "consensus_mean"))
        if launches["gossip_mix"] != want or not finite or final["fused"]:
            fail(f"CHOCO pallas: gossip_mix launched {launches['gossip_mix']} times (want "
                 f"{want}), records finite {finite}, fused {final['fused']}")
        phase("compress", f"{spec.run_id} pallas compress={CHOCO_K}: {len(records)} records, "
                          f"final mean_acc {final['mean_acc']:.4f}, g2_acc_spread "
                          f"{final['g2_acc_spread']:.4f}, consensus_mean "
                          f"{final['consensus_mean']:.4g}; gossip_mix launches "
                          f"{launches['gossip_mix']} = 8 x {spec.rounds}; "
                          f"{spec.rounds / wall:.3f} rounds/s ({wall:.2f} s, set-up included)")

    # compress=1.0 sends every delta: CHOCO is DecAvg.
    runs = {}
    for k in (None, 1.0):
        s = ExperimentSpec(**MAIN_SPEC, backend="pallas",
                           model={} if k is None else {"compress": k})
        tr, _ = large_n_trainer(s, dev)
        tr.run(s.rounds)
        runs[k] = tree_leaves(tr.params)
    ok = all(torch.allclose(b, a, rtol=1e-5, atol=1e-6) for a, b in zip(runs[None], runs[1.0]))
    diff = max(float((a - b).abs().max()) for a, b in zip(runs[None], runs[1.0]))
    phase("compress", f"pallas compress=1.0 vs uncompressed after {MAIN_SPEC['rounds']} rounds: "
                      f"max abs diff {diff:.3e}, within rtol 1e-5 + atol 1e-6: {ok}")
    if not ok:
        fail("compress=1.0 differs from plain DecAvg")

    # The large_n ws run, CHOCO on sparse_pallas (fused) against sparse.
    ws = next(s for s in presets.get_preset("large_n")
              if s.partitioner == "hub_focused" and s.topology == LARGE_N_TOPOLOGIES[0])
    choco = dataclasses.replace(ws, backend="sparse_pallas",
                                model={**ws.model, "compress": CHOCO_K})
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(str(Path(tmp) / "choco_n.jsonl"))
        reset_launches()
        t0 = time.perf_counter()
        final = runner.run_spec(choco, store, raise_on_error=True)["final"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["sparse_gossip_blocked"] = LAUNCHES["sparse_gossip_blocked"]
        want = len(LARGE_N_LEAF_D) * choco.rounds
        if launches["sparse_gossip_blocked"] != want or final["fused"] is not True:
            fail(f"CHOCO sparse_pallas: fused {final['fused']}, sparse_gossip_blocked launched "
                 f"{launches['sparse_gossip_blocked']} times, want {want}")
        phase("compress", f"{choco.run_id} sparse_pallas compress={CHOCO_K}: fused, final "
                          f"mean_acc {final['mean_acc']:.4f}, consensus_mean "
                          f"{final['consensus_mean']:.4g}; sparse_gossip_blocked launches "
                          f"{launches['sparse_gossip_blocked']} = 4 x {choco.rounds}; "
                          f"{choco.rounds / wall:.3f} rounds/s ({wall:.2f} s, set-up included)")
    last, trainers = {}, {}
    for backend in ("sparse_pallas", "sparse"):
        s = dataclasses.replace(choco, backend=backend)
        tr, ds = large_n_trainer(s, dev)
        last[backend] = tr.run_fused(s.rounds, eval_every=s.rounds,
                                     x_test=ds.x_test, y_test=ds.y_test)[-1]
        trainers[backend] = tr
    acc_tol, cons_rtol = 3e-3, 1e-3
    acc_diff = float(np.abs(last["sparse_pallas"].per_node_acc - last["sparse"].per_node_acc).max())
    cons_diff = float(np.max(np.abs(last["sparse_pallas"].consensus - last["sparse"].consensus)
                             / last["sparse"].consensus))
    phase("compress", f"{choco.topology} CHOCO sparse_pallas vs sparse per node: accuracy max "
                      f"diff {acc_diff:.4f} (tol {acc_tol}), consensus max rel diff "
                      f"{cons_diff:.2e} (tol {cons_rtol})")
    if acc_diff > acc_tol or cons_diff > cons_rtol:
        fail("CHOCO sparse_pallas and sparse disagree per node")

    # One CHOCO round (top-k of every leaf, the mix of the references, the
    # residual update) on the device alone, at both sizes.
    gen = torch.Generator(device=dev).manual_seed(15)
    s100 = ExperimentSpec(**MAIN_SPEC, backend="pallas", model={"compress": CHOCO_K})
    tr100, _ = large_n_trainer(s100, dev)
    p100 = tr100.params
    w = tr100.engine.w
    t100 = device_ms(lambda: tr100._gossip(lambda q: decavg.mix_pallas(w, q), p100), reps=5)
    t100_plain = device_ms(lambda: decavg.mix_pallas(w, p100), reps=5)
    tr_n = trainers["sparse_pallas"]
    prog = tr_n.engine.program(1)
    pn = mlp_tree(tr_n.num_nodes, LARGE_N_DIMS, gen, dev)
    tn = device_ms(lambda: tr_n._gossip(lambda q: prog.apply_period(q, 0), pn), reps=5)
    tn_plain = device_ms(lambda: prog.apply_period(pn, 0), reps=5)
    phase("compress", f"one CHOCO round (k={CHOCO_K}: top-k, mix of the references, residual) "
                      f"on the device: N={tr100.num_nodes} on gossip_mix {t100:.4f} ms (its mix alone "
                      f"{t100_plain:.4f} ms); N={tr_n.num_nodes} ws on the blocked kernel {tn:.4f} ms (its mix "
                      f"alone {tn_plain:.4f} ms)")
    return launches


def flash_kernel_checks(dev, gen) -> float:
    """Phase 10: the kernel against its plain version at every case, f32 and
    bf16; returns the largest bf16 error at the engine's shapes (serving runs
    in bf16)."""
    from repro_torch.kernels import flash_attention as fa

    engine_err = 0.0
    for case in FLASH_CASES:
        b, s, h, hkv, hd, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, s, hkv, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, s, hkv, hd, generator=gen, device=dev).to(dtype)
            got = fa.flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"flash {case} {dtype}: got {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - fa.flash_attention_ref(q, k, v, window=window).float())
                        .abs().max())
            if not err <= FLASH_TOL[dtype]:
                fail(f"flash {case} {dtype}: max_abs_err {err} > {FLASH_TOL[dtype]}")
            if case in FLASH_ENGINE_CASES and dtype == torch.bfloat16:
                engine_err = max(engine_err, err)
            phase("flash", f"(B,S,H,Hkv,hd,window)={case} {str(dtype):14s} max_abs_err {err:.3e} "
                           f"(tol {FLASH_TOL[dtype]:g})")
        del q, k, v, got
    torch.cuda.empty_cache()
    return engine_err


def flash_attention_times(dev, gen, baseline=None) -> dict:
    """Phase 11: one causal prefill attention at the engine's largest
    admission, (1, 1024, 32, 8, 64) bf16, eagerly and on the device alone;
    then the kernel against scaled_dot_product_attention at the engine's
    other admission buckets; then the host's time to launch one call."""
    from repro_torch.kernels import flash_attention as fa

    def inputs(s, h=32, hkv=8, hd=64):
        q = torch.randn(1, s, h, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(1, s, hkv, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(1, s, hkv, hd, generator=gen, device=dev).bfloat16()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, S, hd) views
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        return q, k, v, sdpa

    b, s, h, hkv, hd = 1, 1024, 32, 8, 64
    q, k, v, sdpa = inputs(s)
    kernel = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    plain = lambda: fa.flash_attention_ref(q, k, v)  # noqa: E731
    eager_k, eager_base = in_turns(fa, baseline, kernel, time_ms)
    dev_k, dev_base = in_turns(fa, baseline, kernel, device_ms)
    t_k = sum(dev_k) / len(dev_k)
    t_p, t_p_e = device_ms(plain, reps=5), time_ms(plain)
    t_lib, t_lib_e = device_ms(sdpa), time_ms(sdpa)
    # Each input read once, the output written once; the causal pairs this
    # run attends (S(S+1)/2 a head), 2 FLOP per multiply-add in QK^T and PV.
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * hd * b * h * s * (s + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    times = {"ms": t_k, "plain_ms": t_p, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": t_lib}
    phase("ftimes", f"(1,1024,32,8,64) bf16 causal on the device: kernel {spread(dev_k)} ms, plain "
                    f"{t_p:.4f} ms, scaled_dot_product_attention {t_lib:.4f} ms; eagerly: kernel "
                    f"{spread(eager_k)} ms, plain {t_p_e:.4f} ms, scaled_dot_product_attention "
                    f"{t_lib_e:.4f} ms; bound {times['bound_ms']:.4f} ms (bytes {t_bytes:.4f} ms, "
                    f"{flops / 1e9:.3f} GFLOP {t_ops:.4f} ms)")
    if dev_base:
        phase("ftimes", f"(1,1024,32,8,64) in turns (baseline, current, current, baseline): on "
                        f"the device baseline {spread(dev_base)} ms, current {spread(dev_k)} ms; "
                        f"eagerly baseline {spread(eager_base)} ms, current {spread(eager_k)} ms")
    for s_bucket in (128, 256, 512):
        q, k, v, sdpa = inputs(s_bucket)
        kernel = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        dev_b, dev_b_base = in_turns(fa, baseline, kernel, device_ms)
        bound = 4 * hd * h * s_bucket * (s_bucket + 1) // 2 / BF16_FLOP_PER_S * 1e3
        phase("ftimes", f"(1,{s_bucket},32,8,64) bf16 causal on the device: kernel {spread(dev_b)} "
                        f"ms, scaled_dot_product_attention {device_ms(sdpa):.4f} ms; eagerly: kernel "
                        f"{time_ms(kernel):.4f} ms, scaled_dot_product_attention "
                        f"{time_ms(sdpa):.4f} ms; bound {bound:.4f} ms (operations)"
                        + (f"; baseline on the device {spread(dev_b_base)} ms" if dev_b_base else ""))
    # dbrx's prefill of one 1024-token admission: hd 128, GQA group 6.
    qd, kd, vd, sdpa_d = inputs(1024, 48, 8, 128)
    t_dk = device_ms(lambda: fa.flash_attention(qd, kd, vd))
    t_dp = device_ms(lambda: fa.flash_attention_ref(qd, kd, vd), reps=5)
    t_dl = device_ms(sdpa_d)
    nbytes = 2 * (2 * qd.numel() + kd.numel() + vd.numel())
    flops = 4 * 128 * 48 * 1024 * 1025 // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    phase("ftimes", f"(1,1024,48,8,128) bf16 causal (dbrx) on the device: kernel {t_dk:.4f} ms, "
                    f"plain {t_dp:.4f} ms, scaled_dot_product_attention {t_dl:.4f} ms; bound "
                    f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}: "
                    f"bytes {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP {t_ops:.4f} ms)")
    del qd, kd, vd, sdpa_d
    # The host's share: the wrapper's checks, the output's allocation and the
    # ctypes launch, timed on the host clock over calls that only enqueue.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fa.flash_attention(q, k, v)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    phase("ftimes", f"host time to launch one flash_attention call (1,512,32,8,64): {host_us:.1f} us")
    return times


def serve_requests(params, cfg, prompts, dev, **engine_kw) -> tuple[dict, list[float], dict]:
    """All prompts submitted at once to a fresh Engine(slots=4,
    cache_len=1024), drained step by step. Returns the tokens by request,
    the times to first token (s), and decode counts and time over the steps
    that admitted nothing."""
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, slots=4, cache_len=1024, device=dev, **engine_kw)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    ttft: dict[int, float] = {}
    decode = {"tokens": 0, "s": 0.0}
    while True:
        t_step = time.perf_counter()
        events = eng.step()  # ends in a host copy of the tokens: synchronized
        now = time.perf_counter()
        if not events:
            break
        if all(e["rid"] in ttft for e in events):  # no admission in this step
            decode["tokens"] += len(events)
            decode["s"] += now - t_step
        for e in events:
            ttft.setdefault(e["rid"], now - t0)
    out = eng.run()
    return out, [ttft[r] for r in rids], decode


def serve_main_path(dev) -> int:
    """Phase 12; returns the flash kernel's launches in the bf16 engine run."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as TF
    from repro_torch.serve import decode as SD
    from repro_torch.serve.engine import _bucket
    from repro_torch.tree import tree_map

    cfg = cfgbase.get("llama3.2-1b")
    t0 = time.perf_counter()
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = TF.param_count(params)
    phase("serve", f"{cfg.arch_id}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                   f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
                   f"vocab {cfg.vocab_size}: {n_params} {cfg.param_dtype} parameters "
                   f"({n_params * 2 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in SERVE_LENS]

    # A cold run first: the first call of each kernel and matmul shape pays
    # the module load and cuBLAS's set-up. The counts and the numbers are
    # those of the second, warm run.
    cold_toks, cold_ttft, _ = serve_requests(params, cfg, prompts, dev)
    phase("serve", "cold run (first calls included): time to first token "
                   + ", ".join(f"{t * 1e3:.1f}" for t in cold_ttft) + " ms")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, ttft, decode = serve_requests(params, cfg, prompts, dev)
    launches = LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if any(not np.array_equal(toks[r], cold_toks[r]) for r in toks):
        fail("the warm run's tokens differ from the cold run's")
    want = cfg.num_layers * len(prompts)
    phase("serve", f"Engine(slots=4, cache_len=1024), {len(prompts)} requests x {SERVE_MAX_NEW} "
                   f"new tokens, bf16, flash auto: flash_attention launches {launches} "
                   f"(want {cfg.num_layers} layers x {len(prompts)} admissions = {want})")
    if launches != want:
        fail(f"flash_attention launched {launches} times on the serving path, want {want}")
    for n, t in zip(SERVE_LENS, ttft):
        phase("serve", f"prompt {n:4d} tokens (bucket {min(_bucket(n), 1024):4d}): "
                       f"time to first token {t * 1e3:.2f} ms")
    phase("serve", f"decode: {decode['tokens']} tokens in {decode['s'] * 1e3:.2f} ms over the "
                   f"steps that admitted nothing = {decode['tokens'] / decode['s']:.1f} tokens/s")
    phase("serve", f"device memory: {base / 2**30:.3f} GiB allocated before the run (weights "
                   f"{n_params * 2 / 2**30:.3f} GiB, the rest held by earlier phases), peak "
                   f"{peak / 2**30:.3f} GiB, so the run itself peaked at "
                   f"{(peak - base) / 2**30:.3f} GiB above its start")
    for rid, p in enumerate(prompts):
        if toks[rid].shape != (SERVE_MAX_NEW,) or not (0 <= toks[rid]).all() \
                or not (toks[rid] < cfg.vocab_size).all():
            fail(f"request {rid}: tokens {toks[rid]}")

    profile_serving(params, cfg, prompts, dev)

    # Each request's prefill, as the engine admits it, through the kernel
    # and through the plain path.
    worst = 0.0
    for n, p in zip(SERVE_LENS, prompts):
        padded = torch.zeros((1, min(_bucket(n), 1024)), dtype=torch.int32, device=dev)
        padded[0, :n] = torch.from_numpy(p).to(dev)
        length = torch.tensor([n], dtype=torch.int32, device=dev)
        logits = {}
        for flash in (True, False):
            row = TF.init_cache(cfg, 1, 1024, per_slot=True, device=dev)
            logits[flash], _ = SD.prefill(params, cfg, padded, row, length=length, flash=flash)
        err = float((logits[True] - logits[False]).abs().max())
        worst = max(worst, err)
        phase("serve", f"prompt {n:4d}: prefill logits kernel vs plain max_abs_err {err:.3e} "
                       f"(|logit| max {float(logits[False].abs().max()):.3f}, tol "
                       f"{SERVE_LOGIT_TOL}); same first token: "
                       f"{int(logits[True].argmax()) == int(logits[False].argmax())}")
    if not worst <= SERVE_LOGIT_TOL:
        fail(f"bf16 prefill logits through the kernel differ from the plain path by {worst}")

    # f32 weights: the kernel's path and the plain path give the same tokens.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    runs = {}
    for flash in (True, False):
        runs[flash], ttft32, _ = serve_requests(params32, cfg32, prompts, dev, flash=flash)
    same = all(np.array_equal(runs[True][r], runs[False][r]) for r in range(len(prompts)))
    phase("serve", f"f32 weights: tokens through the kernel and the plain path identical: {same} "
                   f"(kernel path time to first token {min(ttft32) * 1e3:.1f} to "
                   f"{max(ttft32) * 1e3:.1f} ms)")
    if not same:
        fail("f32 serving through the flash kernel and the plain path gave different tokens")
    del params32
    torch.cuda.empty_cache()
    return launches


def profile_serving(params, cfg, prompts, dev) -> None:
    """Where a serving step's time goes (printed, not asserted): torch.profiler
    over one warm step that admits the 1000-token prompt (prefill plus one
    decode) and over one decode step of four active slots. The device's busy
    share is its summed kernel time over the step's host wall time, which the
    profiler itself lengthens."""
    from repro_torch.serve.engine import Engine

    big = Engine(params, cfg, slots=1, cache_len=1024, device=dev)
    big.submit(prompts[-1], max_new=2)
    profile_once(f"admission of {len(prompts[-1])} tokens + 1 decode", big.step)
    four = Engine(params, cfg, slots=4, cache_len=1024, device=dev)
    for p in prompts[:4]:
        four.submit(p, max_new=SERVE_MAX_NEW)
    four.step()  # the four admissions
    profile_once("decode step, 4 slots", four.step)


def profile_once(name: str, fn) -> None:
    """torch.profiler over one call of ``fn`` (printed, not asserted): host
    wall, device busy (summed kernel time, a share of the wall, which the
    profiler itself lengthens), the kernel count and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device kernels only: the host ops that launch them report the same
    # time again.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        phase("profile", f"{name}: the profiler saw no device time (host wall {wall_us:.0f} us)")
        return
    top = sorted(rows, key=lambda r: -r[1])[:6]
    phase("profile", f"{name}: host wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
                     f"({100 * busy_us / wall_us:.1f}%), {sum(r[2] for r in rows)} kernels; "
                     "top: " + "; ".join(f"{k[:60]} x{c} {t:.0f} us" for k, t, c in top))


def serve_cli() -> None:
    """Phase 13: the serve CLI with its defaults, on the card."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"], capture_output=True, text=True,
        timeout=600, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    for line in res.stdout.strip().splitlines():
        phase("cli", line)
    if res.returncode != 0 or "generated (8, 48)" not in res.stdout:
        fail(f"python -m repro_torch.launch.serve exited {res.returncode}:\n{res.stderr[-3000:]}")


# -- 16-18. slice D: LLM-cohort training and cohort routing --------------------

def lm_cfg_reduced():
    """The reduced llama3.2-1b of the lm_smoke preset's runs (f32)."""
    from repro_torch.configs import base as cfgbase

    cfg = cfgbase.get("llama3.2-1b")
    return dataclasses.replace(cfg.reduced(), param_dtype="float32", optimizer=cfg.optimizer)


def lm_trainer(dev, backend: str, topology_spec: str = LM_TOPOLOGY, nodes: int = 4, **kw):
    from repro_torch.train.trainer import LMCohortTrainer

    return LMCohortTrainer(topology_spec, lm_cfg_reduced(), nodes=nodes, batch=2, seq=32,
                           lr=1e-3, backend=backend, device=dev, **kw)


def lm_mix_checks(topology_spec: str, leaves: list, dev) -> dict[str, float]:
    """gossip_mix and the blocked kernel on each (N, size) view of ``leaves``
    against the plain f32 ``W @ P`` (``gossip_mix_ref``) of the topology's
    decavg W, one leaf at a time, each output freed before the next (a
    full-width leaf is 2.1 GB); fails past TOL. Returns each kernel's max
    abs error."""
    from repro_torch.core import sparse, topology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import sparse_gossip as sg

    csr = sparse.csr_from_graph(topology.make(topology_spec))
    w = torch.as_tensor(sparse.csr_to_dense(csr), device=dev)
    b = sparse.block_ell_from_csr(csr)
    idx, val = torch.as_tensor(b.idx, device=dev), torch.as_tensor(b.val, device=dev)
    errs = {"gossip_mix": 0.0, "sparse_gossip_blocked": 0.0}
    for leaf in leaves:
        p = leaf.reshape(leaf.shape[0], -1)
        want = gm.gossip_mix_ref(w, p)
        for name, fn in (("gossip_mix", gm.gossip_mix),
                         ("sparse_gossip_blocked",
                          lambda _, q: sg.gossip_mix_sparse_blocked(idx, val, q))):
            got = fn(w, p)
            err = float(got.sub_(want).abs_().max())  # in place: no third leaf-sized buffer
            del got
            if not err <= TOL[p.dtype]:
                fail(f"{name} on {topology_spec} leaf {tuple(p.shape)} {p.dtype}: max_abs_err "
                     f"{err} > {TOL[p.dtype]}")
            errs[name] = max(errs[name], err)
        del want
    return errs


def lm_main_path(dev) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 16; returns each kernel's launches on the reduced LM paths and
    its max abs error against the plain version at their shapes."""
    from repro_torch.experiments import analysis, presets, runner
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves

    # The lm_smoke preset: 6 runs, fused dense.
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "lm_smoke.jsonl")
        t0 = time.perf_counter()
        summary = runner.run_sweep(presets.get_preset("lm_smoke"), path)
        wall = time.perf_counter() - t0
        store = ResultsStore(path)
        if summary["failed"]:
            errors = [r for r in store.records()
                      if r.get("kind") == "run_end" and r.get("status") != "completed"]
            fail(f"lm_smoke runs failed: {errors}")
        finals = store.finals()
        if not all(f["final"]["fused"] and math.isfinite(f["final"]["loss"])
                   for f in finals.values()):
            fail("lm_smoke: a run was not fused or ended with a non-finite loss")
        checks = analysis.qualitative_checks(analysis.summarize(store))
        phase("lm", f"lm_smoke preset: {len(finals)} runs, all fused, in {wall:.2f} s; " + json.dumps(
            {k: checks.get(k) for k in ("lm_gossip_spreads", "lm_gossip_g2_token_spread",
                                        "lm_isolated_g2_token_spread")})
            + f"; margin {checks['lm_gossip_g2_token_spread'] - checks['lm_isolated_g2_token_spread']!r}")
        # The gate (gossiped cohorts end with a higher g2_token_spread than
        # isolated ones) is asserted: tools/lm_smoke_seeds.py ran the
        # preset's grid for seeds 0-9 on the card and it held for every seed
        # pair, as the reference's grid does on the CPU (PERF.md, margins).
        if checks["lm_gossip_spreads"] is not True:
            fail(f"lm_smoke: lm_gossip_spreads is {checks['lm_gossip_spreads']}")

    launches = {"gossip_mix": 0, "sparse_gossip_blocked": 0}
    rounds = 6
    out = {}
    for k in (None, CHOCO_K):
        for backend, fused in (("dense", False), ("dense", True), ("pallas", False),
                               ("sparse_pallas", False), ("sparse_pallas", True)):
            tr = lm_trainer(dev, backend, compress=k)
            reset_launches()
            hist = (tr.run_fused if fused else tr.run)(rounds, eval_every=rounds)
            torch.cuda.synchronize()
            n_leaves = len(tree_leaves(tr.params))
            name = {"pallas": "gossip_mix", "sparse_pallas": "sparse_gossip_blocked"}.get(backend)
            if name is not None:
                if LAUNCHES[name] != n_leaves * rounds:
                    fail(f"lm {backend} fused={fused} compress={k}: {name} launched "
                         f"{LAUNCHES[name]} times, want {n_leaves} leaves x {rounds} rounds")
                launches[name] += LAUNCHES[name]
            if not math.isfinite(hist[-1]["loss"]):
                fail(f"lm {backend} fused={fused} compress={k}: loss {hist[-1]['loss']}")
            out[(k, backend, fused)] = ([x.clone() for x in tree_leaves(tr.params)],
                                        hist[-1]["loss"])
            del tr

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(out[a][0], out[b][0]))

    for k in (None, CHOCO_K):
        for backend in ("dense", "sparse_pallas"):
            d = diff((k, backend, False), (k, backend, True))
            dl = abs(out[(k, backend, False)][1] - out[(k, backend, True)][1])
            phase("lm", f"{LM_TOPOLOGY} {backend} compress={k}, {rounds} rounds: loop vs fused "
                        f"params max abs diff {d:.3e}, loss {dl:.3e} (tol 1e-6)")
            if not (d <= 1e-6 and dl <= 1e-6):
                fail(f"lm {backend} compress={k}: loop and fused disagree")
    # The backends sum W @ P in different orders (cuBLAS f32, 3xTF32 wgmma,
    # the blocked kernel), about 1e-7 apart a round; AdamW's normalized steps
    # grow that round by round. They are held at 1e-5 over the reference's
    # own parity horizon, 3 rounds, and the 6-round gap is printed.
    short = {}
    for backend, fused in (("dense", True), ("pallas", False), ("sparse_pallas", True)):
        tr = lm_trainer(dev, backend, compress=None)
        (tr.run_fused if fused else tr.run)(LM_BACKEND_ROUNDS, eval_every=LM_BACKEND_ROUNDS)
        short[backend] = [x.clone() for x in tree_leaves(tr.params)]
        del tr
    for other in (("pallas", False), ("sparse_pallas", True)):
        d = max(float((x - y).abs().max()) for x, y in zip(short["dense"], short[other[0]]))
        d6 = diff((None, "dense", True), (None,) + other)
        phase("lm", f"{LM_TOPOLOGY} compress off: dense vs {other[0]} params max abs diff "
                    f"{d:.3e} after {LM_BACKEND_ROUNDS} rounds (tol 1e-5), {d6:.3e} after "
                    f"{rounds} (printed)")
        if not d <= 1e-5:
            fail(f"lm: dense and {other[0]} disagree by {d}")
    phase("lm", f"launches a gossip round = the member's {n_leaves} leaves, for gossip_mix "
                f"(pallas, loop) and the blocked kernel (sparse_pallas, loop and fused)")
    errs = lm_mix_checks(LM_TOPOLOGY, out[(None, "pallas", False)][0], dev)
    phase("lm", f"both kernels on the {n_leaves} trained leaves of {LM_TOPOLOGY} (f32) against "
                f"W @ P: " + ", ".join(f"{k} max_abs_err={v:.3e}" for k, v in errs.items())
                + f" (tol {TOL[torch.float32]:g})")

    # Hubs killed at round 0 and never back: their params and both moments
    # stay bit-equal to their pre-run values, on the loop and the fused path.
    for fused in (False, True):
        tr = lm_trainer(dev, "dense", "ba:n=8,m=2", nodes=8, faults=LM_FAULTS)
        trace = tr.engine.fault_trace
        trace.ensure(rounds)
        dead = np.flatnonzero(~trace.alive_matrix(rounds).any(axis=0))
        before = [x.clone() for x in tree_leaves(tr.params) + tree_leaves(tr.opt_state)]
        (tr.run_fused if fused else tr.run)(rounds, eval_every=rounds)
        after = tree_leaves(tr.params) + tree_leaves(tr.opt_state)
        frozen = all(torch.equal(a[dead], b[dead]) for a, b in zip(before, after)
                     if a.dim() and a.shape[0] == 8)
        alive_moved = any(not torch.equal(a, b) for a, b in zip(before, after))
        phase("lm", f"ba:n=8,m=2 dense fused={fused} under {LM_FAULTS}: dead nodes "
                    f"{dead.tolist()} params and moments bit-unchanged: {frozen}; the rest "
                    f"trained: {alive_moved}")
        if dead.size == 0 or not frozen or not alive_moved:
            fail("lm faults: dead nodes not frozen, or nobody died, or nobody trained")
    return launches, errs


def lm_full_round_split(dev, smi: str) -> dict[str, float]:
    """Phase 17, in process: one full-width round on backend pallas with
    CHOCO (k=0.1) split on the device (CUDA events): the forward and backward
    of both members, the AdamW step, the CHOCO gossip (top-k, reference,
    gossip_mix, residual) and within it the mix alone, and the rest. Then
    both kernels on the f32 references, timed and checked; returns their
    max abs errors."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import LMCohortTrainer
    from repro_torch.tree import tree_unflatten
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    tr = LMCohortTrainer("ring", cfgbase.get("llama3.2-1b"), nodes=2, backend="pallas",
                         device=dev)
    tr._begin(4)

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    times = []
    for r in range(2):  # round 0 pays lazy initialisation; round 1 is reported
        e0 = ev()
        toks, labels = tr._batch(r)
        lr = tr._sched(r).to(dev)
        e1 = ev()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tr.params)]
        with torch.enable_grad():
            losses = tr._per_node(tree_unflatten(tr.params, leaves), toks, labels, tr._loss_fn)
            grads = torch.autograd.grad(losses.sum(), leaves)
        del leaves
        e2 = ev()
        adamw.update_(list(grads), tr.opt_state, tr.params, lr=lr)
        del grads
        e3 = ev()
        tr.engine.refresh(r)
        tr._gossip(lambda q: tr.engine.mix([q])[0])
        e4 = ev()
        with torch.no_grad():
            for ref in tree_leaves(tr.cstate.reference):
                tr.engine.mix([ref])
        e5 = ev()
        torch.cuda.synchronize()
        times.append((e0.elapsed_time(e1), e1.elapsed_time(e2), e2.elapsed_time(e3),
                      e3.elapsed_time(e4), e4.elapsed_time(e5), e0.elapsed_time(e4)))
    rest, fwd_bwd, opt, choco, mix, total = times[-1]
    peak = torch.cuda.max_memory_allocated()
    n_params = tr.member_params
    phase("lm_full", f"one full-width round on the device ({smi}), llama3.2-1b x 2 members, "
                     f"pallas, compress {tr.compress}: total {total:.2f} ms = forward+backward "
                     f"{fwd_bwd:.2f} + AdamW {opt:.2f} + CHOCO {choco:.2f} (top-k, references, "
                     f"residual; its gossip_mix alone, timed again after: {mix:.2f}) + rest (batch "
                     f"to the card, LR) {rest:.2f}; round 0 (lazy initialisation) "
                     f"{times[0][5]:.2f} ms")
    phase("lm_full", f"in-process peak device memory {peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB) "
                     f"({smi}); reckoned persistent state: bf16 params "
                     f"{2 * n_params * 2 / 1e9:.2f} GB, f32 moments {2 * 2 * n_params * 4 / 1e9:.2f} "
                     f"GB, f32 CHOCO references {2 * n_params * 4 / 1e9:.2f} GB")
    errs = lm_full_mix_times(dev, tree_leaves(tr.cstate.reference), smi)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def lm_full_fused_round(dev, smi: str) -> None:
    """Phase 17: full-width rounds of the fused path (sparse_pallas, CHOCO
    0.1): each round's local step and gossip replayed as CUDA graphs. Round
    0 runs eagerly, round 1 is captured; rounds 2-5 are timed, each from its
    buffers' refill to its last replayed kernel (CUDA events)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.train.trainer import LMCohortTrainer, _LMFusedRounds

    tr = LMCohortTrainer("ring", cfgbase.get("llama3.2-1b"), nodes=2, backend="sparse_pallas",
                         device=dev)
    rounds = 6
    tr._begin(rounds)
    staged = _LMFusedRounds(tr, tr.engine.program(rounds, kind="sparse_pallas"))
    batches = [tr._batch(r) for r in range(rounds)]
    times = []
    try:
        for r, (toks, labels) in enumerate(batches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            staged.round(r, toks, labels)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        staged.close()
    phase("lm_full", f"fused full-width rounds (sparse_pallas, compress {tr.compress}, graphs "
                     f"replayed): {spread(times[2:])} ms a round (rounds 2-{rounds - 1}); round 0 "
                     f"eager {times[0]:.2f} ms, round 1 with its captures {times[1]:.2f} ms; "
                     f"loss {staged.loss:.4f}; {smi}")
    del staged, tr, batches
    gc.collect()
    torch.cuda.empty_cache()


def lm_full_mix_times(dev, refs: list, smi: str) -> dict[str, float]:
    """Phase 17: one gossip of the full-width f32 CHOCO references (12
    leaves, 2 x 1.498 B values) on the device: gossip_mix, the blocked kernel
    on ring:n=2's one padded block, torch.matmul, and the bytes bound; then
    both kernels against the plain version, leaf by leaf. Returns their max
    abs errors."""
    from repro_torch.core import sparse, topology
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import sparse_gossip as sg

    csr = sparse.csr_from_graph(topology.make("ring:n=2"))
    w = torch.as_tensor(sparse.csr_to_dense(csr), device=dev)
    b = sparse.block_ell_from_csr(csr)
    idx, val = torch.as_tensor(b.idx, device=dev), torch.as_tensor(b.val, device=dev)
    flat = [r.reshape(2, -1) for r in refs]
    runs = {
        "gossip_mix": lambda: [gm.gossip_mix(w, p) for p in flat],
        "blocked kernel": lambda: [sg.gossip_mix_sparse_blocked(idx, val, p) for p in flat],
        "torch.matmul": lambda: [torch.matmul(w, p) for p in flat],
    }
    got = {name: time_ms(fn, reps=3, warmup=1) for name, fn in runs.items()}
    nbytes = 2 * sum(p.numel() * p.element_size() for p in flat)
    phase("lm_full", "full-width gossip of the f32 references (12 leaves, N=2), on the device: "
                     + ", ".join(f"{k} {v:.2f} ms" for k, v in got.items())
                     + f"; bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
                       f"({nbytes / 1e9:.2f} GB); {smi}")
    errs = lm_mix_checks("ring:n=2", refs, dev)
    phase("lm_full", "both kernels on the 12 full-width f32 references (N=2, D up to "
                     f"{max(r[0].numel() for r in refs)}) against W @ P: "
                     + ", ".join(f"{k} max_abs_err={v:.3e}" for k, v in errs.items())
                     + f" (tol {TOL[torch.float32]:g})")
    # The members start from one draw, so the references' two rows are
    # nearly equal and their mean nearly exact; uniform rows at the widest
    # leaf's shape exercise the arithmetic as well as the indexing.
    gen = torch.Generator(device=dev).manual_seed(0)
    widest = max(refs, key=lambda r: r.numel())
    rand = lm_mix_checks("ring:n=2", [torch.rand(widest.shape, generator=gen, device=dev) * 2 - 1],
                         dev)
    phase("lm_full", f"both kernels on uniform [-1, 1) rows of shape {tuple(widest.shape)} (f32) "
                     "against W @ P: " + ", ".join(f"{k} max_abs_err={v:.3e}" for k, v in rand.items())
                     + f" (tol {TOL[torch.float32]:g})")
    return {k: max(v, rand[k]) for k, v in errs.items()}


def lm_full_width(dev, smi: str) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 17; returns each kernel's launches on the two full-width runs
    and its max abs error against the plain version at their shapes."""
    from repro_torch.experiments.store import ResultsStore

    gc.collect()
    torch.cuda.empty_cache()
    launches = {"gossip_mix": 0, "sparse_gossip_blocked": 0}
    leaves = 12  # embed, lm_head, final_norm, and 9 stacked leaves of the layer groups
    for backend, name, path in (("pallas", "gossip_mix", "loop"),
                                ("sparse_pallas", "sparse_gossip_blocked", "fused")):
        with tempfile.TemporaryDirectory() as tmp:
            store_path = str(Path(tmp) / "train.jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
                   "--full-scale", "--nodes", "2", "--topology", "ring", "--steps",
                   str(LM_FULL_STEPS), "--mix-backend", backend, "--store", store_path,
                   "--lr", str(LM_FULL_LR)]
            tag = f"{backend}, lr {LM_FULL_LR:g}"
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT,
                                 env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            wall = time.perf_counter() - t0
            for line in res.stdout.strip().splitlines():
                phase("lm_full", f"[{tag}] {line}")
            if res.returncode != 0:
                fail(f"{' '.join(cmd[1:])} exited {res.returncode}:\n{res.stderr[-4000:]}")
            store = ResultsStore(store_path)
            (rid, end), = store.finals().items()
            records, final = store.curves(rid), end["final"]
            keys = ("loss", "lr", "g2_token_spread", "wall_s")
            finite = all(math.isfinite(r[k]) for r in records for k in keys) and all(
                math.isfinite(a) for r in records for a in r["domain_acc"]) and math.isfinite(
                final["consensus_mean"])
            got = dict(re.findall(r"(\w+)=(\d+)", res.stdout.split("kernel launches", 1)[1]
                                  .splitlines()[0]))
            n = int(got[name])
            launches[name] += n
            first, last = records[0], records[-1]
            peak = re.search(r"peak device memory ([\d.]+) GiB", res.stdout).group(1)
            phase("lm_full", f"[{tag}] {path}, fused={final['fused']}, compress "
                             f"{final['compress']}, members {final['members_m']} M: loss "
                             f"{first['loss']:.4f} (round {first['round']}) -> {last['loss']:.4f} "
                             f"(round {last['round']}); {name} launches {n} = {leaves} leaves x "
                             f"{LM_FULL_STEPS} rounds; peak {peak} GiB; "
                             f"{LM_FULL_STEPS / end['wall_s']:.3f} rounds/s with set-up "
                             f"({end['wall_s']:.2f} s in run_spec, {wall:.2f} s for the process); "
                             f"{smi}")
            if not finite:
                fail(f"[{backend}] a full-width record is not finite: {records} {final}")
            if n != leaves * LM_FULL_STEPS or final["fused"] != (path == "fused"):
                fail(f"[{backend}] {name} launched {n} times (want {leaves * LM_FULL_STEPS}), "
                     f"fused {final['fused']}")
            if final["compress"] != 0.1 or final["members_m"] != 1498.48:
                fail(f"[{backend}] compress {final['compress']}, members {final['members_m']} M")
            if not last["loss"] < first["loss"]:
                fail(f"[{tag}] the loss did not fall: {first['loss']} -> {last['loss']}")
    errs = lm_full_round_split(dev, smi)
    lm_full_fused_round(dev, smi)
    return launches, errs


# -- 19-20. slice G: the rest of the model zoo ---------------------------------

def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def zoo_reduced_checks(dev) -> None:
    """Phase 19, first part: each zoo arch's reduced config in f32 on the
    card. Chunked prefill against token-by-token prefill at 2e-5, then 4
    decode steps alike (MoE patterns excepted: a prompt routes as one group,
    decode as one-token groups; jamba's Mamba path is checked with its FFNs
    dense); the Engine's tokens identical to generate's for internvl2, their
    agreement printed for the MoE archs (the slot batching changes their
    routing groups); Engine tokens through the flash kernel identical to the
    plain path's."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import frontends
    from repro_torch.models import transformer as TF
    from repro_torch.serve import decode as SD
    from repro_torch.serve.engine import Engine, engine_ok

    rng = np.random.default_rng(0)
    for arch, _, _ in ZOO_RUNS:
        cfg = cfgbase.get(arch).reduced()
        checked = cfg
        if arch.startswith("jamba"):
            checked = dataclasses.replace(cfg, moe=None, pattern=tuple(
                dataclasses.replace(sp, ffn="dense") for sp in cfg.pattern))
        params = TF.init_params(torch.Generator(device=dev).manual_seed(0), checked, device=dev)
        memory = None
        if cfg.enc_dec:
            frames = frontends.audio_frames(torch.Generator(device=dev).manual_seed(1), cfg, 2, 40)
            with torch.no_grad():
                memory = TF.encode(params, cfg, frames)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 29))).to(dev)
        if all(sp.ffn != "moe" for sp in checked.pattern):
            lc, cc = SD.prefill(params, checked, toks, TF.init_cache(checked, 2, 64, device=dev),
                                memory=memory, flash=False)
            ls, cs = SD.prefill_sequential(params, checked, toks,
                                           TF.init_cache(checked, 2, 64, device=dev),
                                           memory=memory)
            errs = [float((lc - ls).abs().max())]
            tok = lc.argmax(dim=-1)
            for _ in range(4):
                lc, cc = TF.decode_step(params, checked, tok, cc, memory=memory)
                ls, cs = TF.decode_step(params, checked, tok, cs, memory=memory)
                errs.append(float((lc - ls).abs().max()))
                tok = lc.argmax(dim=-1)
            phase("zoo", f"{checked.arch_id}{' (FFNs dense)' if checked is not cfg else ''} "
                         f"f32: chunked vs token-by-token prefill logits max abs diff "
                         f"{errs[0]:.3e}, then 4 decode steps {max(errs[1:]):.3e} (tol 2e-5)")
            if not max(errs) <= 2e-5 or not torch.isfinite(lc).all():
                fail(f"{checked.arch_id}: chunked and sequential prefill disagree: {errs}")
        if engine_ok(cfg):
            prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                       for n in (5, 9, 17, 30)]
            out = {}
            for flash in (True, False):
                eng = Engine(params, cfg, slots=2, cache_len=64, flash=flash, device=dev)
                rids = [eng.submit(p, max_new=8) for p in prompts]
                got = eng.run()
                out[flash] = [got[r] for r in rids]
            same_flash = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
            alone = [SD.generate(params, cfg, torch.from_numpy(p)[None].to(dev),
                                 TF.init_cache(cfg, 1, 64, device=dev), steps=8)[0].cpu().numpy()
                     for p in prompts]
            agree = sum(int((a == b).sum()) for a, b in zip(out[True], alone))
            moe = any(sp.ffn == "moe" for sp in cfg.pattern)
            phase("zoo", f"{cfg.arch_id} f32 Engine(slots=2): tokens through the flash kernel "
                         f"and the plain path identical: {same_flash}; Engine vs generate "
                         f"tokens agree {agree}/{8 * len(prompts)}"
                         + (" (printed: MoE routing groups follow the slot batching)" if moe
                            else ""))
            if not same_flash:
                fail(f"{cfg.arch_id}: Engine tokens through the kernel differ from the plain path")
            if not moe and agree != 8 * len(prompts):
                fail(f"{cfg.arch_id}: Engine tokens differ from generate's")
        del params
        free_card()


def zoo_generate(params, cfg, dev, smi: str) -> None:
    """Phase 19: batch 4, one prompt length (512; whisper 432, its decoder
    context less the new tokens) through ``generate``, 16 greedy tokens;
    whisper first encodes 1500 stub frames. A cold run, then a warm one
    timed; then the prefill timed alone, and the 16 greedy decode steps that
    follow it timed alone (decode tokens/s is 64 tokens over their time)."""
    from repro_torch.models import frontends
    from repro_torch.models import transformer as TF
    from repro_torch.serve import decode as SD

    s = min(ZOO_PROMPT, cfg.max_target_len - SERVE_MAX_NEW) if cfg.enc_dec else ZOO_PROMPT
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ZOO_BATCH, s))).to(dev)
    memory, t_enc = None, 0.0
    if cfg.enc_dec:
        frames = frontends.audio_frames(torch.Generator(device=dev).manual_seed(1), cfg,
                                        ZOO_BATCH, WHISPER_FRAMES)
        with torch.no_grad():
            TF.encode(params, cfg, frames)  # cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            memory = TF.encode(params, cfg, frames)
            torch.cuda.synchronize()
            t_enc = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(memory).all():
            fail(f"{cfg.arch_id}: encoder memory is not finite")

    def cache(room: int = 0):
        return TF.init_cache(cfg, ZOO_BATCH, s + SERVE_MAX_NEW + room, device=dev)

    cold = SD.generate(params, cfg, prompt, cache(), steps=SERVE_MAX_NEW, memory=memory)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = SD.generate(params, cfg, prompt, cache(), steps=SERVE_MAX_NEW, memory=memory)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    c = cache(room=1)  # one step more, for the profiled decode step below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, c = SD.prefill(params, cfg, prompt, c, memory=memory)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    tok = SD.sample(logits, 0.0, None)
    t0 = time.perf_counter()
    for _ in range(SERVE_MAX_NEW):  # generate's decode steps
        step_logits, c = TF.decode_step(params, cfg, tok, c, memory=memory)
        tok = SD.sample(step_logits, 0.0, None)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())
    same = torch.equal(cold, toks)
    ok_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    n_tok = ZOO_BATCH * SERVE_MAX_NEW
    phase("zoo", f"{cfg.arch_id} generate, batch {ZOO_BATCH} x {s} prompt tokens + "
                 f"{SERVE_MAX_NEW} new"
                 + (f" (encoder over {WHISPER_FRAMES} stub frames {t_enc:.2f} ms)" if cfg.enc_dec
                    else "")
                 + f": generate {t_gen * 1e3:.2f} ms; alone, prefill {t_pre * 1e3:.2f} ms and "
                   f"{SERVE_MAX_NEW} decode steps {t_dec * 1e3:.2f} ms, decode "
                   f"{n_tok / t_dec:.1f} tokens/s; logits finite {finite}; warm tokens equal "
                   f"cold {same}; peak "
                   f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the weights); "
                   f"{smi}")
    if not (finite and same and ok_range):
        fail(f"{cfg.arch_id}: finite {finite}, warm == cold {same}, tokens in range {ok_range}")
    profile_once(f"{cfg.arch_id} prefill of {ZOO_BATCH} x {s} tokens",
                 lambda: SD.prefill(params, cfg, prompt, cache(), memory=memory))
    profile_once(f"{cfg.arch_id} decode step, batch {ZOO_BATCH}",
                 lambda: TF.decode_step(params, cfg, tok, c, memory=memory))


def zoo_engine(params, cfg, dev, smi: str) -> int:
    """Phase 19: four requests of 37 to 512 prompt tokens through
    Engine(slots=4, cache_len=1024), 16 greedy tokens each, cold then warm;
    in the warm run flash launched once per attention layer per admission;
    each request's prefill (as admitted: padded to its bucket) through the
    kernel within 0.1 of the plain path, its time printed. Returns the warm
    run's flash launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as TF
    from repro_torch.serve import decode as SD
    from repro_torch.serve.engine import Engine, _bucket

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in ZOO_ENGINE_LENS]
    cold, _, _ = serve_requests(params, cfg, prompts, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, ttft, decode = serve_requests(params, cfg, prompts, dev)
    launches = LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    want = cfg.num_layers * len(prompts)
    same = all(np.array_equal(toks[r], cold[r]) for r in toks)
    phase("zoo", f"{cfg.arch_id} Engine(slots=4, cache_len=1024), {len(prompts)} requests x "
                 f"{SERVE_MAX_NEW} new tokens: flash launches {launches} (want {cfg.num_layers} "
                 f"layers x {len(prompts)} admissions = {want}); time to first token "
                 + ", ".join(f"{t * 1e3:.1f}" for t in ttft)
                 + f" ms; decode {decode['tokens'] / decode['s']:.1f} tokens/s; warm tokens "
                   f"equal cold {same}; peak {peak / 2**30:.3f} GiB "
                   f"({(peak - base) / 2**30:.3f} above the weights); {smi}")
    if launches != want:
        fail(f"{cfg.arch_id}: flash launched {launches} times in the Engine run, want {want}")
    if not same or any(not ((t >= 0) & (t < cfg.vocab_size)).all() for t in toks.values()):
        fail(f"{cfg.arch_id}: the Engine's tokens are out of range or differ from the cold run")
    worst = 0.0
    for n, p in zip(ZOO_ENGINE_LENS, prompts):
        padded = torch.zeros((1, min(_bucket(n), 1024)), dtype=torch.int32, device=dev)
        padded[0, :n] = torch.from_numpy(p).to(dev)
        length = torch.tensor([n], dtype=torch.int32, device=dev)
        logits, ms = {}, {}
        for flash in (True, False):
            row = TF.init_cache(cfg, 1, 1024, per_slot=True, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[flash], _ = SD.prefill(params, cfg, padded, row, length=length, flash=flash)
            torch.cuda.synchronize()
            ms[flash] = (time.perf_counter() - t0) * 1e3
        if not all(bool(torch.isfinite(x).all()) for x in logits.values()):
            fail(f"{cfg.arch_id}: prompt {n}: prefill logits are not finite")
        err = float((logits[True] - logits[False]).abs().max())
        worst = max(worst, err)
        phase("zoo", f"{cfg.arch_id} prompt {n:4d} (bucket {padded.shape[1]:4d}): prefill "
                     f"{ms[True]:.2f} ms through the kernel, {ms[False]:.2f} ms plain; logits "
                     f"max_abs_err {err:.3e} (tol {SERVE_LOGIT_TOL})")
    if not worst <= SERVE_LOGIT_TOL:
        fail(f"{cfg.arch_id}: bf16 prefill logits through the kernel differ by {worst}")
    eng = Engine(params, cfg, slots=4, cache_len=1024, device=dev)
    for p in prompts:
        eng.submit(p, max_new=SERVE_MAX_NEW)
    profile_once(f"{cfg.arch_id} Engine step admitting {len(prompts)} requests", eng.step)
    profile_once(f"{cfg.arch_id} Engine decode step, {len(prompts)} slots", eng.step)
    return launches


def zoo_main_path(dev, smi: str) -> int:
    """Phase 19; returns the flash kernel's launches in the warm Engine runs."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as TF

    zoo_reduced_checks(dev)
    flash_launches = 0
    for arch, layers, route in ZOO_RUNS:
        full = cfgbase.get(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        free_card()
        t0 = time.perf_counter()
        params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        n_params = TF.param_count(params)
        phase("zoo", f"{arch}: {layers} of {full.num_layers} layers, d_model {cfg.d_model}, "
                     f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}: {n_params} "
                     f"{cfg.param_dtype} parameters ({n_params * 2 / 1e9:.2f} GB), drawn on the "
                     f"card in {time.perf_counter() - t0:.2f} s")
        if route == "generate":
            zoo_generate(params, cfg, dev, smi)
        else:
            flash_launches += zoo_engine(params, cfg, dev, smi)
        del params
    free_card()
    return flash_launches


def zoo_lm_main_path(dev, smi: str) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 20: each decoder-only zoo arch's reduced members (4 on a ring,
    f32) through python -m repro_torch.launch.train on sparse_pallas (fused:
    the blocked kernel in CUDA graphs), and jamba's and dbrx's on pallas (the
    loop, gossip_mix), 4 processes at a time: exit 0, finite records, one
    launch per leaf per gossip round, a falling loss. Then each arch's loop
    and fused runs on sparse_pallas in process, held within 1e-6, and both
    kernels on the fused run's leaves against the plain ``W @ P``. Returns
    the CLI runs' launches and each kernel's max abs error on these leaves."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.experiments.store import ResultsStore
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as TF
    from repro_torch.train.trainer import LMCohortTrainer
    from repro_torch.tree import tree_leaves

    runs = [(arch, "sparse_pallas") for arch in ZOO_LM_ARCHS] + [
        ("jamba-v0.1-52b", "pallas"), ("dbrx-132b", "pallas")]
    name_of = {"pallas": "gossip_mix", "sparse_pallas": "sparse_gossip_blocked"}
    launches = {"gossip_mix": 0, "sparse_gossip_blocked": 0}
    with tempfile.TemporaryDirectory() as tmp:
        def one(run):
            arch, backend = run
            store = str(Path(tmp) / f"{arch}-{backend}.jsonl")
            lr = ZOO_LM_LR[cfgbase.get(arch).optimizer]
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                   *ZOO_LM_ARGS, "--lr", str(lr), "--mix-backend", backend, "--store", store]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                                 env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            return run, cmd, res, store, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=4) as pool:
            results = list(pool.map(one, runs))
        for (arch, backend), cmd, res, store_path, wall in results:
            if res.returncode != 0:
                fail(f"{' '.join(cmd[1:])} exited {res.returncode}:\n{res.stderr[-4000:]}")
            cfg = cfgbase.get(arch).reduced()
            leaves = len(tree_leaves(TF.init_params(0, cfg, device="meta")))
            store = ResultsStore(store_path)
            (rid, end), = store.finals().items()
            records, final = store.curves(rid), end["final"]
            finite = all(math.isfinite(r[k]) for r in records for k in ("loss", "lr")) and \
                math.isfinite(final["loss"]) and math.isfinite(final["consensus_mean"])
            got = dict(re.findall(r"(\w+)=(\d+)", res.stdout.split("kernel launches", 1)[1]
                                  .splitlines()[0]))
            name = name_of[backend]
            n = int(got[name])
            launches[name] += n
            want = leaves * ZOO_LM_STEPS
            first, last = records[0], records[-1]
            phase("zoo_lm", f"{arch} {backend} ({'fused' if final['fused'] else 'loop'}, "
                            f"compress {final['compress']}, {final['members_m']} M a member, "
                            f"optimizer {cfg.optimizer}, lr {ZOO_LM_LR[cfg.optimizer]:g}): loss "
                            f"{first['loss']:.4f} (round {first['round']}) -> {last['loss']:.4f} "
                            f"(round {last['round']}), {name} launches {n} (want {leaves} leaves "
                            f"x {ZOO_LM_STEPS} rounds = {want}); {wall:.2f} s for the process")
            if not finite or n != want or final["fused"] != (backend == "sparse_pallas"):
                fail(f"{arch} {backend}: finite {finite}, {name} launched {n} (want {want}), "
                     f"fused {final['fused']}")
            if not last["loss"] < first["loss"]:
                fail(f"{arch} {backend}: the loss did not fall: {first['loss']} -> {last['loss']}")

    errs = {"gossip_mix": 0.0, "sparse_gossip_blocked": 0.0}
    for arch in ZOO_LM_ARCHS:
        cfg = cfgbase.get(arch).reduced()
        kw = dict(nodes=4, batch=2, seq=32, lr=1e-3, backend="sparse_pallas", device=dev)
        loop = LMCohortTrainer("ring:n=4", cfg, **kw)
        h_loop = loop.run(ZOO_LM_ROUNDS, eval_every=ZOO_LM_ROUNDS)
        fused = LMCohortTrainer("ring:n=4", cfg, **kw)
        reset_launches()
        h_fused = fused.run_fused(ZOO_LM_ROUNDS, eval_every=ZOO_LM_ROUNDS)
        torch.cuda.synchronize()
        n_leaves = len(tree_leaves(fused.params))
        d = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(loop.params), tree_leaves(fused.params)))
        dl = abs(h_loop[-1]["loss"] - h_fused[-1]["loss"])
        blocked = LAUNCHES["sparse_gossip_blocked"]
        phase("zoo_lm", f"{cfg.arch_id} sparse_pallas compress {fused.compress}, "
                        f"{ZOO_LM_ROUNDS} rounds: loop vs fused params max abs diff {d:.3e}, "
                        f"loss {dl:.3e} (tol 1e-6); fused blocked-kernel launches {blocked} "
                        f"(want {n_leaves} x {ZOO_LM_ROUNDS})")
        if not (d <= 1e-6 and dl <= 1e-6) or blocked != n_leaves * ZOO_LM_ROUNDS:
            fail(f"{cfg.arch_id}: loop and fused disagree ({d}, {dl}) or launches {blocked}")
        arch_errs = lm_mix_checks("ring:n=4", tree_leaves(fused.params), dev)
        phase("zoo_lm", f"{cfg.arch_id}: the kernels on its {n_leaves} trained leaves against "
                        f"W @ P: " + ", ".join(f"{k} max_abs_err={v:.3e}"
                                              for k, v in arch_errs.items())
                        + f" (tol {TOL[torch.float32]:g})")
        for k, v in arch_errs.items():
            errs[k] = max(errs[k], v)
        del loop, fused
        free_card()
    return launches, errs


# -- 21. slice G2: step builders and pipeline-parallel decode ------------------


def pipe_meshes(dev):
    """(name, build_pipeline_step kwargs, mesh) of every pipeline variant."""
    from repro_torch.launch import mesh as LM

    out = [(f"auto {shape}", False, LM.make_host_mesh(shape, device=dev))
           for shape in PIPE_AUTO_MESHES]
    out += [(f"manual {dict(zip(axes, shape))}", True, LM.make_host_mesh(shape, axes, device=dev))
            for shape, axes in PIPE_MANUAL_MESHES]
    return out


def kv_gap(got: dict, want: dict, group=slice(None)) -> tuple[float, float]:
    """(largest int8 level difference, or abs difference of plain values,
    and the largest relative scale difference) over k, v and their scales
    of the groups ``group``."""
    vals = max(float((got[k][group].float() - want[k][group].float()).abs().max())
               for k in ("k", "v"))
    if "k_scale" not in got:
        return vals, 0.0
    scales = max(float(((got[k][group] - want[k][group]).abs()
                        / want[k][group].abs().clamp_min(1e-30)).max())
                 for k in ("k_scale", "v_scale"))
    return vals, scales


def int8_spread(got: dict, want: dict) -> str:
    """Per group, the largest level difference of k and v, and the share of
    entries more than one level apart."""
    lv = [max(float((got[k][g].float() - want[k][g].float()).abs().max()) for k in ("k", "v"))
          for g in range(got["k"].shape[0])]
    far = sum(int(((got[k].float() - want[k].float()).abs() > 1).sum()) for k in ("k", "v"))
    return (f"levels by group {[int(x) for x in lv]}, entries more than one level apart "
            f"{far} of {2 * got['k'].numel()}")


def pipeline_agreement(params, cfg, dev, smi: str) -> None:
    """Phase 21, f32: every variant teacher-forced with the plain step's
    tokens, held to the serve step's tokens and caches."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.serve import pipeline as PL
    from repro_torch.serve import pipeline_manual as PM

    b, t_len = PIPE_BATCH, PIPE_CACHE
    start = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, b)).to(
        device=dev, dtype=torch.int32)
    serve = ST.build_serve_step(cfg)
    ref = {}
    for quant in (False, True):
        cache = TF.init_cache(cfg, b, t_len, kv_quant=quant, device=dev)
        gap_cache = TF.init_cache(cfg, b, t_len, kv_quant=quant, device=dev)
        fed, chosen, gaps, tok = [], [], [], start
        t0 = time.perf_counter()
        for _ in range(PIPE_STEPS):
            fed.append(tok)
            nxt, cache = serve(params, tok, cache)
            logits, gap_cache = TF.decode_step(params, cfg, tok, gap_cache)
            top2 = logits.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            if not torch.equal(logits.argmax(-1).to(torch.int32), nxt):
                fail("build_serve_step's token is not decode_step's argmax")
            chosen.append(nxt)
            tok = nxt
        torch.cuda.synchronize()
        ref[quant] = (fed, torch.stack(chosen), torch.stack(gaps), cache)
        del gap_cache
        phase("pipeline", f"build_serve_step, {'int8' if quant else 'plain'} cache, f32: "
                          f"{PIPE_STEPS} steps of batch {b} in {time.perf_counter() - t0:.2f} s; "
                          f"smallest top-2 logit gap {float(ref[quant][2].min()):.3e}")

    controls = {}

    def microgroup_control(stages: int) -> dict:
        """The int8 cache of build_serve_step run over each microgroup's
        rows alone (batch b / stages, the same fed tokens), the microgroups'
        caches concatenated along the batch: the pipeline's matmul shapes."""
        if stages not in controls:
            mb, parts = b // stages, []
            for m in range(stages):
                cache = TF.init_cache(cfg, mb, t_len, kv_quant=True, device=dev)
                for tok in ref[True][0]:
                    _, cache = serve(params, tok[m * mb:(m + 1) * mb], cache)
                parts.append(cache["layer0"]["mixer"])
            controls[stages] = {k: parts[0][k] if k == "index" else torch.cat(
                [p[k] for p in parts], dim=1) for k in parts[0]}
        return controls[stages]

    def agree(name: str, got: torch.Tensor, quant: bool) -> None:
        _, want, gaps, _ = ref[quant]
        diff = got != want
        n_diff = int(diff.sum())
        bad = int((diff & (gaps >= PIPE_GAP)).sum())
        phase("pipeline", f"{name}: {got.numel()} tokens, {n_diff} differ from build_serve_step "
                          f"({'int8' if quant else 'plain'} cache), {bad} of them at a top-2 gap "
                          f">= {PIPE_GAP}; smallest gap of all rows {float(gaps.min()):.3e}"
                          + (f", of the differing rows {float(gaps[diff].min()):.3e}"
                             if n_diff else ""))
        if bad:
            fail(f"{name}: {bad} tokens differ where the plain step's top-2 gap is >= {PIPE_GAP}")

    for name, manual, mesh in pipe_meshes(dev):
        step = PL.build_pipeline_step(cfg, mesh, manual=manual)
        for quant in ((True,) if manual else (False, True)):
            fed = ref[quant][0]
            if manual:
                tp = mesh.shape["model"]
                cache = PM.init_kv_cache(cfg, b, t_len, tp=tp, device=dev)
            else:
                cache = TF.init_cache(cfg, b, t_len, kv_quant=quant, device=dev)
            chosen = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tok in fed:
                nxt, cache = step(params, tok, cache)
                chosen.append(nxt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            label = f"{name} {'int8' if quant else 'plain'}"
            agree(label, torch.stack(chosen), quant)
            mix = ref[quant][3]["layer0"]["mixer"]
            if manual:
                heads = PM.kv_heads(cfg, tp)
                got, want = cache, {k: mix[k][:, :, :, heads] for k in
                                    ("k", "v", "k_scale", "v_scale")}
            else:
                got, want = cache["layer0"]["mixer"], mix
            index_ok = bool((got["index"] == PIPE_STEPS).all())
            # The plain cache is held whole. An int8 cache is held to the
            # full-batch serve step's on the first group: its inputs differ
            # only by the matmuls' rounding at mb rows, and deeper groups read
            # keys that a rounding-sized change can move a whole level. The
            # auto variant's whole int8 cache is then held to the microgroup
            # control, which has the pipeline's matmul shapes.
            group = slice(None) if not quant else slice(0, 1)
            vals, scales = kv_gap(got, want, group)
            tol = 1.0 if quant else 1e-5
            phase("pipeline", f"{label}: {PIPE_STEPS} steps in {wall:.2f} s; cache vs the serve "
                              f"step's: {'int8 levels, group 0' if quant else 'max abs'} "
                              f"{vals:.3e} (tol {tol:g}), scales rel {scales:.3e} (tol 1e-5), "
                              f"index advanced once a step {index_ok}"
                              + (f"; {int8_spread(got, want)}" if quant else "") + f"; {smi}")
            if not (vals <= tol and scales <= 1e-5 and index_ok):
                fail(f"{label}: cache {vals} (tol {tol}), scales {scales}, index {index_ok}")
            if quant and not manual:
                stages = mesh.shape["data"]
                ctrl = microgroup_control(stages)
                c_vals, c_scales = kv_gap(got, ctrl)
                phase("pipeline", f"{label}: whole cache vs the microgroup control "
                                  f"(build_serve_step over each microgroup's {b // stages} rows "
                                  f"alone): int8 levels {c_vals:.3e} (tol 1), scales rel "
                                  f"{c_scales:.3e} (tol 1e-5); {int8_spread(got, ctrl)}; {smi}")
                if not (c_vals <= 1.0 and c_scales <= 1e-5):
                    fail(f"{label}: whole int8 cache vs the microgroup control: levels "
                         f"{c_vals}, scales {c_scales}")
            del cache
            free_card()


def pipeline_prefill(params, cfg, dev, smi: str) -> None:
    """Phase 21: build_prefill_step's tokens against generate's first."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.serve import decode as SD

    b, s = PIPE_PREFILL
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))).to(dev)
    step = ST.build_prefill_step(cfg)
    step(params, {"tokens": prompts})  # cold
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = step(params, {"tokens": prompts})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gen = SD.generate(params, cfg, prompts, TF.init_cache(cfg, b, s + 1, device=dev), steps=1)
    same = torch.equal(first, gen[:, 0])
    phase("pipeline", f"build_prefill_step, {b} x {s} tokens (f32): {ms:.2f} ms; first tokens "
                      f"equal generate's {same}; {smi}")
    if not same:
        fail(f"build_prefill_step {first.tolist()} vs generate {gen[:, 0].tolist()}")


def pipeline_times(params, cfg, dev, smi: str) -> None:
    """Phase 21, bf16: decode tokens/s of the serve step and both variants
    at (4, 2), each alone, free-running from the same tokens."""
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.serve import pipeline as PL
    from repro_torch.serve import pipeline_manual as PM

    b, t_len = PIPE_BATCH, PIPE_CACHE
    start = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, b)).to(
        device=dev, dtype=torch.int32)
    mesh = LM.make_host_mesh((4, 2), device=dev)
    runs = {
        "build_serve_step": (ST.build_serve_step(cfg),
                             lambda: TF.init_cache(cfg, b, t_len, device=dev)),
        "auto (4, 2)": (PL.build_pipeline_step(cfg, mesh),
                        lambda: TF.init_cache(cfg, b, t_len, device=dev)),
        "manual (4, 2)": (PL.build_pipeline_step(cfg, mesh, manual=True),
                          lambda: PM.init_kv_cache(cfg, b, t_len, tp=2, device=dev)),
    }
    toks = {}
    for name, (step, make_cache) in runs.items():
        cache, tok = make_cache(), start
        for _ in range(2):  # warm-up
            tok, cache = step(params, tok, cache)
        cache, tok, out = make_cache(), start, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PIPE_STEPS):
            tok, cache = step(params, tok, cache)
            out.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks[name] = torch.stack(out)
        share = float((toks[name] == toks["build_serve_step"]).float().mean())
        phase("pipeline", f"{name}, bf16, batch {b}, cache {t_len}: {PIPE_STEPS} steps in "
                          f"{wall * 1e3:.2f} ms, decode {b * PIPE_STEPS / wall:.1f} tokens/s, "
                          f"{wall * 1e3 / PIPE_STEPS:.2f} ms a step; tokens shared with the "
                          f"plain step (free-running) {share:.4f}; {smi}")
        profile_once(f"{name} decode step, bf16, batch {b}",
                     lambda step=step, tok=tok, cache=cache: step(params, tok, cache))
        del cache
        free_card()


def pipeline_train(cfg, dev, smi: str) -> None:
    """Phase 21: build_train_step at full width, 2 members (bf16 params,
    AdamW), on one fixed batch: the loss falls."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    n, mb, seq = 2, PIPE_TRAIN_MICROBATCHES, PIPE_TRAIN_SEQ
    free_card()
    member = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params = tree_map(lambda x: x.expand(n, *x.shape).contiguous(), member)
    del member
    opt = adamw.init(params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (mb, n, PIPE_TRAIN_ROWS // mb, seq + 1))).to(device=dev,
                                                                        dtype=torch.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    w = torch.full((n, n), 0.5, device=dev)
    step = ST.build_train_step(cfg, num_nodes=n, microbatches=mb, optimizer="adamw",
                               lr=LM_FULL_LR)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(PIPE_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, w, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    falls = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    phase("pipeline", f"build_train_step, {n} members x {TF.param_count(params) // n} "
                      f"{cfg.param_dtype} parameters, AdamW, {mb} microbatch(es) of "
                      f"{PIPE_TRAIN_ROWS // mb} x {seq} "
                      f"tokens a member, lr {LM_FULL_LR}: losses "
                      + ", ".join(f"{x:.5f}" for x in losses)
                      + f"; step {', '.join(f'{x:.2f}' for x in walls)} s; falls {falls}; peak "
                        f"{peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB; {base / 2**30:.3f} GiB "
                        f"before the first step) of the card's {total / 2**30:.3f} GiB; {smi}")
    if not falls or peak >= total:
        fail(f"build_train_step: losses {losses}, peak {peak}")
    del params, opt
    free_card()


def pipeline_main_path(dev, smi: str) -> None:
    """Phase 21: llama3.2-1b at full width through the step builders and
    both pipeline-parallel decoders (plain PyTorch: no kernel launches)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_map

    cfg = cfgbase.get("llama3.2-1b")
    free_card()
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    phase("pipeline", f"{cfg.arch_id}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                      f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {cfg.vocab_size}: "
                      f"{TF.param_count(params)} parameters (seed 0), f32 copy for agreement")
    pipeline_agreement(params32, cfg32, dev, smi)
    pipeline_prefill(params32, cfg32, dev, smi)
    del params32
    free_card()
    pipeline_times(params, cfg, dev, smi)
    del params
    pipeline_train_child(smi)


def live_cuda_storages(top: int = 4) -> str:
    """The largest CUDA storages this process still references, with a
    tensor of each (shape, dtype), for a memory line."""
    storages = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda and obj.layout == torch.strided:
            st = obj.untyped_storage()
            storages.setdefault(st.data_ptr(), (st.nbytes(), tuple(obj.shape), obj.dtype))
    big = sorted(storages.values(), key=lambda x: -x[0])[:top]
    return (f"{len(storages)} storages; largest " + ", ".join(
        f"{shape} {str(dtype).removeprefix('torch.')} {n / 2**30:.3f} GiB" for n, shape, dtype in big))


def pipeline_train_child(smi: str) -> None:
    """Phase 21's train step in a child process (``--pipeline-train``), so
    that it starts from an allocator no earlier phase has fragmented, and
    with expandable segments, so that its own blocks do not fragment either
    (2 microbatches peak within 8 GiB of the card's memory); its lines are
    printed here and its failure fails the run."""
    free_card()
    held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    phase("pipeline", f"before the build_train_step child, this process holds "
                      f"{held / 2**30:.3f} GiB ({reserved / 2**30:.3f} GiB reserved): "
                      f"{live_cuda_storages()}")
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--pipeline-train"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    for line in res.stdout.splitlines():
        print(line, flush=True)
    phase("pipeline", f"build_train_step child process (expandable segments): exit "
                      f"{res.returncode}; {smi}")
    if res.returncode != 0:
        fail(f"the build_train_step child exited {res.returncode}:\n{res.stderr[-3000:]}")


def dryrun_rows() -> None:
    """Phase 22: run_one for every arch x DRY_SHAPES x both production meshes
    and llama3.2-1b's DRY_LLAMA_ROWS on (16, 16), traced on ``meta``."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun as DR

    combos = [(a, s, mp) for a in cfgbase.ASSIGNED_ARCHS for s in DRY_SHAPES for mp in (False, True)]
    combos += [("llama3.2-1b", s, False) for s in DRY_LLAMA_ROWS]
    gbs = []
    t0 = time.perf_counter()
    for arch, shape_name, mp in combos:
        row = DR.run_one(arch, shape_name, multi_pod=mp)
        if row["status"] != "ok":
            fail(f"dry-run {arch} x {shape_name}: {row['status']}")
        gbs.append(row["per_device_hbm_gb"])
        phase("dryrun", f"{row['arch']} x {shape_name} x {row['mesh']}: dominant {row['dominant']} "
                        f"(compute {row['compute_s']:.3e} s, memory {row['memory_s']:.3e} s, "
                        f"collective {row['collective_s']:.3e} s), per-device arguments "
                        f"{row['per_device_hbm_gb']:.6f} GB, trace {row['lower_s']} s of "
                        f"{row['traced_layers']} layer(s)")
    phase("dryrun", f"{len(combos)} rows ok in {time.perf_counter() - t0:.2f} s on the host "
                    f"(meta device); per-device argument GB {min(gbs):.6f}..{max(gbs):.6f}")


def leaf_list(tree) -> list[tuple[tuple[int, ...], torch.dtype]]:
    from repro_torch.launch.dryrun import flat_leaves

    return [(tuple(x.shape), x.dtype) for _p, x in flat_leaves(tree)]


def dryrun_card_case(name: str, cfg, shape, make, step, smi: str, **kw) -> None:
    """Phase 22: the dry-run of one step on a (1, 1) mesh against the card:
    ``make()`` builds the same arguments there, the rise in allocated
    memory must be the dry-run's argument bytes (DRY_ALLOC_SLACK a leaf);
    ``step``, where given, runs on them and its outputs must have the
    dry-run's shapes and dtypes (the trace at full depth)."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as LM

    meta_mesh = LM.make_host_mesh((1, 1), device="meta")
    tr = DR.trace(cfg, meta_mesh, shape, full_depth=step is not None, **kw)
    meta_args = DR.build(cfg, meta_mesh, shape, **kw)[1]
    free_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    req0 = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    args = make(meta_args)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    requested = torch.cuda.memory_stats().get("requested_bytes.all.current", 0) - req0
    n_leaves = len(leaf_list(meta_args))
    same_args = leaf_list(args) == leaf_list(meta_args)
    ok_bytes = abs(rise - tr.arg_bytes) <= DRY_ALLOC_SLACK * n_leaves
    line = (f"{name}: dry-run argument bytes {tr.arg_bytes}, allocated on the card {rise} "
            f"(requested {requested}; {n_leaves} leaves, tol {DRY_ALLOC_SLACK} a leaf): "
            f"{ok_bytes}; arguments' shapes and dtypes as the dry-run's {same_args}")
    if step is not None:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        same_out = leaf_list(out) == leaf_list(tr.outputs)
        line += (f"; step {wall * 1e3:.2f} ms, outputs ({len(leaf_list(out))} leaves) as the "
                 f"dry-run's {same_out}; step peak {peak} bytes ({peak / 2**30:.3f} GiB) beside "
                 f"{tr.arg_bytes} argument bytes ({tr.arg_bytes / 2**30:.3f} GiB)")
        if not same_out:
            fail(f"{name}: outputs {leaf_list(out)[:4]} vs dry-run {leaf_list(tr.outputs)[:4]}")
        del out
    phase("dryrun", line + f"; {smi}")
    if not (ok_bytes and same_args):
        fail(f"{name}: card {rise} bytes vs dry-run {tr.arg_bytes}, arguments match {same_args}")
    del args
    free_card()


def dryrun_card_check(dev, smi: str) -> None:
    """Phase 22: llama3.2-1b at full width, the dry-run held to the card."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import shapes as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_map

    cfg = cfgbase.get("llama3.2-1b")
    rng = np.random.default_rng(3)

    def params():
        return TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(device=dev,
                                                                             dtype=torch.int32)

    # Every block a multiple of 512 bytes: no block keeps an unsplit tail of
    # its segment, which the large pool's default would count as allocated.
    settings = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
                or torch.cuda.memory._set_allocator_settings)
    settings("expandable_segments:True")
    try:
        dryrun_card_case(
            f"decode, batch {PIPE_BATCH}, cache {PIPE_CACHE}", cfg,
            SH.InputShape("decode_card", PIPE_CACHE, PIPE_BATCH, "decode"),
            lambda _m: (params(), ints(PIPE_BATCH),
                        TF.init_cache(cfg, PIPE_BATCH, PIPE_CACHE, device=dev)),
            ST.build_serve_step(cfg), smi)
        b, s = DRY_PREFILL
        dryrun_card_case(
            f"prefill, {b} x {s}", cfg, SH.InputShape("prefill_card", s, b, "prefill"),
            lambda _m: (params(), {"tokens": ints((b, s))}), ST.build_prefill_step(cfg), smi)
        n = 2
        dryrun_card_case(
            f"train, {n} members, AdamW, {PIPE_TRAIN_ROWS} x {PIPE_TRAIN_SEQ} tokens a member "
            "(arguments only)", cfg,
            SH.InputShape("train_card", PIPE_TRAIN_SEQ, n * PIPE_TRAIN_ROWS, "train"),
            lambda m: tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=dev), m),
            None, smi, num_nodes=n, microbatches=1)
    finally:
        settings("expandable_segments:False")


def paper_sweep(kind: str, smi: str) -> None:
    """Phase 23: the paper preset through run_sweep on the card, its
    qualitative checks held to the reference's."""
    from repro_torch.experiments import analysis, presets, runner
    from repro_torch.experiments.store import ResultsStore

    specs = presets.get_preset("paper")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "paper.jsonl")
        t0 = time.perf_counter()
        summary = runner.run_sweep(specs, path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        store = ResultsStore(path)
        finals = store.finals()
        if summary["failed"] or len(finals) != len(specs):
            fail(f"paper sweep: failed {summary['failed']}, {len(finals)} of {len(specs)} finished")
        devices = {end["final"]["device"] for end in finals.values()}
        if devices != {kind}:
            fail(f"paper sweep ran on {devices}")
        checks = analysis.qualitative_checks(analysis.summarize(store))
    got = {k: checks.get(k) for k in PAPER_REF_CHECKS}
    rounds = sum(sp.rounds for sp in specs)
    phase("paper", f"paper preset: {len(specs)} runs, {rounds} rounds (N=100, dense) in "
                   f"{wall:.2f} s, {rounds / wall:.3f} rounds/s (data and set-up included); "
                   f"checks {json.dumps(got)}; the reference's (commit 2164295, CPU) "
                   f"{json.dumps(PAPER_REF_CHECKS)}; {smi}")
    if got != PAPER_REF_CHECKS:
        fail(f"paper checks {got} differ from the reference's {PAPER_REF_CHECKS}")


def topology_study(smi: str) -> None:
    """Phase 23: the paper's grid (examples/torch_topology_study.py) on the
    card: every run's line, Table 1 and both claims lines printed; each
    record's accuracies finite in [0, 1], Table 1's confusion rows summing
    to 1 over the kept classes 0-7."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_topology_study.py")],
                         capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    runs = [re.match(r"\[(\S+)\] final mean acc", line) for line in lines]
    names = [m.group(1) for m in runs if m]
    shown = [line for line in lines if re.match(r"\[\S+\] (final mean acc|Table 1)", line)
             or line.startswith(("(i/ii)", "(iv)"))]
    for line in shown:
        phase("study", line)
    claims = sum(line.startswith(("(i/ii)", "(iv)")) for line in lines)
    if res.returncode != 0 or len(names) != STUDY_RUNS or claims != 2 or "on cuda" not in res.stdout:
        fail(f"topology study exited {res.returncode} with {len(names)} runs, {claims} claims "
             f"lines:\n{res.stdout[-1500:]}\n{res.stderr[-1500:]}")
    results = ROOT / "results" / "paper_torch"
    for name in names:
        rec = json.loads((results / f"{name}.json").read_text())
        accs = [row["acc"] for row in rec["rows"]] + [rec["final_mean_acc"]]
        if not (all(0.0 <= a <= 1.0 for a in accs) and math.isfinite(rec["spectral_gap"])):
            fail(f"topology study {name}: accuracy outside [0, 1] or gap {rec['spectral_gap']}")
        if name.startswith("sbm"):
            cm = np.array(json.loads((results / f"{name}_table1.json").read_text())["confusion"])
            if not np.allclose(cm.sum(axis=-1)[:, :8], 1.0, rtol=0, atol=1e-5):
                fail(f"topology study {name}: Table 1's rows do not sum to 1")
    phase("study", f"{len(names)} runs (N=50, 25 rounds) on the card in {wall:.2f} s (process "
                   f"start and data included); records finite, Table 1 rows sum to 1; {smi}")


def examples_on_card(smi: str) -> None:
    """Phase 23: the port's examples at their smallest sizes on the card,
    all three at once."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [(script, marker, subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for script, args, marker in EXAMPLE_RUNS]
    results = []
    try:
        for script, marker, p in procs:
            out, err = p.communicate(timeout=600)
            results.append((script, marker, p.returncode, out, err))
    finally:
        for _s, _m, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for script, marker, rc, out, err in results:
        lines = out.strip().splitlines()
        phase("examples", f"{script}: exit {rc}; {lines[-1] if lines else ''}")
        if rc != 0 or marker not in out or "cuda" not in out:
            fail(f"{script} exited {rc}:\n{out[-1500:]}\n{err[-1500:]}")
    phase("examples", f"3 examples on the card in {time.perf_counter() - t0:.2f} s; {smi}")


def route_cli(smi: str) -> None:
    """Phase 18: the serve-eval CLI with its defaults, on the card."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.serve_eval"], capture_output=True,
        text=True, timeout=600, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    wall = time.perf_counter() - t0
    try:
        summary = json.loads(res.stdout)
    except json.JSONDecodeError:
        fail(f"serve_eval exited {res.returncode} without its summary:\n{res.stderr[-3000:]}")
    if res.returncode not in (0, 1) or summary["device"] != torch.cuda.get_device_name(0):
        fail(f"serve_eval exited {res.returncode} on {summary.get('device')}")
    phase("route", f"serve_eval (star:n=6, 60 rounds, reduced llama3.2-1b) in {wall:.2f} s: "
                   f"router_beats_round_robin {summary['checks']['router_beats_round_robin']}, "
                   f"serve_acc {json.dumps(summary['serve_acc'])}, hub_share_foreign "
                   f"{summary['hub_share_foreign']:.4f}, g2_token_spread "
                   f"{summary['g2_token_spread']:.6f}; exit {res.returncode}; {smi}")


if __name__ == "__main__":
    sys.exit(main())
