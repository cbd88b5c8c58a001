"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seeds N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's paths, each kernel held against its plain PyTorch
version on the card first:

1. The sweep path: ``event_step`` at the mega bucket's shapes, then
   ``run_cells_scan(metrics_only=True)`` over the mega grid's axes (5
   policies x {2, 4} nodes x 8 cores x intensities 10-30, bursts sized for
   16 cores).  The mega grid has 2,000 seeds; the default of 40 seeds
   (2,000 cells) is a cut of it, and ``--seeds`` raises it.
2. The serving path at the full width of qwen3_1_7b: ``decode_attention``
   (split over the cache and merged, flash-decoding) and ``flash_attention``
   (bfloat16 on the tensor cores, float32 on the CUDA cores) at the
   decode_32k and prefill widths, each timed case with its achieved rate
   and share of its bound; the model
   in float32, kernels against plain versions end to end; then the serving
   engine in bfloat16 (two endpoints sharing one copy of the weights,
   estimator warm-up, a burst of 12 calls, policy fc, every decode step a
   replay of its lane's CUDA graph: the replayed logits against the eager
   step's, the launches as replays x the graph's captured launches, the
   step's card time split by ``torch.profiler`` into the kernels, the
   matrix products and other ops), and one 2,048-token prefill with 16
   decode steps.
3. The serving path at the full widths of recurrentgemma_9b (RG-LRU,
   RG-LRU, MQA attention with window 2,048, head_dim 256; 38 layers) and
   rwkv6_3b (32 RWKV-6 layers, 40 heads of 64): ``rglru_scan`` and
   ``rwkv6_scan`` at the prefill width (S = 4,096) and at S = 1 (card
   time by CUDA-graph replay beside the call time), at B = 2, at widths
   whose rows are not 16-byte aligned (RG-LRU 700 and 1), float32 at
   S = 4,096, and with RWKV-6 decays from 0 to 1 at the chunk's edges;
   the attention kernels at recurrentgemma's width; each model in
   float32, a 512-token prefill and 8 decode steps, kernels against plain
   versions (rwkv6_3b also against its scan in float64); each served in
   bfloat16 as in 2; and for each, one 4,096-token bf16 prefill with 16
   decode steps (recurrentgemma's wraps its window-2,048 ring), kernels
   against plain versions, one kernel at a time and float32; rwkv6_3b's
   logits are gated on its first layer alone (RWKV6_GATED_LAYERS) at
   RWKV6_GATED_S tokens instead.

4. The frozen-priority paths (single-node and push cells) through
   ``event_step``'s freeze kernel: the kernel against its plain version,
   bit for bit, on Table 3's largest single-node buckets (10 cores at
   intensity 120, FC and SEPT), on push FC at the mega shape (4 x 8 cores,
   bursts for 16 cores; least-loaded and home), on Fig 6's fleet (4 x 18
   cores, a 72-core burst; home) and on one push cell of 16 x 18 cores
   (the wide path); then ``run_cells_scan(metrics_only=True)`` over
   Table 3's ours grid at 10 cores (5 policies at intensities 30 / 60 /
   120; 48 seeds, 720 cells; its 20-core row is outside the warm regime
   the scan models) and over
   the mega grid's axes under push (both balancers, 20 seeds, 2,000
   cells), each with a sample of rows recomputed through the plain
   version.

   Then capacity dynamics and node speeds through ``event_step``'s float64
   pull kernel: the kernel against its plain version, bit for bit (rows
   and summary), on a frontier bucket (FC, 2-5 nodes of 8 cores
   autoscaling to 7 with a 10 s provision delay, a 40-core burst at
   intensity 40), the straggler grid's heavy bucket (4 x 8 cores, a
   32-core burst at intensity 96, node 0 2-8x slow), a failure + speed
   bucket (3 x 6 cores, node 0 killed at 8 s and 5x slow) and an
   autoscaled bucket past 32 nodes (34 single-core nodes growing to 40,
   node 3 killed at 5 s; FIFO, EECT and RECT: the wide path, whose
   dispatch reads group summaries of the queued heads); then
   ``run_cells_scan(metrics_only=True)`` over the autoscaler frontier
   (benchmarks/engine_bench.py::frontier_spec, 80 cells), its 40-seed cut
   (640 cells) and the straggler grid's pull half (75 cells), with a
   sample of rows recomputed through the plain version, and the frontier's
   claim: the best autoscaled configuration at N nodes against the static
   fleet at N + 1.

   Then workloads and cold starts: the float64 pull kernel against its
   plain version, bit for bit (rows, cold starts, evictions, each call's
   cold-start flag), on the cold matrix's pull buckets at intensity 96
   (FC) and 140 (SEPT; n_b 8,192); then ``run_cells_scan(metrics_only=
   True)`` over the cold matrix's pull half (benchmarks/engine_bench.py::
   matrix_specs, 30 cells: no warm-up, every miss a prewarmed container),
   Fig 5 (benchmarks/fig5_fairness.py: SEPT and FC on the fairness burst,
   10 cells with the per-function columns) and its 40-seed cut (80 cells),
   and the arrival-stress grid (examples/sweep_grid.py::build_spec: 270
   single-node cells under uniform, Poisson and MMPP arrivals), each with
   a sample of rows recomputed through the plain version, and Fig 5's
   per-function stretches beside the paper's.

   Then cold starts, node speeds and capacity dynamics on push and
   single-node cells through ``event_step``'s float64 frozen-priority
   kernel: the kernel against its plain version, bit for bit (rows, calls
   lost and done, nodes provisioned, cold starts, evictions, each call's
   cold-start flag), on the cold matrix's push buckets (FC and SEPT, 4 x 8
   cores, least-loaded, a 32-core burst at intensity 18, 5 cells each),
   the straggler grid's slowed push bucket (home balancer, node 0 2-8x
   slow, 20 cells), the steal matrix's cells without hedging (FC and SEPT
   on 3 x 6 cores, node 0 killed at 8 s and 5x slow, the autoscaler up to
   5 nodes, intensities 16 and 25) and cold single-node cells (FC and SEPT
   at 10 cores, intensity 60); then ``run_cells_scan(metrics_only=True)``
   over the cold matrix's push half (10 cells) and the straggler grid's
   unhedged push half (25 cells: its 5 healthy cells go to the float32
   freeze kernel), every row held to the plain version's.

   Then straggler hedging (steal and duplicate) through the float64
   frozen-priority kernel's hedged instantiations: the kernel against its
   plain version, bit for bit (rows, backups, steals, calls lost and done,
   attempts, steps taken), on the straggler grid's hedged push bucket
   (home balancer, node 0 2-8x slow, hedging at 3x the estimate, 20
   cells), the steal matrix's cells with a kill and the autoscaler (FC),
   the dup matrix's push cells at intensity 16 (4 copies a call), a cold
   bucket with node speeds, one node (steals go back to it) and 3 x 24
   cores (the wide path); then ``run_cells_scan(metrics_only=True)`` over
   the whole straggler grid (120 cells: 75 pull, 25 unhedged and 20
   hedged push), the steal matrix (32 cells) and the dup matrix (24 cells;
   its pull half a no-op of hedging), each checked cell's row held to the
   plain version's, and the straggler grid's claim: how much of the p95
   that node 0's slowdown costs the push model hedging recovers.

   Then request resilience (timeouts, retries with backoff, admission
   shedding) through the float64 frozen-priority kernel's resilience
   instantiations: the kernel against its plain version, bit for bit
   (rows, timeouts, sheds, retries, wasted seconds, calls resolved, steps
   taken, each call's failure flag, cause and submissions), on the retry
   storm's bucket (benchmarks/engine_bench.py::storm_rows: a ramp burst
   for 8 cores at intensity 14, 6x over [T/3, T/2), on 2 x 4 push
   least-loaded SEPT under its six client behaviours, 2 seeds), FC with
   backoff retries and shedding at intensity 40, the home balancer with
   immediate retries, an absolute timeout, one node and 3 x 24 cores (the
   wide path); then the storm's 60 cells (10 seeds) through
   ``simulate_cluster_cells_scan`` as storm_rows calls it, with its
   hysteresis (windowed goodput after the burst against before it, naive
   retries against backoff with shedding), and the README's resilience
   grid (SEPT and FC on 2 x 4 push, timeout / retries / shedding each on
   or off, 5 seeds: 80 cells) through ``run_cells_scan(metrics_only=
   True)``, each with a sample recomputed through the plain version.

   Then the sweep runner (phase 3j): ``run_sweep`` over Fig 6's grid
   (benchmarks/fig6_multinode.py::spec, 5 seeds, ``backends=("scan",)``:
   every cell runs on the reference event loop in the process pool and
   is marked ``degraded``, as the routing puts them -- the stock baseline,
   and FC at 18 cores, outside the warm regime the scan models -- with
   each configuration's mean response beside the paper's), over the main
   path's 2,000 cells with a cross-check of 17 cell identities against the
   reference ``Cluster`` (its one breach, MEGA_XCHECK_BREACHES, a failed
   row as in the JAX package; every other row equal to phase 1's, a
   sample and the breached cell recomputed through the plain version on
   the CPU, cells/s beside phase 1's), and one cell of 68,431 calls
   (SEPT on 96 pull nodes of 12 cores) that ``run_cell`` replays through
   the chunked stream, its row equal to ``run_cells_scan``'s whole-burst
   row.

5. The other decoder-only families served at full width in bfloat16 as
   in 2: deepseek_7b, qwen2_5_14b, gemma3_27b (5 local : 1 global
   windowed attention, 62 layers), qwen2_moe_a2_7b (60 experts, top-4)
   and qwen2_vl_7b (M-RoPE), and llama4_scout_17b_a16e (16 experts,
   top-1) cut to the depth that leaves LLAMA4_FREE_GB of the card free;
   each with a PROMPT_S-token prefill and PROMPT_STEPS decode steps
   against the plain versions (qwen2_vl_7b from random embeds and 3D
   positions).

Any failure exits non-zero.  The last lines are the card's name and power
limit, one JSON object with each kernel's numbers, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import fastpath  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.cluster import ClusterDynamics  # noqa: E402
from repro_torch.core.planes import carry_layout, make_planes  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.workload import generate_trace_burst  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels.decode_attention import split_plan  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv6_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode_step, init, init_cache  # noqa: E402
from repro_torch.models import param_shapes, prefill  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.model import torch_dtype  # noqa: E402
from repro_torch.serving import Endpoint, ServingEngine  # noqa: E402

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_S = 67e12        # H100 SXM float32 rate outside the tensor cores
BF16_OPS_S = 989e12       # H100 SXM dense bf16 tensor-core rate
FP64_OPS_S = 34e12        # H100 SXM float64 rate outside the tensor cores
PEAK_OPS = {torch.float32: FP32_OPS_S, torch.bfloat16: BF16_OPS_S,
            torch.float64: FP64_OPS_S}
# attention kernel against its plain version: tests/test_kernels.py's
ATTN_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# model logits, kernels against plain versions, float32 end to end: the two
# attention versions differ by ~1e-6 and 28 layers carry that to the logits
LOGIT_TOL = 2e-3
# the same in bfloat16, relative to the largest |logit|: the bf16
# tolerance tests/test_torch_model.py holds the port to the JAX model with
BF16_LOGIT_RTOL = 5e-2
# rwkv6_scan against its plain version, relative and absolute (|kernel -
# plain| <= tol + tol |plain|): the sum over a head runs in another order
# (float32); bf16 outputs may round one ulp apart, tests/test_kernels.py's
# bf16 tolerance
RWKV6_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# a kernel run may lie at most this many times as far from a run of
# higher precision (float64 scan, float32 model) as the plain run does:
# farther is a fault, not rounding in another order
WITNESS_RATIO = 2.0
QWEN3_LAYERS = 28
# the kernel a decode step launches once for each layer of a kind
KIND_KERNEL = {"attn": "decode_attention", "rglru": "rglru_scan",
               "rwkv": "rwkv6_scan"}
# calls of a decode-step kernel captured in one CUDA graph for its card time
GRAPH_CALLS = 50
# each serving kernel's kernels in a torch.profiler trace, by a part of
# their names; the first is launched once a wrapper call at the serving
# shapes (one decode split, the direct scans), so its calls are counted
PROFILE_KERNELS = {
    "decode_attention": ("decode_attention_kernel", "decode_merge_kernel"),
    "flash_attention": ("flash_attention",),
    "rglru_scan": ("rglru_direct", "rglru_staged"),
    "rwkv6_scan": ("rwkv6_direct", "rwkv6_chunk_"),
}
# parts of the matrix library's kernel names (cuBLAS, cuBLASLt on Hopper)
MATMUL_KERNELS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")
# the decoder-only families served at full width beside qwen3_1_7b,
# recurrentgemma_9b and rwkv6_3b; llama4_scout_17b_a16e's 109B parameters
# do not fit one card, so it is cut to the depth that leaves
# LLAMA4_FREE_GB free
MORE_ARCHS = ("deepseek_7b", "qwen2_5_14b", "gemma3_27b", "qwen2_moe_a2_7b",
              "qwen2_vl_7b")
LLAMA4 = "llama4_scout_17b_a16e"
LLAMA4_FREE_GB = 10
# tokens of each family's bf16 prompt check, and its decode steps
PROMPT_S, PROMPT_STEPS = 256, 4
# models whose 4,096-token bf16 long prompt gates kernels against plain
# versions at BF16_LOGIT_RTOL.  Not rwkv6_3b: with its random weights the
# bf16 prefill is chaotic at that length (the plain bf16 run lies about
# the largest |logit| from the plain float32 run, as far as from any run
# that sums in another order), so the gate could pass only a kernel that
# sums in the plain version's own order; there the per-call float64 and
# the float32 witnesses decide (``long_prompt``)
LOGIT_GATED = {"recurrentgemma_9b"}
# rwkv6_3b's logits are gated where its plain bf16 run stays within
# BF16_LOGIT_RTOL of its plain float32 run on the card
# (tools/rwkv6_horizon.py): at no prompt length with all 32 layers (even one
# token lies ~1 of the largest |logit| away: the gap grows with depth, not
# length), and at every length up to 4,096 with its first layer.  So the
# gated run is rwkv6_3b cut to RWKV6_GATED_LAYERS at RWKV6_GATED_S tokens.
RWKV6_GATED_LAYERS = 1
RWKV6_GATED_S = 4096


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def mega_bucket(policy: str, n_cells: int, seed0: int = 0, nodes: int = 4,
                cores: int = 8):
    """Host inputs of a real mega-grid bucket: intensity 30 on 4 nodes x 8
    cores (or ``nodes`` x ``cores``), bursts sized for 16 cores (n_b =
    1024)."""
    cells = []
    for s in range(seed0, seed0 + n_cells):
        c = sweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=30, seed=s, workload_cores=16)
        reqs = sweep.make_workload(c)
        cells.append(fastpath._ScanCell(
            requests=reqs, feats=fastpath._arrival_features(reqs),
            cores=cores, nodes=nodes, policy=policy))
    keys = {c.bucket() for c in cells}
    if len(keys) != 1:
        raise AssertionError(f"cells span several bucket shapes: {keys}")
    (key,) = keys
    return key, cells, fastpath._fill_bucket(key, cells)


def bucket_tensors(key, host, dev, cells=None):
    """A filled bucket on the card, its carry planes and its static
    ``event_step`` arguments, as the bucket runner makes them (for the
    prepared ``cells``, whose step budget a hedged bucket takes)."""
    static = (fastpath._scan_static(key) if cells is None
              else fastpath._bucket_static(key, cells))
    inp = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    hedge = ({k: static[k] for k in ("hedge", "dup", "n_copies")}
             if static.get("hedge") else {})
    if static.get("res"):
        hedge["res"] = True
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"], freeze=static["freeze"],
                           fc_push=static["fc_push"],
                           fc_ring=static["fc_ring"], dyn=static["dyn"],
                           het=static["het"], cold=static["cold"], **hedge)
    return inp, clk, ctr, static


def time_graph(fn, reps: int, calls: int = 1) -> float:
    """Milliseconds per call of ``fn``, ``calls`` calls captured in one CUDA
    graph and replayed: the card's time without the host's launch gaps,
    which set ``time_call`` for a kernel of a few microseconds (and with
    ``calls`` > 1 the graph's own launch spread over its calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_call(graph.replay, reps) / calls


def time_call(fn, reps: int, warmup: bool = True) -> float:
    """Milliseconds per call by CUDA events, after one warm-up call (none
    without ``warmup``: a slow plain version timed on its only call)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def needed_bytes(cells, static: dict) -> int:
    """Bytes the scan of ``cells`` (a bucket of static arguments
    ``static``) must move, each read once and each write once, counted
    from each cell's own size rather than the bucket's padded one.  A cell
    of ``n`` calls reads its carry planes at its own widths (its nodes,
    cores and functions; under ``freeze`` its ``n + 1`` queue entries and,
    with ``fc_push``, rings of the entries its FC window needs), rows
    ``[:n+1]`` of t / fnid / p / cost (row ``n`` is the +inf tail and the
    no-op index), four coefficients, cores and nodes, and writes rows
    ``[:n]`` of the four outputs.  The pull kernel also reads the ``n``
    queue entries of ``fn_ev``, but not the FC counts ``cumf`` (it counts
    the FC window from t and fnid); the freeze kernel reads the route, and
    single-node FC's counts and the home route's start nodes where the
    cell reads them."""
    freeze, fc_push = static["freeze"], static["fc_push"]
    total = 0
    for c in cells:
        n = len(c.feats.t)
        lay = carry_layout(
            n_nodes=c.nodes, n_slots=c.cores, window=static["window"],
            n_fns=len(c.feats.fns), freeze=freeze, fc_push=fc_push,
            n1=n + 1, fc_ring=int(c.feats.count.max()) if fc_push else 1)
        if freeze:
            rows = n * ((c.policy == "fc" and not fc_push)
                        + (c.lb == "home" and c.assignment == "push"))
            scalars = 3
        else:
            rows, scalars = n, 2
        total += 4 * (lay.f_len + lay.i_len + 4 * (n + 1) + rows + 4
                      + scalars + 4 * n)
    return total


def check_kernel(policy: str, n_cells: int, dev, timed: bool,
                 tile: bool = True, **shape) -> dict:
    """Kernel against the plain version on the card: rows [:n_b] of all
    four outputs must be bit-identical.  ``shape``: ``nodes`` / ``cores``
    of the bucket (``mega_bucket``).  ``tile``: when timed, also time the
    bucket tiled to 16 times its cells."""
    key, cells, host = mega_bucket(policy, n_cells, **shape)
    inp, clk, ctr, static = bucket_tensors(key, host, dev)
    n_b = key[1]
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = ops.KERNEL_LAUNCHES
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if ops.KERNEL_LAUNCHES != k0 + 1:
        raise AssertionError("event_step on CUDA tensors did not launch the "
                             "kernel")
    err = 0.0
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        a, b = a[:, :n_b], b[:, :n_b]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"event_step {name} differs from the plain "
                                 f"version ({policy}) at {bad}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    n_real = [len(c.feats.t) for c in cells]
    fin = got[1][:len(cells)].cpu().numpy()
    for b, n in enumerate(n_real):
        if not (np.isfinite(fin[b, :n]).all() and (fin[b, :n] > 0).all()):
            raise AssertionError(f"cell {b} has unfinished requests")
    out = {"policy": policy, "cells": len(cells), "bsz": int(clk.shape[0]),
           "n_b": n_b, "max_abs_err": err,
           "plan": ops.event_step_plan(
               n1=n_b + 1, n_nodes=static["n_nodes"],
               n_slots=static["n_slots"], n_fns=key[4],
               window=static["window"])}
    if timed:
        out["ms"] = time_call(lambda: ops.event_step(
            clk, ctr, inp, **static), reps=20)
        # one event a step: the longest cell takes 2 n steps
        steps = 2 * max(n_real)
        out["ns_per_step"] = out["ms"] * 1e6 / steps
        out["plain_ms"] = plain_ms       # the comparison run
        moved = needed_bytes(cells, static)
        # floating-point operations this data needs: 2 n events per cell;
        # per event a ring update (2) and the dispatch (3), and per queued
        # function its estimate and priority (6, 9 with FC counts)
        per_fn = 9 if static["use_fc"] else 6
        ops_n = sum(2 * n * (5 + len(c.feats.fns) * per_fn)
                    for n, c in zip(n_real, cells))
        if tile:
            # occupancy: the same bucket tiled to 4096 cells, enough
            # one-warp blocks to fill every SM
            wide = {k: v.repeat(16, *([1] * (v.dim() - 1)))
                    for k, v in inp.items()}
            wclk, wctr = clk.repeat(16, 1), ctr.repeat(16, 1)
            out["ms_4096"] = time_call(lambda: ops.event_step(
                wclk, wctr, wide, **static), reps=5)
            out["ns_per_step_4096"] = out["ms_4096"] * 1e6 / steps
        out["bytes"] = moved
        out["operations"] = ops_n
        out["bound_ms"], out["bound_by"] = bound(moved, ops_n, torch.float32)
        if tile:
            out["bound_ms_4096"] = 16 * out["bound_ms"]
    return out


def main_sweep(seeds: int, dev):
    """The sweep's main path: ``run_cells_scan(metrics_only=True)`` over the
    mega grid's axes cut to ``seeds`` seeds, the event_step counts set to 0
    just before it and read just after.  Returns (cells, rows, wall s,
    timings, kernel launches, plain launches)."""
    spec = sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           nodes=(2, 4), cores=(8,),
                           intensities=(10, 15, 20, 25, 30),
                           seeds=seeds, workload_cores=16)
    cells = spec.cells()
    timings: dict = {}
    ops.KERNEL_LAUNCHES = 0
    ops.REF_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (cells, rows, wall, timings, ops.KERNEL_LAUNCHES,
            ops.REF_LAUNCHES)


def scan_cell(c) -> "fastpath._ScanCell":
    """The bucket runner's prepared cell of a SweepCell: a single-node cell
    at one node without dynamics or speeds, else a pull or push cluster
    cell with its dynamics, speeds and warm or cold start."""
    reqs = sweep.make_workload(c)
    # hedging and resilience only where the cell has them
    # (tools/scan_bench.py runs this on trees from before them)
    kw = ({"hedging": sweep._cell_hedging(c)}
          if getattr(c, "hedge_multiple", None) is not None else {})
    if any(getattr(c, f, None) is not None for f in (
            "timeout_multiple", "retry_attempts", "shed_threshold")):
        kw["resilience"] = sweep._cell_resilience(c)
    return fastpath._ScanCell(
        requests=reqs, feats=fastpath._arrival_features(reqs),
        cores=c.cores, nodes=c.nodes, policy=c.policy,
        assignment=c.assignment if sweep._cluster_shaped(c) else "single",
        lb=c.lb, dynamics=sweep._cell_dynamics(c),
        profile=sweep._cell_profile(c), warm=c.warm, **kw)


def plain_rows(cells, dev) -> list[dict]:
    """Metrics rows of ``cells`` through the plain version on the card,
    composed from the bucket runner's own steps (bucket, fill, planes, scan
    with ``force="ref"``, metrics fold)."""
    groups: dict[tuple, list[int]] = {}
    prepared = []
    for i, c in enumerate(cells):
        sc = scan_cell(c)
        prepared.append(sc)
        groups.setdefault(sc.bucket(), []).append(i)
    rows: list = [None] * len(cells)
    for key, idxs in groups.items():
        part = [prepared[i] for i in idxs]
        out = fastpath._run_scan_bucket(key, part, dev, force="ref")
        for b, i in enumerate(idxs):
            mo = fastpath._cell_scan_metrics(part[b], out[b][1], {},
                                             out[b][4])
            rows[i] = sweep._metrics_from_scan(cells[i], mo)
    return rows


def burst_calls(cells) -> list[int]:
    """Each cell's call count, from its generated workload (one a workload
    key): a sweep row's ``n`` must equal it, every call done."""
    sizes: dict = {}
    for c in cells:
        key = sweep._workload_key(c)
        if key not in sizes:
            sizes[key] = len(sweep.make_workload(c))
    return [sizes[sweep._workload_key(c)] for c in cells]

def freeze_bucket(specs, n_b: int | None = None):
    """Host inputs of a frozen-priority bucket, one cell for each ``(policy,
    nodes, cores, intensity, seed, lb, burst cores)`` of ``specs`` (``lb``
    None: a single-node cell), under the widest key of its cells (or rows
    ``n_b`` long)."""
    cells = []
    for policy, nodes, cores, intensity, seed, lb, wcores in specs:
        c = sweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed,
                            workload_cores=wcores,
                            assignment="push" if lb else "pull",
                            lb=lb or "least_loaded")
        cells.append(scan_cell(c))
    keys = {c.bucket() for c in cells}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    if n_b is not None:
        key = key[:1] + (n_b,) + key[2:]
    return key, cells, fastpath._fill_bucket(key, cells)


def check_freeze(case: str, specs, dev, n_b: int | None = None) -> dict:
    """The freeze kernel against its plain version on the card: rows
    [:n_b] of start, finish, prio and node bit-identical; then its time,
    ns an event step, the plain version's time (the comparison run) and
    the bound of this bucket's work."""
    key, cells, host = freeze_bucket(specs, n_b)
    inp, clk, ctr, static = bucket_tensors(key, host, dev)
    if not static["freeze"]:
        raise AssertionError(f"{case}: not a frozen-priority bucket")
    n1 = key[1] + 1
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = ops.FREEZE_LAUNCHES
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if ops.FREEZE_LAUNCHES != k0 + 1:
        raise AssertionError(f"{case}: event_step did not launch the freeze "
                             "kernel")
    err = 0.0
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        a, b = a[:, :n1 - 1], b[:, :n1 - 1]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"freeze event_step {name} differs from the "
                                 f"plain version ({case}) at {bad}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    n_real = [len(c.feats.t) for c in cells]
    fin = got[1][:len(cells)].cpu().numpy()
    for b, n in enumerate(n_real):
        if not (np.isfinite(fin[b, :n]).all() and (fin[b, :n] > 0).all()):
            raise AssertionError(f"{case}: cell {b} has unfinished calls")
    out = {"case": case, "cells": len(cells), "bsz": int(clk.shape[0]),
           "n_b": key[1], "nodes": key[2], "slots": key[3],
           "fc_push": static["fc_push"], "fc_ring": static["fc_ring"],
           "max_abs_err": err,
           "plan": ops.event_step_plan(
               n1=n1, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
               n_fns=key[4], window=static["window"], freeze=True,
               fc_push=static["fc_push"], fc_ring=static["fc_ring"])}
    out["ms"] = time_call(lambda: ops.event_step(clk, ctr, inp, **static),
                          reps=10)
    out["plain_ms"] = plain_ms
    steps = 2 * max(n_real)          # one event a step
    out["ns_per_step"] = out["ms"] * 1e6 / steps
    moved = needed_bytes(cells, static)
    # floating-point operations this data needs, per call: its completion's
    # ring update (2), its priority (7) and estimate (1), and its dispatch
    # (2)
    ops_n = sum(12 * n for n in n_real)
    out["bytes"], out["operations"] = moved, ops_n
    out["bound_ms"], out["bound_by"] = bound(moved, ops_n, torch.float32)
    return out


def freeze_path(name: str, cells, dev) -> tuple[dict, list]:
    """One frozen-priority main path: ``run_cells_scan(metrics_only=True)``
    over ``cells``, every count set to 0 just before it and read just
    after; its rows checked (burst sizes, finite metrics) and a sample
    recomputed through the plain version.  Returns its numbers and
    rows."""
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    fz = counts["event_step_freeze"]
    if fz["kernel"] == 0 or fz["plain"] != 0 or any(
            v["kernel"] or v["plain"] for k, v in counts.items()
            if k != "event_step_freeze"):
        raise AssertionError(f"{name} launches: {counts}")
    for c, r, want in zip(cells, rows, burst_calls(cells)):
        if r["n"] != want:
            raise AssertionError(f"{c.label()} seed {c.seed}: n={r['n']}, "
                                 f"burst has {want}")
        for k in ("R_avg", "R_p95", "max_c"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{c.label()} seed {c.seed}: {k}="
                                     f"{r[k]}")
    # stratified sample: every cell identity but its seed once, the seed
    # rotating over the strata
    firsts: dict = {}
    for i, c in enumerate(cells):
        firsts.setdefault(dataclasses.replace(c, seed=0), []).append(i)
    sample = [idx[k % len(idx)] for k, idx in enumerate(firsts.values())]
    want = plain_rows([cells[i] for i in sample], dev)
    for i, w in zip(sample, want):
        if rows[i] != w:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    out = {"cells": len(cells), "wall_s": wall,
           "cells_per_s": len(cells) / wall, **timings,
           "other_s": wall - sum(timings.values()),
           "device_share": timings["device_s"] / wall,
           "launches": fz["kernel"], "plain_launches": fz["plain"],
           "sample": len(sample)}
    print(f"{name}: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); kernel launches {fz['kernel']}, plain "
          f"launches {fz['plain']}; sample: {len(sample)} cells recomputed "
          "through the plain version on the card, rows equal", flush=True)
    return out, rows


def table3_cells(seeds: int) -> list:
    """Table 3's ours grid at 10 cores (benchmarks/table3_response_stretch.
    py): the five policies at intensities 30 / 60 / 120 on one node.  Its
    20-core row is outside the always-warm regime (20 warm containers of
    each of the 11 functions do not fit the node's 32 GB: ``scan_eligible``
    is false, in the JAX package too), so it stays on the event loop."""
    return sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           cores=(10,), intensities=(30, 60, 120),
                           seeds=seeds).cells()


def push_cells(seeds: int) -> list:
    """The mega grid's axes under push assignment with both balancers:
    5 policies x {2, 4} nodes x 8 cores x intensities 10-30 x {least-loaded,
    home}, bursts for 16 cores."""
    return sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           assignments=("push",),
                           lbs=("least_loaded", "home"), nodes=(2, 4),
                           cores=(8,), intensities=(10, 15, 20, 25, 30),
                           seeds=seeds, workload_cores=16).cells()


def frontier_cells(seeds: int) -> list:
    """The autoscaler frontier grid (benchmarks/engine_bench.py::
    frontier_spec): FC on 2-5 initial nodes of 8 cores, a 40-core burst at
    intensity 40, static or autoscaled (provision delay 10 / 30 / 60 s,
    scale-up at 2 calls a slot, up to 7 nodes); 80 cells at its 5 seeds."""
    return sweep.SweepSpec(policies=("fc",), nodes=(2, 3, 4, 5), cores=(8,),
                           intensities=(40,), autoscale=(False, True),
                           provision_delays=(10.0, 30.0, 60.0),
                           scale_ups=(2.0,), max_nodes=7, seeds=seeds,
                           workload_cores=40).cells()


def straggler_pull_cells() -> list:
    """The straggler grid's pull half (benchmarks/engine_bench.py::
    straggler_spec, its unhedged pull cells): FC on 4 x 8 cores, a 32-core
    burst at intensities 18 / 45 / 96, node 0 healthy or 2 / 4 / 6 / 8x
    slow from 2 s to 300 s, 5 seeds: 75 cells."""
    degrades = (None,) + tuple(((0, 2.0, 300.0, s),)
                               for s in (2.0, 4.0, 6.0, 8.0))
    return sweep.SweepSpec(policies=("fc",), nodes=(4,), cores=(8,),
                           intensities=(18, 45, 96), degrades=degrades,
                           seeds=5, workload_cores=32).cells()


def fig5_cells(seeds: int) -> list:
    """Fig 5 (benchmarks/fig5_fairness.py): SEPT and FC on one node of 10
    cores at intensity 90, the fairness burst (990 calls, 10 of them
    dna-visualisation), with the per-function columns of dna-visualisation
    and graph-bfs; 5 seeds in the benchmark."""
    return sweep.SweepSpec(policies=("sept", "fc"), arrivals=("fairness",),
                           cores=(10,), intensities=(90,), seeds=seeds,
                           per_function=("dna-visualisation",
                                         "graph-bfs")).cells()


def arrival_cells() -> list:
    """The arrival-stress grid (examples/sweep_grid.py::build_spec): 5
    policies x intensities 30 / 60 / 90 x 5 and 10 cores x uniform,
    Poisson and MMPP arrivals x 3 seeds, one node: 270 cells."""
    return sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           intensities=(30, 60, 90), cores=(5, 10),
                           arrivals=("uniform", "poisson", "mmpp"),
                           seeds=3).cells()


def cold_pull_cells() -> list:
    """The cold matrix's pull half (benchmarks/engine_bench.py::
    matrix_specs, ``cold``): FC and SEPT on 4 x 8 cores, a 32-core burst
    at intensities 18 / 96 / 140, no warm-up (``warm=False``), 5 seeds: 30
    cells."""
    return sweep.SweepSpec(policies=("fc", "sept"), nodes=(4,), cores=(8,),
                           workload_cores=32, intensities=(18, 96, 140),
                           warm=False, seeds=5).cells()


def fig5_stretches(cells, rows) -> dict:
    """Fig 5's numbers from its rows: each policy's mean, over the seeds,
    of each function's mean stretch."""
    out: dict = {}
    for pol in ("sept", "fc"):
        for fn in ("dna-visualisation", "graph-bfs"):
            vals = [r[f"S_avg:{fn}"] for c, r in zip(cells, rows)
                    if c.policy == pol]
            out[f"{pol}:{fn}"] = float(np.mean(vals))
    return out


def frontier_claim(cells, rows) -> list[str]:
    """The lines benchmarks/engine_bench.py::frontier_rows prints from the
    frontier grid's rows: for each N, the best autoscaled configuration at
    N initial nodes (least mean R_p95 over the seeds) against the static
    fleet at N + 1, and the first N where it is no worse."""
    groups: dict = {}
    for c, r in zip(cells, rows):
        groups.setdefault((c.nodes, c.autoscale, c.provision_delay),
                          []).append(r["R_p95"])
    p95 = {k: float(np.mean(v)) for k, v in groups.items()}
    lines, claim = [], "no-frontier-point"
    for n in sorted({k[0] for k in p95}):
        auto = [(v, k[2]) for k, v in p95.items() if k[0] == n and k[1]]
        big = p95.get((n + 1, False, None))
        if not auto or big is None:
            continue
        v, pd = min(auto)
        lines.append(f"{n}n+auto(pd{pd:g}) p95={v:.2f} vs {n + 1}n static "
                     f"p95={big:.2f}")
        if v <= big and claim == "no-frontier-point":
            claim = (f"{n}n+auto(pd{pd:g}) p95={v:.2f} <= {n + 1}n static "
                     f"p95={big:.2f}")
    return lines + [f"claim: {claim}"]


def f64_needed_bytes(cells, static: dict, backups=None) -> int:
    """Bytes the float64 scan of ``cells`` must move, each read once and
    each write once, at each cell's own widths (its nodes -- with the
    autoscaler its node cap --, cores and functions; under ``freeze`` its
    ``n + 1`` queue entries and, with ``fc_push``, rings of the entries its
    FC window needs, and for a hedged cell the one entry each of its
    ``backups`` logs on the node it goes to): the carry planes (8-byte clocks, 4-byte counters),
    rows ``[:n+1]`` of t / p / cost (8 bytes) and fnid (4), five
    coefficients, cores and nodes; under pull the ``n`` queue entries of
    ``fn_ev``, under ``freeze`` the route and the static FC counts and the
    home route's start nodes where the cell reads them; with ``dyn`` each
    node's activation and kill time, five dynamics parameters, the node
    cap and call count; with ``het`` each node's speed and each episode;
    and the outputs: rows ``[:n]`` of start / finish / prio (8) and node
    (4), with ``dyn`` the summary (three counts, each node's activation
    time and dead flag), with ``cold`` each row's flag and two counts; with
    ``hedge`` the carry's hedge segments (under ``dup`` its copies' queue
    entries), three parameters, four counts and each row's attempts; with
    ``res`` the carry's res segment, twelve parameters, five counts, the
    wasted seconds and each row's failure flag, cause and submissions."""
    freeze, fc_push = static["freeze"], static["fc_push"]
    total = 0
    for i, c in enumerate(cells):
        n = len(c.feats.t)
        nodes = c.node_cap()
        ring = int(c.feats.count.max()) if fc_push else 1
        res = getattr(c, "res", False)
        lay = carry_layout(
            n_nodes=nodes, n_slots=c.cores, window=static["window"],
            n_fns=len(c.feats.fns), freeze=freeze, fc_push=fc_push,
            n1=n + 1, fc_ring=ring, dyn=static["dyn"], het=static["het"],
            cold=static["cold"], hedge=c.hedge, dup=c.dup,
            n_copies=c.n_copies, **({"res": True} if res else {}))
        if freeze:
            rows = (8 * n * (c.policy == "fc" and not fc_push)
                    + 4 * n * (c.lb == "home" and c.assignment == "push")
                    + 4)
        else:
            rows = 4 * n
        nbytes = (8 * lay.f_len + 4 * lay.i_len + 28 * (n + 1) + rows
                  + 40 + 8 + 28 * n)
        if static["dyn"]:
            nbytes += 16 * nodes + 40 + 8 + 12 + 12 * nodes
        if static["het"]:
            nbytes += 8 * nodes + 28 * len(c.profile.episodes)
        if static["cold"]:
            nbytes += 4 * n + 8
        if c.hedge:
            nbytes += 20 + 16 + 4 * n
            if fc_push:
                nbytes += 8 * int(backups[i])
        if res:
            nbytes += 96 + 28 + 12 * n
            if fc_push and backups is not None:
                # each retry admitted logs one entry more on its node
                nbytes += 8 * int(backups[i])
        total += nbytes
    return total


def check_f64(case: str, cells, dev) -> tuple[dict, dict]:
    """A float64 kernel against its plain version on the card -- the pull
    one (``dyn_kernel``) or, for single-node and push cells, the
    frozen-priority one (``freeze64_kernel``): rows [:n_b] of start,
    finish, prio and node and the summary (calls lost and done, nodes
    provisioned, activation times, dead flags; cold starts, evictions,
    each call's cold-start flag) bit-identical; then its time, ns an event
    step, the plain version's time (the comparison run), the plan and the
    bound of this bucket's work.  Also returns each cell's metrics row
    from the plain run, folded as the bucket runner folds it (a path's
    rows of these cells must equal them)."""
    prepared = [scan_cell(c) for c in cells]
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"{case}: cells of several feature sets")
    key = tuple(max(col) for col in zip(*keys))
    inp, clk, ctr, static = bucket_tensors(
        key, fastpath._fill_bucket(key, prepared), dev, prepared)
    hedge = static["hedge"]
    if not (static["dyn"] or static["het"] or static["cold"] or hedge):
        raise AssertionError(f"{case}: not a float64 bucket")
    freeze = static["freeze"]
    what, counter = (("hedge", "HEDGE_LAUNCHES") if hedge
                     else ("freeze64", "FREEZE64_LAUNCHES") if freeze
                     else ("dyn", "DYN_LAUNCHES"))
    n1 = key[1] + 1
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = getattr(ops, counter)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if getattr(ops, counter) != k0 + 1:
        raise AssertionError(f"{case}: event_step did not launch the {what} "
                             "kernel")
    err = 0.0
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        a, b = a[:, :n1 - 1], b[:, :n1 - 1]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what} event_step {name} differs from the "
                                 f"plain version ({case}) at {bad}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    if ref[4].keys() != got[4].keys():
        raise AssertionError(f"{case}: summaries of different keys")
    for k in ref[4]:
        if not torch.equal(ref[4][k], got[4][k]):
            raise AssertionError(f"{what} event_step summary {k} differs "
                                 f"from the plain version ({case})")
    nc = len(cells)
    n_real = [len(c.feats.t) for c in prepared]
    fin = got[1][:nc].cpu().numpy()
    for b, n in enumerate(n_real):
        if not (np.isfinite(fin[b, :n]).all() and (fin[b, :n] > 0).all()):
            raise AssertionError(f"{case}: cell {b} has unfinished calls")
    aux = {k: v.cpu().numpy() for k, v in ref[4].items()}
    if ((static["dyn"] or hedge)
            and (aux["ndone"][:nc] != n_real).any()):
        raise AssertionError(f"{case}: calls left unfinished")
    lost = aux["nfail"][:nc].tolist() if static["dyn"] else [0] * nc
    finish = ref[1].cpu().numpy()
    rows_plain = []
    for b, (c, sc) in enumerate(zip(cells, prepared)):
        extras = {}
        if static["dyn"]:
            extras.update(failures=int(aux["nfail"][b]),
                          nodes_used=int(aux["prov"][b]))
        if static["cold"]:
            extras.update(cold_starts=int(aux["ncold"][b]),
                          evictions=int(aux["nevt"][b]))
        if hedge:
            extras.update(backups=int(aux["nbk"][b]),
                          steals=int(aux["nstl"][b]))
        mo = fastpath._cell_scan_metrics(sc, finish[b], {}, extras)
        rows_plain.append(sweep._metrics_from_scan(c, mo))
    out = {"case": case, "cells": nc, "bsz": int(clk.shape[0]),
           "n_b": key[1], "nodes": key[2], "slots": key[3],
           "dyn": static["dyn"], "het": static["het"],
           "cold": static["cold"], "fc_push": static["fc_push"],
           "n_steps_budget": static["n_steps"], "max_abs_err": err,
           "failures": lost,
           "nodes_used": (aux["prov"][:nc].tolist() if static["dyn"]
                          else None),
           "cold_starts": (aux["ncold"][:nc].tolist() if static["cold"]
                           else None),
           "evictions": (int(aux["nevt"][:nc].sum()) if static["cold"]
                         else None),
           "backups": aux["nbk"][:nc].tolist() if hedge else None,
           "steals": aux["nstl"][:nc].tolist() if hedge else None,
           "attempts": int(aux["att"][:nc].sum()) if hedge else None,
           "steps": aux["stepc"][:nc].tolist() if hedge else None,
           "plan": ops.event_step_plan(
               n1=n1, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
               n_fns=key[4], window=static["window"], freeze=freeze,
               f64=True, fc_push=static["fc_push"],
               fc_ring=static["fc_ring"], dyn=static["dyn"],
               cold=static["cold"], hedge=hedge, dup=static["dup"],
               n_copies=static["n_copies"])}
    out["ms"] = time_call(lambda: ops.event_step(clk, ctr, inp, **static),
                          reps=10)
    out["plain_ms"] = plain_ms
    # the longest cell's events: its arrivals and completions, the
    # re-arrivals and re-dispatches of what the kills lost (2 each); with
    # hedging the kernel counts its steps (deadline fires included)
    steps = (max(out["steps"]) if hedge
             else max(2 * n + 2 * f for n, f in zip(n_real, lost)))
    out["ns_per_step"] = out["ms"] * 1e6 / steps
    moved = f64_needed_bytes(prepared, static,
                             aux["nbk"][:nc] if hedge else None)
    # float64 operations this data needs.  Pull: a completion's ring update
    # (3); a dispatch's priority over the cell's functions (5 each, 7 with
    # the enqueue clock, 9 with FC counts too) and its start and finish (2,
    # 6 with a speed, one more with the prewarm charge).  Freeze, a
    # dispatch: its estimate (1) and priority (6) at (re-)arrival, its
    # start and finish (2; 5 more with a speed: the slowdown, the speed and
    # the measured service; one more with the prewarm charge) and its
    # completion's ring update (2); with hedging the watch's arm at each
    # insertion (the controller's estimate, its floor, multiple and sum: 4)
    # and the controller ring's update at each completion (2), a backup an
    # insertion and a dispatch more
    if freeze:
        per = 11 + 5 * static["het"] + static["cold"] + 6 * hedge
        nbk = aux["nbk"][:nc].tolist() if hedge else [0] * nc
        ops_n = sum(per * (n + f + k)
                    for n, f, k in zip(n_real, lost, nbk))
    else:
        per_fn = 5 + 2 * static["dyn"] + 2 * static["use_fc"]
        ops_n = sum(3 * n + (n + f) * (len(c.feats.fns) * per_fn + 2
                                       + 4 * static["het"] + static["cold"])
                    for n, f, c in zip(n_real, lost, prepared))
    out["bytes"], out["operations"] = moved, ops_n
    out["bound_ms"], out["bound_by"] = bound(moved, ops_n, torch.float64)
    return out, dict(zip(cells, rows_plain))


def wide_dyn_cells() -> list:
    """Autoscaled pull cells past 32 nodes, a node killed mid-burst: the
    float64 pull kernel's wide path, under FIFO and EECT (the enqueue
    clock on every head) and RECT (the previous arrival)."""
    return [sweep.SweepCell(policy=p, nodes=34, cores=1, intensity=60,
                            seed=s, workload_cores=34, autoscale=True,
                            provision_delay=2.0, scale_up=0.5, max_nodes=40,
                            fail_spec=((3, 5.0),))
            for p in ("fifo", "eect", "rect") for s in range(2)]


def dyn_sample(cells) -> list:
    """A stratified sample of the cells the float64 kernel runs (those with
    dynamics or speeds; the static and healthy ones run the pull kernel,
    whose rows the main path samples): every identity but its seed once,
    the seed rotating over them."""
    firsts: dict = {}
    for c in cells:
        if sweep._cell_dynamics(c) or sweep._cell_profile(c):
            firsts.setdefault(dataclasses.replace(c, seed=0), []).append(c)
    return [cs[k % len(cs)] for k, cs in enumerate(firsts.values())]


def dyn_path(name: str, cells, dev, plain: dict | None = None) -> dict:
    """One capacity-dynamics main path: ``run_cells_scan(metrics_only=
    True)`` over ``cells``, every count set to 0 just before it and read
    just after (the float64 pull kernel launched, its plain version and
    every other kernel's plain version not); its rows checked (burst
    sizes, finite metrics; the runner holds every cell to all calls done)
    and held to ``plain``, the rows of a sample of its cells recomputed
    through the plain version (``check_f64``).  Returns its numbers and
    rows."""
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    dy = counts["event_step_dyn"]
    if (dy["kernel"] == 0 or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items()
                   if k not in ("event_step_dyn", "event_step"))):
        raise AssertionError(f"{name} launches: {counts}")
    for c, r, want in zip(cells, rows, burst_calls(cells)):
        if r["n"] != want:
            raise AssertionError(f"{c.label()} seed {c.seed}: n={r['n']}, "
                                 f"burst has {want}")
        for k in ("R_avg", "R_p95", "max_c"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{c.label()} seed {c.seed}: {k}="
                                     f"{r[k]}")
    sample = [i for i, c in enumerate(cells) if c in (plain or {})]
    for i in sample:
        if rows[i] != plain[cells[i]]:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    out = {"cells": len(cells), "wall_s": wall,
           "cells_per_s": len(cells) / wall, **timings,
           "other_s": wall - sum(timings.values()),
           "device_share": timings["device_s"] / wall,
           "launches": dy["kernel"], "plain_launches": dy["plain"],
           "pull_launches": counts["event_step"]["kernel"],
           "sample": len(sample),
           "failures": sum(r["failures"] for r in rows),
           "nodes_used_max": max(r["nodes_used"] for r in rows)}
    print(f"{name}: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); float64 pull kernel launches "
          f"{dy['kernel']}, plain launches {dy['plain']} (pull kernel "
          f"{out['pull_launches']})" + (
              f"; sample: {len(sample)} cells recomputed through the plain "
              "version on the card, rows equal" if sample else ""),
          flush=True)
    return out, rows


def workload_paths(dev, kern_fz: dict, kern_dy: dict) -> None:
    """Workloads and cold starts: the float64 pull kernel against its plain
    version on cold buckets (FC at v96, SEPT at v140), then the cold
    matrix's pull half, Fig 5, its 40-seed cut and the arrival-stress grid
    as main paths, Fig 5's stretches printed beside the paper's; their
    numbers go into the freeze and float64 kernels' rows ``kern_fz`` /
    ``kern_dy``.  The checks' cells and one cell of each policy at v18 are
    the cold grid's sample."""
    cold_cells = cold_pull_cells()
    cd, cold_plain = {}, {}
    for k, case, pol, v in (
            ("cold_96", "cold pull fc 4 x 8, v96 (32-core burst, n_b 4096)",
             "fc", 96),
            ("cold_140", "cold pull sept 4 x 8, v140 (32-core burst, n_b "
             "8192)", "sept", 140)):
        cd[k], rows_k = check_f64(case, [c for c in cold_cells
                                         if (c.policy, c.intensity)
                                         == (pol, v)], dev)
        cold_plain.update(rows_k)
        print("cold event_step vs plain: " + json.dumps(cd[k]), flush=True)
    low = [c for c in cold_cells if c.intensity == 18
           and (c.policy, c.seed) in (("fc", 0), ("sept", 1))]
    cold_plain.update(zip(low, plain_rows(low, dev)))
    cold, cold_rows = dyn_path("cold pull path", cold_cells, dev,
                               cold_plain)
    if not all(r["cold"] > 0 for r in cold_rows):
        raise AssertionError("a cold cell started no container cold")
    f5_cells, f5_40_cells = fig5_cells(5), fig5_cells(40)
    f5, f5_rows = freeze_path("Fig 5 path", f5_cells, dev)
    f5_40, f5_40_rows = freeze_path("Fig 5 40-seed path", f5_40_cells, dev)
    if [r for c, r in zip(f5_40_cells, f5_40_rows) if c.seed < 5] != f5_rows:
        raise AssertionError("the 40-seed cut's first 5 seeds differ from "
                             "Fig 5's rows")
    arrivals, _ = freeze_path("arrival-stress path", arrival_cells(), dev)
    for what, cs, rs in (("5 seeds", f5_cells, f5_rows),
                         ("40 seeds", f5_40_cells, f5_40_rows)):
        st = fig5_stretches(cs, rs)
        print(f"Fig 5 on the card ({what}): mean stretch of "
              f"dna-visualisation SEPT {st['sept:dna-visualisation']:.2f} "
              f"-> FC {st['fc:dna-visualisation']:.2f} (paper 5.3 -> 2.1), "
              f"of graph-bfs SEPT {st['sept:graph-bfs']:.2f} -> FC "
              f"{st['fc:graph-bfs']:.2f} (paper 22.2 -> 25.8)", flush=True)
    paths_fz = {"Fig 5 path": f5["launches"],
                "Fig 5 40-seed path": f5_40["launches"],
                "arrival-stress path": arrivals["launches"]}
    kern_fz["launches"] += sum(paths_fz.values())
    kern_fz["launches_by_path"].update(paths_fz)
    kern_fz.update({f"{k}_{f}": r[f] for k, r in (("fig5", f5),
                                                  ("fig5_80", f5_40),
                                                  ("arrivals", arrivals))
                    for f in ("cells_per_s", "device_share")})
    kern_dy["launches"] += cold["launches"]
    kern_dy["launches_by_path"]["cold pull path"] = cold["launches"]
    kern_dy["max_abs_err"] = max(kern_dy["max_abs_err"],
                                 *(r["max_abs_err"] for r in cd.values()))
    kern_dy["cases"].update({k: {f: r[f] for f in (
        "ms", "plain_ms", "bound_ms", "ns_per_step", "n_b", "bsz", "plan")}
        for k, r in cd.items()})
    kern_dy.update({f"cold_{f}": cold[f]
                    for f in ("cells_per_s", "device_share")})


def cold_push_cells() -> list:
    """The cold matrix's push half (benchmarks/engine_bench.py::
    matrix_specs, ``cold``, whose push cells run at intensity 18 only):
    FC and SEPT on 4 x 8 cores, least-loaded, a 32-core burst, no warm-up,
    5 seeds: 10 cells."""
    return sweep.SweepSpec(policies=("fc", "sept"), assignments=("push",),
                           nodes=(4,), cores=(8,), workload_cores=32,
                           intensities=(18,), warm=False, seeds=5).cells()


def straggler_push_cells() -> list:
    """The straggler grid's unhedged push half (benchmarks/engine_bench.
    py::straggler_spec, its unhedged push cells): FC on 4 x 8 cores under
    the home balancer, a 32-core burst at intensity 18 (STRAGGLER_V's
    claim), node 0 healthy or 2 / 4 / 6 / 8x slow from 2 s to 300 s, 5
    seeds: 25 cells, 20 of them slowed."""
    degrades = (None,) + tuple(((0, 2.0, 300.0, s),)
                               for s in (2.0, 4.0, 6.0, 8.0))
    return sweep.SweepSpec(policies=("fc",), assignments=("push",),
                           lbs=("home",), nodes=(4,), cores=(8,),
                           intensities=(18,), degrades=degrades, seeds=5,
                           workload_cores=32).cells()


def steal_cells(policy: str) -> list:
    """The steal matrix's cells (benchmarks/engine_bench.py::matrix_specs,
    ``steal``) without hedging: ``policy`` on 3 x 6 cores, least-loaded,
    node 0 5x slow, node 0 killed at 8 s (``rolling_restart(1, start=8.0)``
    ), the autoscaler (scale-up at 1 call a slot, a 2 s provision delay, up
    to 5 nodes), intensities 16 and 25, 2 seeds: 4 cells."""
    return sweep.SweepSpec(policies=(policy,), assignments=("push",),
                           nodes=(3,), cores=(6,), intensities=(16, 25),
                           degrades=(((0, 1.0, 300.0, 5.0),),),
                           fail_specs=(((0, 8.0),),), autoscale=(True,),
                           scale_ups=(1.0,), provision_delays=(2.0,),
                           max_nodes=5, seeds=2).cells()


def single_cold_cells() -> list:
    """Cold single-node cells: FC and SEPT on one node of 10 cores at
    intensity 60 (660 calls; ``_cold_regime_ok`` holds at any intensity
    there: 2 prewarms, 10 busy and 10 free containers of each of the 11
    functions and 2 in flight take 15.5 of the node's 32 GB), 4 seeds."""
    return sweep.SweepSpec(policies=("fc", "sept"), cores=(10,),
                           intensities=(60,), warm=False, seeds=4).cells()


def freeze64_path(name: str, cells, dev, plain: dict) -> tuple[dict, list]:
    """One float64 frozen-priority main path: ``run_cells_scan(
    metrics_only=True)`` over ``cells``, every count set to 0 just before it
    and read just after (the float64 frozen-priority kernel launched, the
    float32 freeze kernel for the path's static cells, no plain version);
    its rows checked (burst sizes, finite metrics; the runner holds every
    cell with dynamics to all calls done) and held to ``plain``, the rows
    of the cells the checks ran through the plain version, and its static
    cells' rows recomputed through the plain version.  Returns its numbers
    and rows."""
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    f64 = counts["event_step_freeze64"]
    if (f64["kernel"] == 0 or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items()
                   if k not in ("event_step_freeze64", "event_step_freeze"))):
        raise AssertionError(f"{name} launches: {counts}")
    for c, r, want in zip(cells, rows, burst_calls(cells)):
        if r["n"] != want:
            raise AssertionError(f"{c.label()} seed {c.seed}: n={r['n']}, "
                                 f"burst has {want}")
        for k in ("R_avg", "R_p95", "max_c"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{c.label()} seed {c.seed}: {k}="
                                     f"{r[k]}")
    sample = [i for i, c in enumerate(cells) if c in plain]
    static_cells = [i for i, c in enumerate(cells) if c not in plain]
    want = dict(zip(static_cells, plain_rows([cells[i] for i in
                                              static_cells], dev)))
    for i in sample:
        want[i] = plain[cells[i]]
    for i, w in want.items():
        if rows[i] != w:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    out = {"cells": len(cells), "wall_s": wall,
           "cells_per_s": len(cells) / wall, **timings,
           "other_s": wall - sum(timings.values()),
           "device_share": timings["device_s"] / wall,
           "launches": f64["kernel"], "plain_launches": f64["plain"],
           "freeze_launches": counts["event_step_freeze"]["kernel"],
           "sample": len(want),
           "cold": sum(r["cold"] for r in rows),
           "failures": sum(r["failures"] for r in rows)}
    print(f"{name}: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); float64 frozen-priority kernel "
          f"launches {f64['kernel']}, plain launches {f64['plain']} (freeze "
          f"kernel {out['freeze_launches']}); sample: {len(want)} cells "
          "recomputed through the plain version on the card, rows equal",
          flush=True)
    return out, rows


def freeze64_paths(dev, kern_fz: dict) -> dict:
    """Cold starts, node speeds and capacity dynamics on push and single-
    node cells: the float64 frozen-priority kernel against its plain
    version on the cold matrix's push buckets (FC, SEPT), the straggler
    grid's slowed push bucket, the steal matrix's cells without hedging
    (FC, SEPT) and cold single-node cells; then the cold matrix's push half
    and the straggler grid's unhedged push half as main paths.  The
    straggler path's healthy cells go to the freeze kernel, whose launches
    join its row ``kern_fz``.  Returns the new kernel's row."""
    cold_cells, strag_cells = cold_push_cells(), straggler_push_cells()
    ck, plain = {}, {}
    for k, case, cells in (
            ("cold_push_fc", "cold push fc 4 x 8 least-loaded, v18 (32-core "
             "burst, 5 seeds)", [c for c in cold_cells if c.policy == "fc"]),
            ("cold_push_sept", "cold push sept 4 x 8 least-loaded, v18 "
             "(32-core burst, 5 seeds)",
             [c for c in cold_cells if c.policy == "sept"]),
            ("straggler_push", "straggler push fc 4 x 8 home, v18, node 0 "
             "2-8x slow (20 cells)",
             [c for c in strag_cells if c.degrade is not None]),
            ("steal_fc", "push fc 3 x 6 least-loaded, node 0 killed at 8 s "
             "and 5x slow, autoscale to 5, v16 / v25", steal_cells("fc")),
            ("steal_sept", "push sept 3 x 6 least-loaded, node 0 killed at "
             "8 s and 5x slow, autoscale to 5, v16 / v25",
             steal_cells("sept")),
            ("single_cold", "cold single-node fc / sept c10 v60",
             single_cold_cells())):
        ck[k], rows_k = check_f64(case, cells, dev)
        plain.update(rows_k)
        print("freeze64 event_step vs plain: " + json.dumps(ck[k]),
              flush=True)
    if not all(min(ck[k]["failures"]) > 0
               for k in ("steal_fc", "steal_sept")):
        raise AssertionError("a steal matrix cell lost no call")
    cold, cold_rows = freeze64_path("cold push path", cold_cells, dev, plain)
    if not all(r["cold"] > 0 for r in cold_rows):
        raise AssertionError("a cold push cell started no container cold")
    strag, _ = freeze64_path("straggler push path", strag_cells, dev, plain)
    kern_fz["launches"] += strag["freeze_launches"]
    kern_fz["launches_by_path"]["straggler push path"] = \
        strag["freeze_launches"]
    main = ck["cold_push_fc"]
    paths = {"cold push path": cold["launches"],
             "straggler push path": strag["launches"]}
    return {
        "name": "event_step_freeze64", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step.cu",
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in ck.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": f"cold push fc bucket, {main['cells']} cells, "
                 f"n_b={main['n_b']}, 4 nodes x 8 slots",
        "ns_per_step": main["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "ns_per_step", "n_b", "bsz",
                                         "plan")}
                  for k, r in ck.items()},
        **{f"{k}_{f}": r[f] for k, r in (("cold_push", cold),
                                          ("straggler_push", strag))
           for f in ("cells_per_s", "device_share")}}


DEG5 = ((0, 1.0, 300.0, 5.0),)


def straggler_grid_cells() -> list:
    """The whole straggler grid (benchmarks/engine_bench.py::
    straggler_spec with its cell filter): FC on 4 x 8 cores, a 32-core
    burst, node 0 healthy or 2 / 4 / 6 / 8x slow from 2 s to 300 s, 5
    seeds; pull at intensities 18, 45 and 96 (75 cells), push under the
    home balancer at 18 (STRAGGLER_V's claim), unhedged (25 cells) and,
    slowed, hedged at 3x the estimate (20 cells): 120 cells."""
    degrades = (None,) + tuple(((0, 2.0, 300.0, s),)
                               for s in (2.0, 4.0, 6.0, 8.0))

    def keep(c):
        if c.hedge_multiple is not None:
            return (c.assignment == "push" and c.degrade is not None
                    and c.intensity == 18)
        return c.assignment == "pull" or c.intensity == 18

    return sweep.SweepSpec(policies=("fc",), nodes=(4,), cores=(8,),
                           intensities=(18, 45, 96),
                           assignments=("pull", "push"), lbs=("home",),
                           degrades=degrades, hedge_multiples=(None, 3.0),
                           seeds=5, workload_cores=32,
                           cell_filter=keep).cells()


def steal_matrix_cells() -> list:
    """The steal matrix (benchmarks/engine_bench.py::matrix_specs,
    ``steal``): FC and SEPT on 3 x 6 cores, least-loaded, node 0 5x slow,
    hedging at 2x the estimate (steal), node 0 killed at 8 s or not, the
    autoscaler (scale-up at 1 call a slot, a 2 s provision delay, up to 5
    nodes) or not, intensities 16 and 25, 2 seeds: 32 cells."""
    return sweep.SweepSpec(policies=("fc", "sept"), nodes=(3,), cores=(6,),
                           intensities=(16, 25), assignments=("push",),
                           degrades=(DEG5,), hedge_multiples=(2.0,),
                           fail_specs=(None, ((0, 8.0),)),
                           autoscale=(False, True), scale_ups=(1.0,),
                           provision_delays=(2.0,), max_nodes=5,
                           seeds=2).cells()


def dup_matrix_cells() -> list:
    """The dup matrix (benchmarks/engine_bench.py::matrix_specs, ``dup``):
    FC on 3 x 6 cores, node 0 5x slow, duplicate hedging at 2x the
    estimate, intensities 16 and 45, 4 seeds; pull with node 0 killed at
    8 s or not (16 cells), push without failures (8 cells): 24 cells."""
    return sweep.SweepSpec(
        policies=("fc",), nodes=(3,), cores=(6,), intensities=(16, 45),
        assignments=("pull", "push"), degrades=(DEG5,),
        hedge_multiples=(2.0,), hedge_mode="duplicate",
        fail_specs=(None, ((0, 8.0),)), seeds=4,
        cell_filter=lambda c: not (c.assignment == "push"
                                   and c.fail_spec is not None)).cells()


def hedge_path(name: str, cells, dev, plain: dict) -> tuple[dict, list]:
    """One main path with hedged cells: ``run_cells_scan(metrics_only=
    True)`` over ``cells``, every count set to 0 just before it and read
    just after (the hedged kernels launched; beside them only the other
    event-step kernels, whatever cells of the path they take; no plain
    version); its rows checked (burst sizes, finite metrics; the runner
    holds every hedged cell to all calls done) and held to ``plain``, the
    rows of the cells the checks ran through the plain version.  Returns
    its numbers and rows."""
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    hk = counts["event_step_hedge"]
    if (hk["kernel"] == 0 or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items()
                   if not k.startswith("event_step"))):
        raise AssertionError(f"{name} launches: {counts}")
    for c, r, want in zip(cells, rows, burst_calls(cells)):
        if r["n"] != want:
            raise AssertionError(f"{c.label()} seed {c.seed}: n={r['n']}, "
                                 f"burst has {want}")
        for k in ("R_avg", "R_p95", "max_c"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{c.label()} seed {c.seed}: {k}="
                                     f"{r[k]}")
        if r["backups"] and not (c.assignment == "push"
                                 and c.hedge_multiple is not None):
            # hedging acts on push cells only
            raise AssertionError(f"{c.label()}: backups {r['backups']}")
    sample = [i for i, c in enumerate(cells) if c in plain]
    for i in sample:
        if rows[i] != plain[cells[i]]:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    if not sample:
        raise AssertionError(f"{name}: no row held to the plain version")
    by_kernel = {k: v["kernel"] for k, v in counts.items() if v["kernel"]}
    out = {"cells": len(cells), "wall_s": wall,
           "cells_per_s": len(cells) / wall, **timings,
           "other_s": wall - sum(timings.values()),
           "device_share": timings["device_s"] / wall,
           "launches": hk["kernel"], "plain_launches": hk["plain"],
           "by_kernel": by_kernel, "sample": len(sample),
           "backups": sum(r["backups"] for r in rows),
           "failures": sum(r["failures"] for r in rows)}
    print(f"{name}: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); hedged kernel launches {hk['kernel']}, "
          f"plain launches {hk['plain']} (every kernel: {by_kernel}); "
          f"{out['backups']} backups, {out['failures']} calls lost; sample: "
          f"{len(sample)} cells recomputed through the plain version on the "
          "card, rows equal", flush=True)
    return out, rows


def straggler_claim(cells, rows) -> str:
    """The straggler grid's claim, with benchmarks/engine_bench.py::
    straggler_rows's arithmetic: the metrics of each cell identity averaged
    over its seeds; at the worst severity and the claim intensity, the
    share of the p95 that node 0's slowdown costs the push model (healthy
    against slowed, unhedged) that hedging wins back, and the pull model's
    p95 beside it."""
    groups: dict = {}
    for c, r in zip(cells, rows):
        groups.setdefault(dataclasses.replace(c, seed=0), []).append(r)
    agg = {c: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
           for c, rs in groups.items()}

    def sev(c):
        prof = sweep._cell_profile(c)
        return prof.max_slowdown() if prof is not None else 1.0

    sev_max = max(sev(c) for c in agg)
    v_claim = min(c.intensity for c in agg)

    def find(assignment, s, hedged):
        for c, r in agg.items():
            if (c.assignment == assignment and sev(c) == s
                    and c.intensity == v_claim
                    and (c.hedge_multiple is not None) == hedged):
                return r
        return None

    healthy, degraded = find("push", 1.0, False), find("push", sev_max, False)
    hedged, pull_deg = find("push", sev_max, True), find("pull", sev_max,
                                                         False)
    if not (healthy and degraded and hedged):
        return "no-straggler-point"
    lost = degraded["R_p95"] - healthy["R_p95"]
    rec = (degraded["R_p95"] - hedged["R_p95"]) / max(lost, 1e-9)
    claim = (f"sev{sev_max:g}: push p95 {healthy['R_p95']:.1f}->"
             f"{degraded['R_p95']:.1f}, hedged {hedged['R_p95']:.1f} "
             f"(recovered {rec:.0%}, {hedged['backups']:.0f} backups)")
    if pull_deg is not None:
        claim += f", pull {pull_deg['R_p95']:.1f}"
    return claim


def hedge_check_cases() -> list:
    """Phase 3f's kernel-vs-plain buckets, ``(name, case, cells)``: the
    straggler grid's hedged push cells, the steal matrix's FC cells with a
    kill and the autoscaler, the dup matrix's push cells at intensity 16, a
    cold bucket with node speeds, one node and 3 x 24 cores (the wide
    path)."""
    strag, steal, dup = (straggler_grid_cells(), steal_matrix_cells(),
                         dup_matrix_cells())
    return [
        ("straggler_hedged", "straggler hedged push fc 4 x 8 home, v18 "
         "(32-core burst), node 0 2-8x slow, hedge 3x (20 cells)",
         [c for c in strag if c.hedge_multiple is not None]),
        ("steal_fc", "steal matrix fc 3 x 6 least-loaded, node 0 killed "
         "at 8 s and 5x slow, autoscale to 5, hedge 2x, v16 / v25",
         [c for c in steal if c.policy == "fc" and c.autoscale
          and c.fail_spec]),
        ("dup_push", "dup matrix push fc 3 x 6 least-loaded, node 0 5x "
         "slow, duplicate 2x, v16 (4 copies a call, 4 seeds)",
         [c for c in dup if c.assignment == "push"
          and c.intensity == 16]),
        ("cold_het", "cold push fc 3 x 4 least-loaded, node 0 5x slow "
         "and node 1 at 0.7, hedge 2x, v16",
         [sweep.SweepCell(policy="fc", assignment="push", nodes=3, cores=4,
                          intensity=16, seed=s, warm=False, degrade=DEG5,
                          node_speeds=(1.0, 0.7), hedge_multiple=2.0)
          for s in range(2)]),
        ("self_steal", "one node fc c4 v5, node 0 4x slow, hedge 3x "
         "(steals go back to the node)",
         [sweep.SweepCell(policy="fc", assignment="push", nodes=1, cores=4,
                          intensity=5, seed=s,
                          degrade=((0, 2.0, 300.0, 4.0),),
                          hedge_multiple=3.0) for s in range(4)]),
        ("wide", "push sept 3 x 24 least-loaded, node 0 5x slow, hedge "
         "2x, v16 (36-core burst; the wide path)",
         [sweep.SweepCell(policy="sept", assignment="push", nodes=3,
                          cores=24, intensity=16, seed=s, workload_cores=36,
                          degrade=DEG5, hedge_multiple=2.0)
          for s in range(2)])]


def hedge_paths(dev, rows_by_kernel: dict) -> dict:
    """Straggler hedging: the float64 frozen-priority kernel's hedged
    instantiations against their plain version on the straggler grid's
    hedged push bucket, the steal matrix's FC cells with a kill and the
    autoscaler, the dup matrix's push cells at intensity 16, a cold bucket
    with node speeds, one node and 3 x 24 cores (the wide path); then the
    whole straggler grid, the steal matrix and the dup matrix as main
    paths, and the straggler grid's claim.  The other event-step kernels'
    launches on these paths join their rows in ``rows_by_kernel``.
    Returns the hedged kernels' row."""
    strag, steal, dup = (straggler_grid_cells(), steal_matrix_cells(),
                         dup_matrix_cells())
    if (len(strag), len(steal), len(dup)) != (120, 32, 24):
        raise AssertionError("grid sizes: "
                             f"{len(strag)}, {len(steal)}, {len(dup)}")
    hk, plain = {}, {}
    for k, case, cells in hedge_check_cases():
        hk[k], rows_k = check_f64(case, cells, dev)
        plain.update(rows_k)
        print("hedge event_step vs plain: " + json.dumps(hk[k]), flush=True)
    if not hk["wide"]["plan"]["wide"]:
        raise AssertionError(f"3 x 24 cores: plan {hk['wide']['plan']}")
    if not all(min(hk[k]["backups"]) > 0 for k in hk if k != "wide"):
        raise AssertionError("a hedged check cell issued no backup")
    if max(hk["steal_fc"]["failures"]) <= 6:
        # more than a node's 6 slots: calls lost queued too
        raise AssertionError("the steal cells lost no queued call")
    paths, numbers, strag_rows = {}, {}, None
    for pname, cells in (("straggler grid path", strag),
                         ("steal matrix path", steal),
                         ("dup matrix path", dup)):
        numbers[pname], rows = hedge_path(pname, cells, dev, plain)
        paths[pname] = numbers[pname]["launches"]
        for kname, n in numbers[pname]["by_kernel"].items():
            if kname in rows_by_kernel:
                row = rows_by_kernel[kname]
                row["launches"] += n
                row["launches_by_path"][pname] = n
        if pname == "straggler grid path":
            strag_rows = rows
    print(f"straggler: 120 cells on the card (5 seeds); claim: "
          f"{straggler_claim(strag, strag_rows)}", flush=True)
    main = hk["straggler_hedged"]
    return {
        "name": "event_step_hedge", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step_hedge.cu",
        "sources": {"steal": "src/repro_torch/kernels/csrc/"
                             "event_step_hedge.cu",
                    "duplicate": "src/repro_torch/kernels/csrc/"
                                 "event_step_dup.cu",
                    "body": "src/repro_torch/kernels/csrc/"
                            "event_step_freeze64.cuh"},
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in hk.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": f"straggler hedged push fc bucket, {main['cells']} cells, "
                 f"n_b={main['n_b']}, 4 nodes x 8 slots",
        "ns_per_step": main["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "ns_per_step", "n_b", "bsz",
                                         "plan")}
                  for k, r in hk.items()},
        **{f"{k}_{f}": numbers[p][f] for k, p in (
            ("straggler", "straggler grid path"),
            ("steal", "steal matrix path"), ("dup", "dup matrix path"))
           for f in ("cells_per_s", "device_share")}}


# -- 3g: request resilience ----------------------------------------------------
# the retry-storm benchmark (benchmarks/engine_bench.py::storm_rows): six
# client behaviours, (name, retry mode, shedding), on one ramp burst a seed
STORM_SCENARIOS = (
    ("no-retry", None, False),
    ("no-retry+shed", None, True),
    ("naive", "immediate", False),
    ("naive+shed", "immediate", True),
    ("backoff", "backoff", False),
    ("backoff+shed", "backoff", True),
)
STORM_T = 60.0


def storm_spec(mode, shed):
    """A storm behaviour's lifecycle: a timeout at 3x the estimate (floor
    2 s), 4 attempts retried at once or with backoff (0.5 s doubling to at
    most 8 s, jitter 0.5) or none, shedding at 2 s of queued E[p] a free
    slot or none."""
    # imported here: tools/scan_bench.py imports this script beside trees
    # from before the resilience module
    from repro_torch.core.resilience import (AdmissionPolicy, ResilienceSpec,
                                             RetryPolicy, TimeoutSpec)

    retry = (RetryPolicy(max_attempts=4, mode=mode, base_delay_s=0.5,
                         cap_delay_s=8.0, jitter=0.5)
             if mode is not None else None)
    return ResilienceSpec(timeout=TimeoutSpec(multiple=3.0, floor_s=2.0),
                          retry=retry,
                          admission=(AdmissionPolicy(threshold_s=2.0)
                                     if shed else None))


def storm_burst(seed: int) -> list:
    """The storm's ramp burst of seed ``seed``: sized for 8 cores at
    intensity 14 over 60 s, 6x over [T/3, T/2)."""
    return generate_trace_burst(cores=8, intensity=14, seed=1000 + seed,
                                kind="ramp", duration_s=STORM_T,
                                burst_factor=6.0, burst_start_frac=1 / 3,
                                burst_end_frac=1 / 2)


def storm_items(seeds) -> tuple[list, list]:
    """The storm's cells (name, retry mode, shedding, seed), behaviour
    major, and their ``simulate_cluster_cells_scan`` items as storm_rows
    builds them: a fresh copy of the seed's burst on 2 x 4 push
    least-loaded SEPT."""
    bursts = {s: storm_burst(s) for s in seeds}
    cells = [(name, mode, shed, s) for name, mode, shed in STORM_SCENARIOS
             for s in seeds]
    items = [(copy.deepcopy(bursts[s]), 2, 4, "sept", "push", "least_loaded",
              None, None, None, True, storm_spec(mode, shed))
             for _, mode, shed, s in cells]
    return cells, items


def storm_prepared(seeds) -> list:
    """The bucket runner's prepared cells of the storm's items."""
    return [fastpath._ScanCell(requests=it[0],
                               feats=fastpath._arrival_features(it[0]),
                               cores=4, nodes=2, policy="sept",
                               assignment="push", resilience=it[10])
            for it in storm_items(seeds)[1]]


def res_cell(policy, nodes, cores, intensity, seed, **kw):
    return sweep.SweepCell(policy=policy, assignment="push", nodes=nodes,
                           cores=cores, intensity=intensity, seed=seed, **kw)


def res_check_cases() -> list:
    """Phase 3g's kernel-vs-plain buckets, ``(name, case, prepared
    cells)``.  The plain version takes 2-5 ms a step on the card, so the
    checks beside the storm and FC at intensity 40 are cut to keep the
    phase near 30 s: the home balancer at intensity 10, the absolute
    timeout and one node at 15, and the wide path at 4, one seed
    (n_b 256 each)."""
    full = dict(timeout_multiple=2.0, timeout_floor_s=1.0, retry_attempts=3,
                shed_threshold=2.0)
    return [
        ("storm", "storm push sept 2 x 4 least-loaded, ramp burst v14 (6x "
         "over [T/3, T/2)), the six client behaviours, 2 seeds",
         storm_prepared(range(2))),
        ("fc_backoff_shed", "push fc 2 x 4 least-loaded v40, timeout 3x "
         "(floor 2 s), 3 attempts with backoff, shed at 2.0 (4 seeds)",
         [scan_cell(res_cell("fc", 2, 4, 40, s, timeout_multiple=3.0,
                             timeout_floor_s=2.0, retry_attempts=3,
                             shed_threshold=2.0)) for s in range(4)]),
        ("home_immediate", "push sept 3 x 4 home v10, timeout 2x (floor "
         "1 s), 3 attempts at once (4 seeds)",
         [scan_cell(res_cell("sept", 3, 4, 10, s, lb="home",
                             timeout_multiple=2.0, timeout_floor_s=1.0,
                             retry_attempts=3, retry_mode="immediate"))
          for s in range(4)]),
        ("absolute", "push sept 2 x 4 least-loaded v15, absolute timeout "
         "0.5 s (2 seeds)",
         [scan_cell(res_cell("sept", 2, 4, 15, s, timeout_multiple=3.0,
                             timeout_absolute_s=0.5)) for s in range(2)]),
        ("one_node", "one node fc c4 v15, timeout 2x (floor 1 s), 3 "
         "attempts with backoff, shed at 2.0 (4 seeds)",
         [scan_cell(res_cell("fc", 1, 4, 15, s, **full))
          for s in range(4)]),
        ("wide", "push sept 3 x 24 least-loaded v4 (36-core burst), "
         "timeout 2x (floor 1 s), 3 attempts with backoff, shed at 2.0 "
         "(1 seed; the wide path)",
         [scan_cell(res_cell("sept", 3, 24, 4, 0, workload_cores=36,
                             **full))])]


def check_res(case: str, prepared, dev) -> tuple[dict, list]:
    """The float64 frozen-priority kernel's resilience set against its
    plain version on the card: rows [:n_b] of start, finish, prio and node
    and the summary (timeouts, sheds, retries, wasted seconds, calls
    resolved, steps taken, each row's failure flag, cause and submissions)
    bit-identical, every call resolved and one step an event; then its
    time, ns a step, the plain version's time (the comparison run), the
    plan and the bound of this bucket's work.  Also returns each cell's
    plain rows and summary (numpy), against which a path's results of
    these cells are held."""
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"{case}: cells of several feature sets")
    key = tuple(max(col) for col in zip(*keys))
    inp, clk, ctr, static = bucket_tensors(
        key, fastpath._fill_bucket(key, prepared), dev, prepared)
    if not static["res"]:
        raise AssertionError(f"{case}: not a resilience bucket")
    n1 = key[1] + 1
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = ops.RES_LAUNCHES
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if ops.RES_LAUNCHES != k0 + 1:
        raise AssertionError(f"{case}: event_step did not launch the res "
                             "kernel")
    err = 0.0
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        a, b = a[:, :n1 - 1], b[:, :n1 - 1]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"res event_step {name} differs from the "
                                 f"plain version ({case}) at {bad}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    if ref[4].keys() != got[4].keys():
        raise AssertionError(f"{case}: summaries of different keys")
    for k in ref[4]:
        if not torch.equal(ref[4][k], got[4][k]):
            raise AssertionError(f"res event_step summary {k} differs "
                                 f"from the plain version ({case})")
    nc = len(prepared)
    n_real = np.array([len(c.feats.t) for c in prepared])
    aux = {k: v.cpu().numpy()[:nc] for k, v in ref[4].items()}
    rows = [r.cpu().numpy()[:nc] for r in ref[:4]]
    plain_cells = [{**{k: v[b] for k, v in aux.items()},
                    **dict(zip(("start", "finish", "prio", "node"),
                               (r[b] for r in rows)))} for b in range(nc)]
    failed = aux["nfl"].sum(1)
    if (aux["ndn"] != n_real).any():
        raise AssertionError(f"{case}: calls left unresolved")
    # one step an event: each arrival, completion, timeout and re-arrival
    if (aux["stepc"] != 2 * n_real - failed + aux["nto"]
            + aux["nrt"]).any():
        raise AssertionError(f"{case}: steps {aux['stepc'].tolist()}")
    out = {"case": case, "cells": nc, "bsz": int(clk.shape[0]),
           "n_b": key[1], "nodes": key[2], "slots": key[3],
           "fc_push": static["fc_push"],
           "n_steps_budget": static["n_steps"], "max_abs_err": err,
           "timed_out": aux["nto"].tolist(), "shed": aux["nsh"].tolist(),
           "retries": aux["nrt"].tolist(), "failed": failed.tolist(),
           "wasted_s": aux["wst"].tolist(), "steps": aux["stepc"].tolist(),
           "plan": ops.event_step_plan(
               n1=n1, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
               n_fns=key[4], window=static["window"], freeze=True,
               f64=True, fc_push=static["fc_push"],
               fc_ring=static["fc_ring"], res=True)}
    out["ms"] = time_call(lambda: ops.event_step(clk, ctr, inp, **static),
                          reps=10)
    out["plain_ms"] = plain_ms
    out["ns_per_step"] = out["ms"] * 1e6 / int(aux["stepc"].max())
    moved = f64_needed_bytes(prepared, static, aux["nrt"])
    # float64 operations this data needs: each insertion (n + retries -
    # sheds) its estimate and priority (7), its dispatch's start and finish
    # (2) and the gauge's share (2); each completion (n - failed) the two
    # rings' updates (4); each submission (n + retries) the controller's
    # estimate, the gauge over the free slots and its comparison (3) and
    # the deadline (3); each timeout or retry the backoff (9) and the
    # wasted seconds or the re-arrival time (3)
    ops_n = int(sum(11 * (n + r - sh) + 4 * (n - f) + 6 * (n + r)
                    + 12 * (t + r) for n, r, sh, f, t in zip(
                        n_real, aux["nrt"], aux["nsh"], failed,
                        aux["nto"])))
    out["bytes"], out["operations"] = moved, ops_n
    out["bound_ms"], out["bound_by"] = bound(moved, ops_n, torch.float64)
    return out, plain_cells


def res_timings(cells: int, wall: float, timings: dict) -> dict:
    """A path's wall, cells a second and the device's share of the wall."""
    return {"cells": cells, "wall_s": wall, "cells_per_s": cells / wall,
            **timings, "other_s": wall - sum(timings.values()),
            "device_share": timings["device_s"] / wall}


def result_equals_plain(r, p: dict) -> bool:
    """Does a written-back resilience result ``r`` hold the plain
    version's rows and summary ``p`` of its cell (event order): its
    counters, and each request's start, finish, priority and node, or
    (failed for good) its cause, and its resubmissions?"""
    if ((r.timed_out, r.shed, r.retries_issued, r.wasted_work)
            != (int(p["nto"]), int(p["nsh"]), int(p["nrt"]),
                float(p["wst"]))):
        return False
    order = fastpath._arrival_features(r.requests).order
    for e, ridx in enumerate(order.tolist()):
        q = r.requests[ridx]
        if (q.attempts != max(int(p["ratt"][e]) - 1, 0)
                or q.priority != float(p["prio"][e])
                or q.node != f"node{int(p['node'][e])}"):
            return False
        if bool(p["nfl"][e]):
            cause = "timeout" if int(p["fcz"][e]) == 1 else "shed"
            if (q.failed, q.start, q.c) != (cause, None, None):
                return False
        elif (q.failed, q.start, q.finish) != (
                None, float(p["start"][e]), float(p["finish"][e])):
            return False
    return True


def storm_path(dev, plain: list) -> tuple[dict, list, list]:
    """The storm as storm_rows runs it: its 60 cells (6 behaviours x 10
    seeds) through ``simulate_cluster_cells_scan``, every count set to 0
    just before it and read just after (the res kernel launched, nothing
    else, no plain version); every call done or failed; seeds 0 and 1
    held to ``plain``, the storm check's plain rows and summaries of those
    cells (``storm_items(range(2))``' order): the counters and each
    request's start, finish, priority, node, failure and attempts.
    Returns its numbers, cells and results."""
    cells, items = storm_items(range(10))
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = fastpath.simulate_cluster_cells_scan(items, device=dev,
                                                   timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    rk = counts["event_step_res"]
    if (rk["kernel"] == 0 or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items()
                   if k != "event_step_res")):
        raise AssertionError(f"storm path launches: {counts}")
    for c, r in zip(cells, results):
        if any((q.c is None) == (q.failed is None) for q in r.requests):
            raise AssertionError(f"storm {c}: a call neither done nor failed")
    names = [name for name, _, _ in STORM_SCENARIOS]
    sample = [i for i, c in enumerate(cells) if c[3] < 2]
    for i in sample:
        p = plain[2 * names.index(cells[i][0]) + cells[i][3]]
        if not result_equals_plain(results[i], p):
            raise AssertionError(f"storm {cells[i]}: kernel result differs "
                                 "from the plain rows")
    out = {**res_timings(len(cells), wall, timings),
           "launches": rk["kernel"], "plain_launches": rk["plain"],
           "sample": len(sample),
           "timed_out": sum(r.timed_out for r in results),
           "shed": sum(r.shed for r in results),
           "retries": sum(r.retries_issued for r in results)}
    print(f"storm path: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); res kernel launches {rk['kernel']}, "
          f"plain launches {rk['plain']}; {out['timed_out']} timeouts, "
          f"{out['shed']} sheds, {out['retries']} retries; sample: "
          f"{len(sample)} cells recomputed through the plain version on the "
          "card, results equal", flush=True)
    return out, cells, results


def windowed_goodput(requests, a: float, b: float) -> float:
    """Completions a second that clients saw in [a, b)."""
    n = sum(1 for r in requests if r.c is not None and a <= r.c < b)
    return n / max(b - a, 1e-9)


def storm_claim(cells, results) -> dict:
    """storm_rows' arithmetic: each behaviour's windowed goodput before
    the burst ([5 s, T/3)) and after it releases ([T/2 + 0.10 T, T/2 +
    0.35 T)), averaged over the seeds, the recovery (post over pre) and the
    counts; the hysteresis is backoff+shed's recovery less naive's."""
    t0, t1 = STORM_T / 3.0, STORM_T / 2.0
    pre_w = (5.0, t0)
    post_w = (t1 + 0.10 * STORM_T, min(t1 + 0.35 * STORM_T, STORM_T))
    summary: dict = {}
    for (name, _, _, _), sr in zip(cells, results):
        d = summary.setdefault(name, {"pre": [], "post": [], "timed_out": 0,
                                      "shed": 0, "retries_issued": 0})
        d["pre"].append(windowed_goodput(sr.requests, *pre_w))
        d["post"].append(windowed_goodput(sr.requests, *post_w))
        d["timed_out"] += sr.timed_out
        d["shed"] += sr.shed
        d["retries_issued"] += sr.retries_issued
    for d in summary.values():
        d["pre"] = sum(d["pre"]) / len(d["pre"])
        d["post"] = sum(d["post"]) / len(d["post"])
        d["recovery"] = d["post"] / max(d["pre"], 1e-9)
    naive, good = summary["naive"], summary["backoff+shed"]
    return {"scenarios": summary, "naive_recovery": naive["recovery"],
            "backoff_shed_recovery": good["recovery"],
            "hysteresis": good["recovery"] - naive["recovery"]}


def res_grid_cells() -> list:
    """The README's resilience grid: SEPT and FC on 2 x 4 push, the
    timeout at 3x the estimate or none, 3 attempts with backoff or none,
    shedding at 2.0 or none, intensity 30, 5 seeds: 80 cells, 10 of them
    with no policy."""
    return sweep.SweepSpec(policies=("sept", "fc"), nodes=(2,), cores=(4,),
                           assignments=("push",),
                           timeout_multiples=(None, 3.0),
                           retry_attempts=(None, 3),
                           shed_thresholds=(None, 2.0), seeds=5).cells()


def res_grid_path(dev) -> tuple[dict, dict]:
    """The README grid through ``run_cells_scan(metrics_only=True)``, every
    count set to 0 just before it and read just after (the res kernel and,
    for the cells with no policy, the freeze kernel; no plain version);
    every call done or failed; seed 0's cells with no policy and its SEPT
    cell with every policy recomputed through the plain version on the
    card, rows equal.  Returns its numbers and the kernels' launches."""
    cells = res_grid_cells()
    if len(cells) != 80:
        raise AssertionError(f"README grid: {len(cells)} cells")
    timings: dict = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sweep.run_cells_scan(cells, metrics_only=True, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    rk = counts["event_step_res"]
    if (rk["kernel"] == 0 or counts["event_step_freeze"]["kernel"] == 0
            or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items()
                   if k not in ("event_step_res", "event_step_freeze"))):
        raise AssertionError(f"README grid launches: {counts}")
    for c, r, want in zip(cells, rows, burst_calls(cells)):
        got = r["n"] + r.get("n_failed", 0.0)
        if got != want or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{c.label()} seed {c.seed}: row {r}")
    bare = [i for i, c in enumerate(cells)
            if c.seed == 0 and sweep._cell_resilience(c) is None]
    full = [i for i, c in enumerate(cells)
            if c.seed == 0 and c.policy == "sept" and c.timeout_multiple
            and c.retry_attempts and c.shed_threshold]
    want = dict(zip(bare, plain_rows([cells[i] for i in bare], dev)))
    plain = fastpath._run_scan_cells([scan_cell(cells[i]) for i in full],
                                     dev, force="ref")
    for i, p in zip(full, plain):
        want[i] = sweep._cell_metrics(cells[i], p)
    for i, w in want.items():
        if rows[i] != w:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    out = {**res_timings(len(cells), wall, timings),
           "launches": rk["kernel"], "plain_launches": rk["plain"],
           "freeze_launches": counts["event_step_freeze"]["kernel"],
           "sample": len(want),
           "timed_out": sum(r.get("timed_out", 0.0) for r in rows),
           "shed": sum(r.get("shed", 0.0) for r in rows)}
    print(f"README grid path: {len(cells)} cells in {wall:.3f} s = "
          f"{out['cells_per_s']:.1f} cells/s (fill {timings['fill_s']:.3f} s,"
          f" device {timings['device_s']:.3f} s = {out['device_share']:.1%} "
          f"of the wall, fold {timings['fold_s']:.3f} s, other "
          f"{out['other_s']:.3f} s); res kernel launches {rk['kernel']}, "
          f"plain launches {rk['plain']} (freeze kernel "
          f"{out['freeze_launches']}); {out['timed_out']:.0f} timeouts, "
          f"{out['shed']:.0f} sheds; sample: {len(want)} cells recomputed "
          "through the plain version on the card, rows equal", flush=True)
    return out, counts


def res_paths(dev, kern_fz: dict) -> dict:
    """Request resilience: the float64 frozen-priority kernel's resilience
    set against its plain version on the storm's bucket, FC with backoff
    and shedding at intensity 40, the home balancer with immediate
    retries, an absolute timeout, one node and 3 x 24 cores (the wide
    path); then the storm (60 cells) and the README grid (80 cells) as main
    paths, and the storm's hysteresis.  The README grid's freeze kernel
    launches join its row ``kern_fz``.  Returns the res kernel's row."""
    rk, plain = {}, {}
    for k, case, prepared in res_check_cases():
        rk[k], plain[k] = check_res(case, prepared, dev)
        print("res event_step vs plain: " + json.dumps(rk[k]), flush=True)
    if not rk["wide"]["plan"]["wide"]:
        raise AssertionError(f"3 x 24 cores: plan {rk['wide']['plan']}")
    storm = rk["storm"]
    for i, (name, mode, shed, _) in enumerate(storm_items(range(2))[0]):
        if (storm["timed_out"][i] == 0 or (storm["shed"][i] > 0) != shed
                or (storm["retries"][i] > 0) != (mode is not None)):
            raise AssertionError(f"storm check {name}: {storm}")
    if not (min(rk["fc_backoff_shed"]["shed"]) > 0
            and min(rk["fc_backoff_shed"]["retries"]) > 0):
        raise AssertionError("the fc backoff cells shed or retried nothing")
    numbers = {}
    numbers["storm path"], cells, results = storm_path(dev, plain["storm"])
    claim = storm_claim(cells, results)
    parts = [f"{name} pre={d['pre']:.2f}/s post={d['post']:.2f}/s "
             f"recovery={d['recovery']:.2f} timed_out={d['timed_out']} "
             f"shed={d['shed']} retries={d['retries_issued']}"
             for name, d in claim["scenarios"].items()]
    print(f"storm: 60 cells on the card (10 seeds); " + "; ".join(parts)
          + f"; naive_recovery={claim['naive_recovery']:.2f} "
          f"backoff_shed_recovery={claim['backoff_shed_recovery']:.2f} "
          f"hysteresis={claim['hysteresis']:.2f} (exact: "
          + json.dumps({k: claim[k] for k in (
              "naive_recovery", "backoff_shed_recovery", "hysteresis")})
          + ")", flush=True)
    numbers["README grid path"], counts = res_grid_path(dev)
    fz = counts["event_step_freeze"]["kernel"]
    kern_fz["launches"] += fz
    kern_fz["launches_by_path"]["README grid path"] = fz
    paths = {p: v["launches"] for p, v in numbers.items()}
    main = rk["storm"]
    return {
        "name": "event_step_res", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step_res.cu",
        "sources": {"set": "src/repro_torch/kernels/csrc/event_step_res.cu",
                    "body": "src/repro_torch/kernels/csrc/"
                            "event_step_freeze64.cuh"},
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in rk.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": f"storm bucket, {main['cells']} cells, n_b={main['n_b']}, "
                 "2 nodes x 4 slots",
        "ns_per_step": main["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "ns_per_step", "n_b", "bsz",
                                         "plan")}
                  for k, r in rk.items()},
        "storm": claim,
        **{f"{k}_{f}": numbers[p][f] for k, p in (
            ("storm", "storm path"), ("grid", "README grid path"))
           for f in ("cells_per_s", "device_share")}}


# -- 3h: the chunked stream replay on pull ------------------------------------
# the planet fleet (benchmarks/engine_bench.py:892-935): a synthetic
# Azure-calibrated day (data/azure_trace_slice.csv fitted, its catalog
# extended to 10,000 functions with a Zipf tail of 0.7, the rate scaled to
# ~175 invocations/s) on 96 single-core nodes, SEPT, pull, 4 MB containers,
# the autoscaler growing the fleet to 128 nodes
PLANET_SEED = 7
PLANET_FNS = 10_000
PLANET_TAIL_ALPHA = 0.7
PLANET_RATE_SCALE = 40.0
PLANET_CHUNK = 4096
# the two planet replays together should take about this long (45 s since
# phase 3i joined the run, which should stay under ~800 s); a card that
# would take longer replays the first cut of PLANET_CUTS that fits, and
# says so
PLANET_BUDGET_S = 45.0
PLANET_CUTS = ((1 << 20, 1 << 19), (1 << 18, 1 << 17), (1 << 16, 1 << 15),
               (1 << 15, 1 << 14))
# the materialized prefixes held to the whole-burst scan (planet_rows)
PLANET_PREFIXES = (2_000, 5_000, 8_000)
# the mid-stream chunk checked: the first one after this many invocations
PLANET_MID = 20_000


def planet_model():
    # imported here, so that tools/scan_bench.py can import this script
    # beside a tree from before the stream
    from repro_torch.core import synth

    return synth.expand_catalog(
        synth.fit_azure_csv(ROOT / "data" / "azure_trace_slice.csv"),
        PLANET_FNS, rate_scale=PLANET_RATE_SCALE,
        tail_alpha=PLANET_TAIL_ALPHA)


def planet_fleet() -> dict:
    return dict(nodes=96, cores_per_node=1, policy="sept", assignment="pull",
                warm=True, container_mb=4,
                dynamics=ClusterDynamics(
                    autoscale=True, autoscale_interval_s=15.0,
                    scale_up_queue_per_slot=0.5, provision_delay_s=60.0,
                    max_nodes=128))


def capture_chunk(stream, dev, chunk: int, pick, **kw) -> tuple[dict, object]:
    """Replay ``stream`` on the card and keep a copy of the first chunk that
    ``pick(index, invocations before it, static arguments)`` takes: its
    inputs, start planes and static arguments, as ``ops.event_step`` gets
    them.  Returns the chunk and the replay's result."""
    from repro_torch.core import streamscan

    done = [0]
    got: dict = {}

    def hook(i, inp, clk, ctr, static):
        if not got and pick(i, done[0], static):
            got.update(index=i, before=done[0], static=dict(static),
                       inp={k: v.clone() for k, v in inp.items()},
                       clk=clk.clone(), ctr=ctr.clone())

    def progress(chunks, events, wall):
        done[0] = events

    res = streamscan.simulate_cluster_stream(
        stream, chunk=chunk, device=dev, chunk_hook=hook, progress=progress,
        **kw)
    if not got:
        raise AssertionError("no chunk of the stream was picked")
    return got, res


def chunk_rows(inp, st0: dict) -> dict:
    """A chunk's rows: history (before the first fresh arrival and in no
    flight), carried (in flight at the boundary: running, queued,
    re-queued or waiting to re-arrive) and fresh."""
    t = inp["t"][0].cpu().numpy()
    n_rows = int(np.isfinite(t).sum())
    ai0 = int(st0["ai"][0])
    live = set(st0["idx_s"][0][np.isfinite(st0["fin_s"][0])].tolist())
    fnev, fnst = inp["fnev"][0].cpu().numpy(), inp["fnst"][0].cpu().numpy()
    for f in np.nonzero(st0["qcnt"][0])[0].tolist():
        live.update(fnev[fnst[f]:fnst[f] + st0["qcnt"][0][f]].tolist())
    for k in ("xq", "rearr"):
        if k in st0:
            v = st0[k][0]
            live.update(np.nonzero(v if k == "xq" else np.isfinite(v))[0]
                        .tolist())
    carried = sum(1 for r in live if r < ai0)
    return {"rows": n_rows, "history": ai0 - carried, "carried": carried,
            "fresh": n_rows - ai0}


def check_stream(case: str, cap: dict, n_fns: int, dev) -> dict:
    """A pull kernel's stream instantiation against the plain version on
    the card, from one handed-off chunk's start planes: rows [:n] of start,
    finish, prio and node, the summary and the final carry planes
    bit-identical; then its time, ns an event step (over the chunk's
    arrivals and completions: its few autoscaler ticks and activations are
    not counted), the plain version's time (the comparison run), the plan
    and the bound of the chunk's work (``n_fns``: the stream's functions,
    whatever the padded width)."""
    inp, clk, ctr, static = cap["inp"], cap["clk"], cap["ctr"], cap["static"]
    n1 = inp["t"].shape[1]
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = ops.STREAM_LAUNCHES
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if ops.STREAM_LAUNCHES != k0 + 1:
        raise AssertionError(f"{case}: event_step did not launch the stream "
                             "kernel")
    err = 0.0
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        a, b = a[:, :n1 - 1], b[:, :n1 - 1]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"stream event_step {name} differs from "
                                 f"the plain version ({case}) at {bad}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    if ref[4].keys() != got[4].keys():
        raise AssertionError(f"{case}: summaries of different keys")
    for k in ref[4]:
        if not torch.equal(ref[4][k], got[4][k]):
            raise AssertionError(f"stream event_step {k} differs from the "
                                 f"plain version ({case})")
    f64 = clk.dtype == torch.float64
    fsz = 8 if f64 else 4
    n_fb = inp["ring0"].shape[2]
    layout = carry_layout(n_nodes=static["n_nodes"],
                          n_slots=static["n_slots"],
                          window=static["window"], n_fns=n_fb, n1=n1,
                          dyn=static["dyn"], cold=static["cold"], stream=True)
    st0 = {k: v.cpu().numpy() for k, v in layout.unpack(clk, ctr).items()}
    st1 = {k: v.cpu().numpy() for k, v in layout.unpack(
        got[4]["clk"], got[4]["ctr"]).items()}
    rows = chunk_rows(inp, st0)
    finish = got[1][0, :n1 - 1].cpu().numpy()
    dispatched = int((finish > 0).sum())
    running0 = int(np.isfinite(st0["fin_s"]).sum())
    running1 = int(np.isfinite(st1["fin_s"]).sum())
    arrivals = int(st1["ai"][0]) - int(st0["ai"][0])
    if static["dyn"]:
        completions = int(st1["ndone"][0]) - int(st0["ndone"][0])
        lost = int(st1["nfail"][0]) - int(st0["nfail"][0])
    else:
        completions, lost = running0 + dispatched - running1, 0
    steps = arrivals + completions + 2 * lost
    plan = ops.event_step_plan(n1=n1, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"], n_fns=n_fb,
                               window=static["window"], f64=f64,
                               dyn=static["dyn"], cold=static["cold"],
                               stream=True)
    out = {"case": case, "chunk": cap["index"],
           "invocations_before": cap["before"], "n_b": n1 - 1, **rows,
           "nodes": static["n_nodes"], "slots": static["n_slots"],
           "fns": n_fns, "fns_padded": n_fb, "dyn": static["dyn"],
           "het": static["het"], "cold": static["cold"],
           "use_fc": static["use_fc"], "arrivals": arrivals,
           "completions": completions, "dispatches": dispatched,
           "nodes_provisioned": (int(st1["prov"][0]) if static["dyn"]
                                 else None),
           "n_steps_budget": static["n_steps"], "max_abs_err": err,
           "plan": plan}
    out["ms"] = time_call(lambda: ops.event_step(clk, ctr, inp, **static),
                          reps=3)
    out["plain_ms"] = plain_ms
    out["ns_per_step"] = out["ms"] * 1e6 / max(steps, 1)
    # bytes: the rows' t / p / cost and fnid, their CSR entries, each
    # function's first entry, the horizon, five coefficients, cores and
    # nodes; with dyn each node's activation and kill time, five dynamics
    # parameters, the cap and call count; the carry planes at the stream's
    # own widths read and written; the dispatched rows' records and, with
    # dyn / cold, the summaries
    nodes_real = static["n_nodes"]
    lay = carry_layout(n_nodes=nodes_real, n_slots=static["n_slots"],
                       window=static["window"], n_fns=n_fns,
                       n1=rows["rows"] + 1, dyn=static["dyn"],
                       cold=static["cold"], stream=True)
    nbytes = ((3 * fsz + 8) * rows["rows"] + 4 * n_fns + fsz + 5 * fsz + 8
              + 2 * (fsz * lay.f_len + 4 * lay.i_len)
              + (3 * fsz + 4) * dispatched)
    if static["dyn"]:
        nbytes += 2 * fsz * nodes_real + 5 * fsz + 8 + 12 + 12 * nodes_real
    if static["cold"]:
        nbytes += 4 * rows["rows"] + 8
    # operations these inputs need: a function's priority (5, 7 with the
    # enqueue clock, 9 with FC counts) each time an event changes it -- an
    # arrival, a completion (with its ring update, 3) and the dispatch that
    # moves its head -- and each dispatch's start and finish (2, 6 with a
    # speed, one more with the prewarm charge).  A priority over all the
    # stream's functions a dispatch, a scan of every function, gives
    # ``bound_ms_all_fns``.
    per_fn = 5 + 2 * static["dyn"] + 2 * static["use_fc"]
    per_disp = 2 + 4 * static["het"] + static["cold"]
    dt = torch.float64 if f64 else torch.float32
    ops_n = (per_fn * arrivals + (3 + per_fn) * completions
             + dispatched * (per_fn + per_disp))
    ops_all = 3 * completions + dispatched * (n_fns * per_fn + per_disp)
    out["bytes"], out["operations"] = nbytes, ops_n
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops_n, dt)
    out["operations_all_fns"] = ops_all
    out["bound_ms_all_fns"] = bound(nbytes, ops_all, dt)[0]
    return out


def materialized(model, k: int) -> list:
    """The first ``k`` invocations of the planet stream as requests."""
    reqs = []
    for ch in model.stream(PLANET_SEED, max_invocations=k).iter_chunks():
        reqs.extend(Request(fn=model.fns[fi], r=float(t), p_true=float(p))
                    for t, fi, p in zip(ch.r, ch.fn, ch.p))
    return reqs


def planet_prefixes(model, dev, fleet: dict | None = None,
                    prefixes=PLANET_PREFIXES) -> list[dict]:
    """Stream against whole-burst scan on the card, on the planet's
    materialized prefixes (benchmarks/engine_bench.py::planet_rows) on
    ``fleet`` (the pull fleet by default): the counters exact, every call's
    start and finish equal."""
    from repro_torch.core import streamscan

    fleet = fleet or planet_fleet()
    out = []
    for k in prefixes:
        reqs = materialized(model, k)
        t0 = time.perf_counter()
        ref = fastpath.simulate_cluster_scan(
            [Request(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs],
            device=dev, **fleet)
        t_single = time.perf_counter() - t0
        stream, order = streamscan.stream_from_requests(reqs, chunk=1024)
        t0 = time.perf_counter()
        pr = streamscan.simulate_cluster_stream(stream, chunk=1024,
                                                device=dev, **fleet)
        t_stream = time.perf_counter() - t0
        for key, want in (("failures", ref.failures),
                          ("cold_starts", ref.cold_starts),
                          ("evictions", ref.evictions),
                          ("backups_issued", ref.backups_issued)):
            if pr.counters[key] != want:
                raise AssertionError(f"planet prefix {k}: {key} stream "
                                     f"{pr.counters[key]}, whole {want}")
        if pr.nodes_used != ref.nodes_used:
            raise AssertionError(f"planet prefix {k}: nodes_used stream "
                                 f"{pr.nodes_used}, whole {ref.nodes_used}")
        for f in ("start", "finish"):
            want = np.array([getattr(r, f) for r in ref.requests])[order]
            if not np.array_equal(getattr(pr, f), want):
                raise AssertionError(f"planet prefix {k}: {f} differs")
        out.append({"invocations": k, "chunks": pr.chunks,
                    "nodes_used": pr.nodes_used, "stream_s": t_stream,
                    "whole_s": t_single})
    return out


def planet_replay(model, n_inv: int, dev, fleet: dict | None = None,
                  kernel: str = "event_step_stream",
                  label: str = "planet replay") -> dict:
    """The planet replay, the main path of the stream: ``n_inv``
    invocations at chunk PLANET_CHUNK on ``fleet`` (the pull fleet by
    default), every count set to 0 just before and read just after (the
    stream kernel ``kernel`` launched, no plain version and no other
    kernel); every call served, R_avg and R_p95 finite."""
    from repro_torch.core import streamscan

    timings: dict = {}
    log: list = []
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = streamscan.simulate_cluster_stream(
        model.stream(PLANET_SEED, max_invocations=n_inv), chunk=PLANET_CHUNK,
        device=dev, timings=timings, chunk_log=log,
        **(fleet or planet_fleet()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    st = counts[kernel]
    if (st["kernel"] == 0 or any(v["plain"] for v in counts.values())
            or any(v["kernel"] for k, v in counts.items() if k != kernel)):
        raise AssertionError(f"{label} launches: {counts}")
    if res.n != n_inv or not np.isfinite(res.finish).all():
        raise AssertionError(f"{label} of {n_inv}: {res.n} calls, "
                             f"{int(np.isnan(res.finish).sum())} unserved")
    s = res.summary()
    out = {"invocations": res.n, "chunks": res.chunks,
           "peak_rows": res.peak_rows, "peak_bytes": res.peak_bytes,
           "wall_s": wall, "invocations_per_s": res.n / wall,
           "device_s": timings["device_s"], "fill_s": timings["fill_s"],
           "device_share": timings["device_s"] / wall,
           "launches": st["kernel"], "plain_launches": st["plain"],
           "nodes_used": res.nodes_used, "R_avg": s["mean_resp"],
           "R_p95": float(np.percentile(res.resp, 95)), "R_p99": s["p99"],
           "sim_hours": float(res.t[-1] - res.t[0]) / 3600.0,
           "rows": row_shape_check(res, log, PLANET_CHUNK, label)}
    for k in ("R_avg", "R_p95"):
        if not math.isfinite(out[k]):
            raise AssertionError(f"{label}: {k}={out[k]}")
    print(f"{label}: {res.n} invocations in {wall:.3f} s = "
          f"{out['invocations_per_s']:.1f} invocations/s, {res.chunks} "
          f"chunks, peak_rows {res.peak_rows}, peak_bytes {res.peak_bytes} "
          f"(fill {timings['fill_s']:.3f} s, device "
          f"{timings['device_s']:.3f} s = {out['device_share']:.1%} of the "
          f"wall); {kernel} kernel launches {st['kernel']}, plain launches "
          f"{st['plain']}; nodes_used {res.nodes_used}, R_avg "
          f"{out['R_avg']:.4f} s, R_p95 {out['R_p95']:.4f} s; rows: "
          f"{json.dumps(out['rows'])}", flush=True)
    return out


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def row_shape_check(res, log: list, chunk: int, label: str) -> dict:
    """The memory evidence of a replay of a policy without FC history rows
    (SEPT), from its ``chunk_log``: each chunk's carried rows are the calls
    that the replay's own finishes put in flight at the horizon before it
    (arrived by then, finishing at or after it: running or queued), its
    fresh slice is the target that the budget and the carried rows leave
    (longer only across a run of equal arrival times; the last chunk takes
    what is left), its row shape the least power of two over its rows,
    never shrinking, and peak_rows the largest shape.  So the rows a chunk
    holds are the budget or the calls in flight, whatever the stream's
    length.  Raises on the first chunk that breaks a rule; returns the
    peak and the chunk that set it."""
    budget, floor = _pow2(chunk), max(_pow2(chunk) // 8, 1)
    if res.peak_rows != max(c["n_b"] for c in log) or log[-1]["invocations"] \
            != res.n:
        raise AssertionError(f"{label}: peak_rows {res.peak_rows}, chunk "
                             f"log {log}")
    n_b, before, peak = 0, 0, None
    for k, c in enumerate(log):
        in_flight = 0
        if k:
            prev = log[k - 1]
            in_flight = int(np.count_nonzero(
                res.finish[:prev["invocations"]] >= prev["t_stop"]))
        want = max(max(budget, n_b) - c["carried"], floor)
        rows = c["history"] + c["carried"] + c["fresh"]
        tie = (c["fresh"] > want and res.t[before + c["fresh"] - 1]
               == res.t[before + want - 1])
        if (c["history"] or c["carried"] != in_flight
                or c["invocations"] != before + c["fresh"]
                or (not c["final"] and (c["target"] != want or not (
                    c["fresh"] == want or tie)))
                or c["n_b"] != max(n_b, _pow2(rows))):
            raise AssertionError(
                f"{label}: chunk {k} breaks the row rule: {c} (calls in "
                f"flight at its horizon {in_flight}, target {want}, row "
                f"shape before {n_b})")
        if c["n_b"] > n_b:
            peak = {"chunk": k, "rows": rows, "carried": c["carried"],
                    "fresh": c["fresh"]}
        n_b, before = c["n_b"], c["invocations"]
    return {"peak_rows": n_b, "set_by": peak,
            "max_carried": max(c["carried"] for c in log),
            "budget": budget}


def stream_paths(dev) -> dict:
    """The chunked stream replay on pull: the stream kernels against the
    plain version on handed-off chunks (the planet's first chunk at a
    budget of 512, its first chunk after PLANET_MID invocations, a static
    float32 stream of SEPT and of FC on 2 x 4 nodes at chunk 256 (a
    16-core burst at intensity 60; FC's chunk has history rows), the cold
    matrix's FC v96 cell at chunk 1,024), the planet's prefixes against the
    whole-burst scan, then the planet replay and its half for the memory
    evidence.  Returns the stream kernel's row."""
    from repro_torch.core import streamscan

    model = planet_model()
    fleet = planet_fleet()
    nf = len(model.fns)
    caps = {}
    caps["planet_first_512"], _ = capture_chunk(
        model.stream(PLANET_SEED, max_invocations=1024), dev, 512,
        lambda i, before, st: True, **fleet)
    t0 = time.perf_counter()
    caps["planet_mid"], mid_res = capture_chunk(
        model.stream(PLANET_SEED, max_invocations=PLANET_MID
                     + 2 * PLANET_CHUNK), dev, PLANET_CHUNK,
        lambda i, before, st: before >= PLANET_MID, **fleet)
    probe_rate = mid_res.n / (time.perf_counter() - t0)
    checks = {k: check_stream(k, c, nf, dev) for k, c in caps.items()}
    for policy in ("sept", "fc"):
        c = sweep.SweepCell(policy=policy, nodes=2, cores=4, intensity=60,
                            seed=0, workload_cores=8)
        stream, _ = streamscan.stream_from_requests(sweep.make_workload(c))
        cap, _ = capture_chunk(stream, dev, 256,
                               lambda i, before, st: i == 1, nodes=2,
                               cores_per_node=4, policy=policy)
        checks[f"static_{policy}_2x4"] = check_stream(
            f"static {policy} 2 x 4", cap, len(stream.fns), dev)
    c = next(c for c in cold_pull_cells()
             if c.policy == "fc" and c.intensity == 96)
    stream, _ = streamscan.stream_from_requests(sweep.make_workload(c))
    cap, _ = capture_chunk(stream, dev, 1024, lambda i, before, st: i == 1,
                           nodes=c.nodes, cores_per_node=c.cores,
                           policy="fc", warm=False)
    checks["cold_fc_v96"] = check_stream("cold matrix fc v96", cap,
                                         len(stream.fns), dev)
    for r in checks.values():
        print("stream event_step vs plain: " + json.dumps(r), flush=True)
    if checks["static_fc_2x4"]["history"] == 0:
        raise AssertionError("the FC stream's chunk has no history rows")
    mid = checks["planet_mid"]
    if mid["carried"] == 0 or mid["nodes_provisioned"] <= 96:
        raise AssertionError(f"the mid-stream planet chunk: {mid}")
    if not (mid["plan"]["wide"] and checks["planet_first_512"]["plan"]
            ["wide"]):
        raise AssertionError("the planet chunks are not on the wide path")

    t0 = time.perf_counter()
    prefixes = planet_prefixes(model, dev)
    print(f"planet prefixes: {', '.join(str(p['invocations']) for p in prefixes)}"
          " invocations, stream against whole-burst scan on the card: "
          "counters exact, starts and finishes equal ("
          + json.dumps(prefixes) + f"; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    # the replays' length: the first cut whose two replays the probe's rate
    # puts within PLANET_BUDGET_S
    n_full, n_half = next(
        (cut for cut in PLANET_CUTS
         if sum(cut) / probe_rate <= PLANET_BUDGET_S), PLANET_CUTS[-1])
    if n_full != PLANET_CUTS[0][0]:
        print(f"planet replays cut to {n_full} and {n_half} invocations "
              f"(the {PLANET_CUTS[0][0]}-invocation day and its half would "
              f"take ~{sum(PLANET_CUTS[0]) / probe_rate:.0f} s at the probe's "
              f"{probe_rate:.0f} invocations/s, over {PLANET_BUDGET_S:.0f} s)",
              flush=True)
    full = planet_replay(model, n_full, dev)
    half = planet_replay(model, n_half, dev)
    if full["peak_rows"] != half["peak_rows"]:
        raise AssertionError(f"planet peak not flat: peak_rows "
                             f"{full['peak_rows']} at {n_full}, "
                             f"{half['peak_rows']} at {n_half}")
    print(f"planet memory: peak_rows {full['peak_rows']} at {n_full} "
          f"invocations and at {n_half}", flush=True)
    paths = {f"planet {n_full}-invocation replay": full["launches"],
             f"planet {n_half}-invocation replay": half["launches"]}
    return {
        "name": "event_step_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step_stream.cu",
        "sources": {"set": "src/repro_torch/kernels/csrc/event_step_stream.cu",
                    "body": "src/repro_torch/kernels/csrc/"
                            "event_step_pull.cuh"},
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
        "ms": mid["ms"], "plain_ms": mid["plain_ms"],
        "bound_ms": mid["bound_ms"], "bound_by": mid["bound_by"],
        "bound_ms_all_fns": mid["bound_ms_all_fns"],
        "library_ms": None,
        "shape": f"planet chunk {mid['chunk']} (after "
                 f"{mid['invocations_before']} invocations), n_b="
                 f"{mid['n_b']}, {mid['nodes']} nodes x 1 slot, "
                 f"{mid['fns_padded']} functions",
        "ns_per_step": mid["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "ns_per_step", "n_b",
                                         "plan")}
                  for k, r in checks.items()},
        "planet": {"full": full, "half": half, "probe_rate": probe_rate}}


# -- 3i: the chunked stream replay on push and one node ----------------------
# the planet fleet under push (the OpenWhisk shape: the controller pushes
# each call to an invoker, which queues it by its own estimator):
# planet_fleet() with assignment="push", least-loaded (the one balancer the
# JAX package streams with capacity dynamics)
PLANET_PUSH_PREFIXES = (2_000, 5_000)
# the push replays climb a ladder of power-of-two cuts from 2^12: the next
# rung is run while it and the last one (about three times the last's
# time) should fit PLANET_PUSH_BUDGET_S; the last two rungs are the replay
# and its half
PLANET_PUSH_BUDGET_S = 25.0
PLANET_PUSH_LADDER = tuple(1 << k for k in range(12, 21))


def planet_push_fleet() -> dict:
    return dict(planet_fleet(), assignment="push", lb="least_loaded")


def freeze_chunk_rows(inp, st0: dict) -> dict:
    """A frozen-priority chunk's rows: carried (in flight at the boundary:
    running, queued, waiting to re-arrive or to retry) and fresh; such a
    chunk has no history rows."""
    t = inp["t"][0].cpu().numpy()
    n_rows = int(np.isfinite(t).sum())
    ai0 = int(st0["ai"][0])
    live = np.zeros(t.shape[0], dtype=bool)
    live[st0["idx_s"][0][np.isfinite(st0["fin_s"][0])]] = True
    live |= st0["pend"][0].astype(bool)
    for k in ("rearr", "rto"):
        if k in st0:
            live |= np.isfinite(st0[k][0])
    carried = int(live[:ai0].sum())
    return {"rows": n_rows, "history": ai0 - carried, "carried": carried,
            "fresh": n_rows - ai0}


def check_freeze_stream(case: str, cap: dict, n_fns: int, dev) -> dict:
    """A frozen-priority kernel's stream instantiation against the plain
    version on the card, from one handed-off chunk's start planes: rows
    [:n] of start, finish, prio and node, the summary and the final carry
    planes bit-identical (``max_abs_err`` over all of them); then its time,
    ns an event step (the kernel's own count under hedging and res, else
    the chunk's arrivals, completions and twice its lost calls), the plain
    version's time (the comparison run), the plan and the bound of the
    chunk's work (``n_fns``: the stream's functions, whatever the padded
    width)."""
    inp, clk, ctr, static = cap["inp"], cap["clk"], cap["ctr"], cap["static"]
    n1 = inp["t"].shape[1]
    plain = []                       # the plain version, run once
    plain_ms = time_call(lambda: plain.append(ops.event_step(
        clk, ctr, inp, force="ref", **static)), reps=1, warmup=False)
    ref = plain[0]
    k0 = ops.FREEZE_STREAM_LAUNCHES
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    if ops.FREEZE_STREAM_LAUNCHES != k0 + 1:
        raise AssertionError(f"{case}: event_step did not launch the "
                             "frozen-priority stream kernel")
    err = 0.0
    pairs = [(name, a[:, :n1 - 1], b[:, :n1 - 1]) for name, a, b in zip(
        ("start", "finish", "prio", "node"), ref, got)]
    if ref[4].keys() != got[4].keys():
        raise AssertionError(f"{case}: summaries of different keys")
    pairs += [(k, ref[4][k], got[4][k]) for k in ref[4]]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"freeze stream event_step {name} differs "
                                 f"from the plain version ({case}) at {bad}")
        d = (a.double() - b.double()).abs()
        if a.is_floating_point():
            d = d[torch.isfinite(a)]       # equal infinities differ by nan
        if d.numel():
            err = max(err, float(d.max()))
    f64 = clk.dtype == torch.float64
    fsz = 8 if f64 else 4
    n_fb = inp["ring0"].shape[2]
    seg = {k: static[k] for k in ("fc_push", "fc_ring", "dyn", "het",
                                  "cold", "hedge", "res")}
    layout = carry_layout(n_nodes=static["n_nodes"],
                          n_slots=static["n_slots"], window=static["window"],
                          n_fns=n_fb, n1=n1, freeze=True, stream=True, **seg)
    st0 = {k: v.cpu().numpy() for k, v in layout.unpack(clk, ctr).items()}
    st1 = {k: v.cpu().numpy() for k, v in layout.unpack(
        got[4]["clk"], got[4]["ctr"]).items()}
    rows = freeze_chunk_rows(inp, st0)
    finish = got[1][0, :n1 - 1].cpu().numpy()
    dispatched = int((finish > 0).sum())
    running0 = int(np.isfinite(st0["fin_s"]).sum())
    running1 = int(np.isfinite(st1["fin_s"]).sum())
    arrivals = int(st1["ai"][0]) - int(st0["ai"][0])
    lost = (int(st1["nfail"][0]) - int(st0["nfail"][0]) if static["dyn"]
            else 0)
    if static["dyn"] or static["hedge"]:
        completions = int(st1["ndone"][0]) - int(st0["ndone"][0])
    elif static["res"]:
        completions = int(st1["ndn"][0]) - int(st0["ndn"][0])
    else:
        completions = running0 + dispatched - running1
    if static["hedge"] or static["res"]:
        steps = int(got[4]["stepc"][0]) - int(
            st0["stepc" if static["hedge"] else "stp"][0])
    else:
        steps = arrivals + completions + 2 * lost
    plan = ops.event_step_plan(n1=n1, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"], n_fns=n_fb,
                               window=static["window"], freeze=True,
                               fc_push=static["fc_push"],
                               fc_ring=static["fc_ring"], f64=f64,
                               dyn=static["dyn"], cold=static["cold"],
                               hedge=static["hedge"], res=static["res"],
                               stream=True)
    out = {"case": case, "chunk": cap["index"],
           "invocations_before": cap["before"], "n_b": n1 - 1, **rows,
           "nodes": static["n_nodes"], "slots": static["n_slots"],
           "fns": n_fns, "fns_padded": n_fb, **seg,
           "arrivals": arrivals, "completions": completions, "lost": lost,
           "dispatches": dispatched, "steps": steps,
           "nodes_provisioned": (int(st1["prov"][0]) if static["dyn"]
                                 else None),
           "n_steps_budget": static["n_steps"], "max_abs_err": err,
           "plan": plan}
    out["ms"] = time_call(lambda: ops.event_step(clk, ctr, inp, **static),
                          reps=3)
    out["plain_ms"] = plain_ms
    out["ns_per_step"] = out["ms"] * 1e6 / max(steps, 1)
    # bytes: the rows' t / p / cost and fnid, (home) home0 and (single-node
    # FC) cnt, the horizon, the coefficients, cores, nodes and the route;
    # with dyn each node's activation and kill time, five dynamics
    # parameters, the cap and call count; the carry planes at the stream's
    # own widths read and written; the dispatched rows' records and the
    # summaries
    nodes_real = static["n_nodes"]
    lay = carry_layout(n_nodes=nodes_real, n_slots=static["n_slots"],
                       window=static["window"], n_fns=n_fns,
                       n1=rows["rows"] + 1, freeze=True, stream=True, **seg)
    nbytes = ((3 * fsz + 8 + fsz) * rows["rows"] + 6 * fsz + 12
              + 2 * (fsz * lay.f_len + 4 * lay.i_len)
              + (3 * fsz + 4) * dispatched)
    if static["dyn"]:
        nbytes += 2 * fsz * nodes_real + 5 * fsz + 8 + 12 + 12 * nodes_real
    # operations: an arrival's estimate and frozen priority (6; with the
    # FC rings, one compare an entry), a completion's ring update (3), a
    # dispatch's start and finish (2, 6 with a speed, one more with the
    # prewarm charge)
    ops_n = (arrivals * (6 + (static["fc_ring"] if static["fc_push"]
                              else 0))
             + 3 * completions
             + dispatched * (2 + 4 * static["het"] + static["cold"]))
    out["bytes"], out["operations"] = nbytes, ops_n
    out["bound_ms"], out["bound_by"] = bound(
        nbytes, ops_n, torch.float64 if f64 else torch.float32)
    return out


def freeze_stream_paths(dev, pull: dict) -> dict:
    """The chunked stream replay on push and one node: the frozen-priority
    stream kernels against the plain version on handed-off chunks (the
    planet push fleet's first chunk at a budget of 512; push FC on 2 x 4
    nodes at chunk 256, the chunk after its FC rings grew; push home SEPT
    on 2 x 4; single-node FC; steal hedging with node speeds; the storm's
    backoff-and-shedding lifecycle on 2 x 4 push SEPT over four of its
    bursts back to back, chunk 256; the cold matrix's push FC v18 cell at
    chunk 1,024), the planet push prefixes against the whole-burst scan,
    then the planet push replay and its half for the memory evidence,
    beside phase 3h's pull replay (``pull``) of the same cut.  Returns the
    frozen-priority stream kernel's row."""
    from repro_torch.core import streamscan
    from repro_torch.core.stragglers import HedgingSpec, NodeSpeedProfile

    model = planet_model()
    fleet = planet_push_fleet()
    nf = len(model.fns)
    checks = {}
    cap, _ = capture_chunk(
        model.stream(PLANET_SEED, max_invocations=1024), dev, 512,
        lambda i, before, st: True, **fleet)
    checks["planet_push_first_512"] = check_freeze_stream(
        "planet push first chunk, budget 512", cap, nf, dev)

    def small(key, case, reqs, chunk, pick, **kw):
        stream, _ = streamscan.stream_from_requests(reqs)
        cap, res = capture_chunk(stream, dev, chunk, pick,
                                 assignment="push", **kw)
        checks[key] = check_freeze_stream(case, cap, len(stream.fns), dev)
        checks[key]["replay_counters"] = {
            k: v for k, v in res.counters.items() if v}

    def cell_calls(policy, nodes, cores, intensity, wcores):
        return sweep.make_workload(sweep.SweepCell(
            policy=policy, nodes=nodes, cores=cores, intensity=intensity,
            seed=0, workload_cores=wcores))

    rings = []

    def grown(i, before, st):
        rings.append(st["fc_ring"])
        return len(rings) > 1 and st["fc_ring"] > rings[0]

    small("push_fc_2x4", "push fc 2 x 4 v60, chunk 256, the chunk after "
          "the FC rings grew", cell_calls("fc", 2, 4, 60, 8), 256, grown,
          nodes=2, cores_per_node=4, policy="fc")
    small("push_home_sept_2x4", "push home sept 2 x 4 v60, chunk 256",
          cell_calls("sept", 2, 4, 60, 8), 256,
          lambda i, before, st: i == 1, nodes=2, cores_per_node=4,
          policy="sept", lb="home")
    small("single_fc_c8", "one node fc c8 v60 (static counts), chunk 256",
          cell_calls("fc", 1, 8, 60, 8), 256, lambda i, before, st: i == 1,
          nodes=1, cores_per_node=8, policy="fc")
    small("steal_speeds_3x4", "push fc 3 x 4 v30, speeds 0.2 / 0.7 / 1.0, "
          "steal 2x, chunk 128", cell_calls("fc", 3, 4, 30, 12), 128,
          lambda i, before, st: i == 1, nodes=3, cores_per_node=4,
          policy="fc", profile=NodeSpeedProfile(speeds=(0.2, 0.7, 1.0)),
          hedging=HedgingSpec(mode="steal", multiple=2.0))
    storm = [Request(fn=q.fn, r=q.r + s * STORM_T, p_true=q.p_true)
             for s in range(4) for q in storm_burst(s)]
    small("storm_backoff_shed", "storm backoff+shed, 2 x 4 push sept, "
          "four bursts back to back, chunk 256", storm, 256,
          lambda i, before, st: i == 3, nodes=2, cores_per_node=4,
          policy="sept", resilience=storm_spec("backoff", True))
    c = next(c for c in cold_push_cells() if c.policy == "fc")
    small("cold_push_fc_v18", "cold matrix push fc 4 x 8 v18, chunk 1,024",
          sweep.make_workload(c), 1024, lambda i, before, st: i == 0,
          nodes=c.nodes, cores_per_node=c.cores, policy="fc", warm=False)
    for r in checks.values():
        print("freeze stream event_step vs plain: " + json.dumps(r),
              flush=True)
    first = checks["planet_push_first_512"]
    if not (first["plan"]["wide"] and first["dyn"]):
        raise AssertionError(f"the planet push chunk: {first}")
    if checks["storm_backoff_shed"]["carried"] == 0:
        raise AssertionError("the storm's chunk carries no call")
    if checks["steal_speeds_3x4"]["replay_counters"].get(
            "backups_issued", 0) == 0:
        raise AssertionError("the steal replay issued no backup")

    t0 = time.perf_counter()
    prefixes = planet_prefixes(model, dev, fleet, PLANET_PUSH_PREFIXES)
    print(f"planet push prefixes: "
          f"{', '.join(str(p['invocations']) for p in prefixes)} "
          "invocations, stream against whole-burst scan on the card: "
          "counters exact, starts and finishes equal ("
          + json.dumps(prefixes) + f"; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    rungs, ladder = [], []
    for n in PLANET_PUSH_LADDER:
        r = planet_replay(model, n, dev, fleet=fleet,
                          kernel="event_step_freeze_stream",
                          label="planet push replay")
        if r["launches"] != r["chunks"]:
            raise AssertionError(f"planet push replay: {r['launches']} "
                                 f"launches for {r['chunks']} chunks")
        ladder.append(dict({k: r[k] for k in (
            "invocations", "wall_s", "invocations_per_s", "chunks",
            "peak_rows", "R_avg", "R_p95", "R_p99", "nodes_used",
            "device_share")}, max_carried=r["rows"]["max_carried"]))
        rungs.append(r)
        if 3.2 * r["wall_s"] > PLANET_PUSH_BUDGET_S:
            break
    if len(rungs) < 2:
        raise AssertionError("planet push ladder: fewer than two rungs")
    full, half = rungs[-1], rungs[-2]
    n_full, n_half = full["invocations"], half["invocations"]
    # the memory evidence: every chunk of both replays met the row rule
    # (row_shape_check), so the rows a chunk holds are the budget or the
    # calls in flight; under push these grow with the day's backlog
    print(f"planet push replays: {n_full} and {n_half} invocations (the "
          f"ladder's last two rungs, {full['wall_s'] + half['wall_s']:.1f} s "
          f"against a {PLANET_PUSH_BUDGET_S:.0f} s budget); memory: "
          f"peak_rows {full['peak_rows']} and {half['peak_rows']}, each the "
          "least power of two over the budget or its chunk's calls in "
          f"flight (most carried {full['rows']['max_carried']} and "
          f"{half['rows']['max_carried']}, budget {full['rows']['budget']})",
          flush=True)
    # push against pull on the largest cut both replayed (phase 3h's)
    both = [(r, pull[k]) for r in (full, half) for k in ("full", "half")
            if pull[k]["invocations"] == r["invocations"]]
    if both:
        cmp_push, same = both[0]
    else:
        cmp_push, same = full, planet_replay(model, n_full, dev)
    print(f"planet push against pull, {cmp_push['invocations']} invocations "
          "on the card: "
          + ", ".join(f"{k} push {cmp_push[k]:.6g} pull {same[k]:.6g}"
                      for k in ("invocations_per_s", "device_share",
                                "nodes_used", "R_avg", "R_p95", "R_p99",
                                "chunks", "peak_rows")), flush=True)
    paths = {f"planet push {n_full}-invocation replay": full["launches"],
             f"planet push {n_half}-invocation replay": half["launches"]}
    return {
        "name": "event_step_freeze_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step_freeze_stream.cu",
        "sources": {
            "set": "src/repro_torch/kernels/csrc/event_step_freeze_stream.cu",
            "body_f32": "src/repro_torch/kernels/csrc/event_step_freeze.cuh",
            "body_f64": "src/repro_torch/kernels/csrc/"
                        "event_step_freeze64.cuh"},
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "shape": f"planet push chunk 0, n_b={first['n_b']}, "
                 f"{first['nodes']} nodes x 1 slot, {first['fns_padded']} "
                 "functions (the float64 wide path)",
        "ns_per_step": first["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "ns_per_step", "n_b",
                                         "plan")}
                  for k, r in checks.items()},
        "planet_push": {"full": full, "half": half, "pull_same_cut": same,
                        "same_cut": cmp_push["invocations"],
                        "ladder": ladder, "prefixes": prefixes}}


# Fig 6 (benchmarks/fig6_multinode.py): FC on 2, 3 and 4 pull nodes of 18
# cores against the stock baseline on 4, one 72-core burst at intensity 30,
# and the paper's mean responses (seconds)
FIG6_PAPER = {"baseline@4": 240.0, "fc@4": None, "fc@3": 68.0,
              "fc@2": 100.0}
# phase 3j's cross-check samples every RUNNER_XCHECK_STRIDE-th cell
# identity of the mega cut (17 of its 50, each with all of its seeds)
RUNNER_XCHECK_STRIDE = 3
# the sampled cells of the 40-seed cut whose float32 scan leaves
# CLUSTER_XCHECK_RTOL against the reference Cluster: a near-tie order that
# the JAX package's scan gives too (tests/test_torch_sweep_runner.py::
# test_pull_tie_cell_raises_in_both), so run_sweep records a failed row
MEGA_XCHECK_BREACHES = ("ours-sept_c8_v30_n2_scan#seed18",)
# the stream-routed cell: SEPT on 96 pull nodes of 12 cores (the warm
# regime the scan models holds to 13 cores a node), a burst sized for its
# 1,152 cores at intensity 54: 68,431 calls, over STREAM_CELL_THRESHOLD
STREAM_CELL = dict(policy="sept", nodes=96, cores=12, intensity=54,
                   workload_cores=1152, backend="scan")


def pool_workers() -> int:
    """The sweep pool's size: the cores this process may use, at most 8."""
    import os
    return max(1, min(8, len(os.sched_getaffinity(0))))


def off_scan(cells) -> dict:
    """The cells of a ``backends=("scan",)`` grid that the routing puts off
    the scan (the JAX package's rules), by reason: the stock baseline,
    shapes outside the scan's matrix, and workloads outside its regime
    (``cluster_scan_eligible`` / ``scan_eligible``)."""
    out = {"baseline": 0, "matrix": 0, "regime": 0}
    for c in cells:
        if c.mode == "baseline" or c.policy == "baseline":
            out["baseline"] += 1
        elif not sweep._scan_batchable(c):
            out["matrix"] += 1
        elif sweep._cluster_scan_capable(c):
            if not sweep._cluster_scan_ok(c, sweep.make_workload(c),
                                          c.policy):
                out["regime"] += 1
        elif not fastpath.scan_eligible(sweep.make_workload(c), c.cores,
                                        c.policy, warm=c.warm):
            out["regime"] += 1
    return out


def runner_paths(dev, main_cells, main_rows, main_wall) -> dict:
    """Phase 3j, the sweep runner: ``run_sweep`` over Fig 6's grid (5
    seeds) and over the main path's 2,000 cells with a sampled cross-check
    against the reference ``Cluster``, and one cell over
    ``STREAM_CELL_THRESHOLD`` rows that ``run_cell`` replays through the
    chunked stream, each with the counts set to 0 just before and read
    just after.  ``main_*`` are phase 1's cells, rows and wall.  Returns
    the launches by kernel and path."""
    workers = pool_workers()
    launched: dict = {}

    def counted(label, fn):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches()
        plain = {k: c["plain"] for k, c in counts.items() if c["plain"]}
        if plain:
            raise AssertionError(f"{label}: plain launches {plain}")
        for k, c in counts.items():
            if c["kernel"]:
                launched.setdefault(k, {})[label] = c["kernel"]
        return out, wall, {k: c["kernel"] for k, c in counts.items()
                           if c["kernel"]}

    # -- Fig 6's grid under backends=("scan",) ------------------------------
    fig6 = sweep.SweepSpec(
        policies=("fc",), modes=("ours", "baseline"), nodes=(2, 3, 4),
        cores=(18,), intensities=(30,), workload_cores=72, seeds=5,
        backends=("scan",),
        cell_filter=lambda c: c.mode == "ours" or c.nodes == 4)
    want = off_scan(fig6.cells())
    res, wall, counts = counted(
        "Fig 6 grid", lambda: sweep.run_sweep(fig6, workers=workers,
                                              device=dev))
    meta = res.meta
    if meta["failed"] or meta["degraded"] != sum(want.values()):
        raise AssertionError(f"Fig 6 grid: meta {meta}, off the scan {want}")
    print(f"sweep runner, Fig 6 grid: {meta['cells']} cells in {wall:.3f} s "
          f"on {res.workers} workers (pool start method "
          f"{sweep._pool_method(None)}); scan_batched "
          f"{meta['scan_batched']}, degraded {meta['degraded']} (the "
          f"routing's: {json.dumps(want)}), failed {meta['failed']}; kernel "
          f"launches {json.dumps(counts)}", flush=True)
    for label, mode, nodes in (("baseline@4", "baseline", 4),
                               ("fc@4", "ours", 4), ("fc@3", "ours", 3),
                               ("fc@2", "ours", 2)):
        agg = res.find(mode=mode, nodes=nodes)
        if not (math.isfinite(agg["R_avg"]) and agg["seeds"] == 5):
            raise AssertionError(f"Fig 6 {label}: {agg}")
        print(f"Fig 6 {label}: R_avg {agg['R_avg']:.4f} s (paper "
              f"{FIG6_PAPER[label]}), R_p95 {agg['R_p95']:.4f}, max_c "
              f"{agg['max_c']:.4f}, degraded {agg['degraded']}", flush=True)

    # -- the main path's cells under run_sweep, cross-checked ---------------
    n_seeds = len({c.seed for c in main_cells})
    mega = sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           nodes=(2, 4), cores=(8,),
                           intensities=(10, 15, 20, 25, 30), seeds=n_seeds,
                           workload_cores=16, backends=("scan",),
                           validate="cross-check",
                           validate_stride=RUNNER_XCHECK_STRIDE)
    res, wall, counts = counted(
        "sweep runner, mega cut", lambda: sweep.run_sweep(
            mega, workers=workers, device=dev))
    meta = res.meta
    sampled = [cr for cr in res.results if cr.cell.cross_check]
    idents = len({cr.cell.key() for cr in sampled})
    worst = max(cr.metrics["xcheck_err"] for cr in sampled
                if "xcheck_err" in cr.metrics)
    failed = [i for i, cr in enumerate(res.results)
              if cr.metrics.get("failed")]
    breaches = set(meta["errors"])
    if (meta["degraded"] or not sampled
            or meta["cells"] != len(main_cells)
            or meta["scan_batched"] + meta["xcheck_sampled"]
            != meta["cells"] or worst > sweep.CLUSTER_XCHECK_RTOL
            or not counts.get("event_step")
            or not len(failed) == meta["failed"] == len(breaches)
            or not all(res.results[i].cell.cross_check for i in failed)
            or not all(m.startswith("BackendMismatchError: ")
                       for m in meta["errors"].values())
            or (n_seeds == 40 and breaches != set(MEGA_XCHECK_BREACHES))):
        raise AssertionError(f"mega cut: meta {meta}, worst xcheck_err "
                             f"{worst}, launches {counts}")
    # every other row equals phase 1's row of the same cell (metrics-only,
    # the bucketed scan), the cross-checked ones without their xcheck_err
    for cr, c, r in zip(res.results, main_cells, main_rows):
        if dataclasses.replace(cr.cell, backend="reference",
                               cross_check=False) != c:
            raise AssertionError(f"cell order: {cr.cell} against {c}")
        if cr.metrics.get("failed"):
            continue
        if {k: v for k, v in cr.metrics.items() if k != "xcheck_err"} != r:
            raise AssertionError(f"{c.label()} seed {c.seed}: run_sweep's "
                                 "row differs from run_cells_scan's")
    # a stratified sample and the breached cells through the plain version
    # on the CPU: the card's rows (phase 1's for a breached cell) equal
    strata = sorted({(cr.cell.policy, cr.cell.nodes, cr.cell.intensity)
                     for cr in res.results})
    pick = [next(i for i, cr in enumerate(res.results)
                 if (cr.cell.policy, cr.cell.nodes, cr.cell.intensity) == st
                 and cr.cell.seed == k % n_seeds)
            for k, st in enumerate(strata)]
    pick += [i for i in failed if i not in pick]
    plain = sweep.run_cells_scan([main_cells[i] for i in pick],
                                 device="cpu")
    for i, w in zip(pick, plain):
        if main_rows[i] != w:
            raise AssertionError(f"{main_cells[i].label()}: the card's row "
                                 "differs from the plain row")
    print(f"sweep runner, mega cut: {meta['cells']} cells in {wall:.3f} s "
          f"= {meta['cells'] / wall:.1f} cells/s on {res.workers} workers, "
          f"beside run_cells_scan(metrics_only=True) on the same cells "
          f"{len(main_cells) / main_wall:.1f} cells/s (phase 1); meta "
          + json.dumps({k: meta[k] for k in (
              "scan_batched", "degraded", "failed", "xcheck_sampled",
              "xcheck_skipped_degraded")})
          + f"; {idents} cell identities cross-checked against the "
          f"reference Cluster (stride {RUNNER_XCHECK_STRIDE}), largest "
          f"xcheck_err of the passing cells {worst:.6g} "
          f"(CLUSTER_XCHECK_RTOL {sweep.CLUSTER_XCHECK_RTOL}), counts exact; "
          f"kernel launches {json.dumps(counts)}, plain launches 0; every "
          f"other row equals phase 1's; sample: {len(pick)} cells "
          "recomputed through the plain version on the CPU, rows equal",
          flush=True)
    for key, msg in sorted(meta["errors"].items()):
        print(f"sweep runner, cross-check breach (the float32 scan's "
              f"near-tie order, as in the JAX package; its card row equals "
              f"the plain row): {key}: {msg.splitlines()[0]}", flush=True)
    runner = {"cells": meta["cells"], "wall_s": wall,
              "cells_per_s": meta["cells"] / wall,
              "scan_cells_per_s": len(main_cells) / main_wall,
              "xcheck_sampled": meta["xcheck_sampled"],
              "xcheck_identities": idents, "worst_xcheck_err": worst,
              "xcheck_breaches": sorted(breaches)}

    # -- one cell over STREAM_CELL_THRESHOLD rows ---------------------------
    cell = sweep.SweepCell(**STREAM_CELL)
    n = len(sweep.make_workload(cell))
    if n <= sweep.STREAM_CELL_THRESHOLD:
        raise AssertionError(f"stream cell: {n} calls")
    seen = []
    routed = sweep._run_stream_cell

    def spy(*a, **kw):
        out = routed(*a, **kw)
        seen.append(out.stream)
        return out

    sweep._run_stream_cell = spy
    try:
        row, wall, counts = counted("stream-routed cell",
                                    lambda: sweep.run_cell(cell, device=dev))
    finally:
        sweep._run_stream_cell = routed
    whole, wall_w, counts_w = counted(
        "whole-burst cell", lambda: sweep.run_cells_scan([cell],
                                                         device=dev)[0])
    if len(seen) != 1 or not counts.get("event_step_stream") or row != whole:
        raise AssertionError(f"stream cell: routed {len(seen)}, launches "
                             f"{counts}, rows equal {row == whole}")
    sr = seen[0]
    print(f"sweep runner, stream-routed cell ({cell.label()}, {n} calls > "
          f"STREAM_CELL_THRESHOLD {sweep.STREAM_CELL_THRESHOLD}): run_cell "
          f"replayed it in {sr.chunks} chunks, peak_rows {sr.peak_rows}, in "
          f"{wall:.3f} s (launches {json.dumps(counts)}); its row equals "
          f"run_cells_scan's whole-burst row ({wall_w:.3f} s, launches "
          f"{json.dumps(counts_w)}): R_avg {row['R_avg']:.6g}, R_p95 "
          f"{row['R_p95']:.6g}, n {row['n']:.0f}", flush=True)
    runner.update(stream_chunks=sr.chunks, stream_peak_rows=sr.peak_rows,
                  stream_wall_s=wall, whole_wall_s=wall_w)
    return {"launches": launched, "runner": runner}


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the peak rate of ``dtype``, whichever is larger."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_o = flops / PEAK_OPS[dtype] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def randn(gen, shape, dtype, dev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def attn_err(got, want, dtype, what: str) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= ATTN_TOL[dtype]:
        raise AssertionError(f"{what}: max |kernel - plain| = {err} above "
                             f"{ATTN_TOL[dtype]}")
    return err


def check_decode(B, Sk, Hq, Hkv, dh, dtype, lengths, dev, gen,
                 timed=True) -> dict:
    """decode_attention against its plain version; timed beside SDPA on
    K / V repeated to Hq heads with a boolean mask of the lengths."""
    q = randn(gen, (B, Hq, dh), dtype, dev)
    k = randn(gen, (B, Sk, Hkv, dh), dtype, dev)
    v = randn(gen, (B, Sk, Hkv, dh), dtype, dev)
    L = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = ops.decode_attention(q, k, v, L, force="ref")
    k0 = ops.DECODE_LAUNCHES
    got = ops.decode_attention(q, k, v, L)
    torch.cuda.synchronize()
    if ops.DECODE_LAUNCHES != k0 + 1:
        raise AssertionError("decode_attention did not launch the kernel")
    shape = f"B={B} Sk={Sk} {Hq}/{Hkv}/{dh} {str(dtype)[6:]}"
    out = {"shape": shape, "lengths": list(lengths),
           "max_abs_err": attn_err(got, want, dtype, f"decode {shape}")}
    if timed:
        keys = sum(min(max(n, 0), Sk) for n in lengths)
        es = q.element_size()
        nbytes = keys * Hkv * dh * 2 * es + 2 * B * Hq * dh * es + 4 * B
        out["bound_ms"], out["bound_by"] = bound(nbytes, 4 * keys * Hq * dh,
                                                 dtype)
        out["ms"] = time_call(lambda: ops.decode_attention(q, k, v, L), 20)
        out["device_ms"] = time_graph(
            lambda: ops.decode_attention(q, k, v, L), 20)
        out["n_split"], out["chunk"] = split_plan(Sk, B, Hkv)
        out["gb_s"] = nbytes / out["ms"] / 1e6
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["plain_ms"] = time_call(lambda: ops.decode_attention(
            q, k, v, L, force="ref"), 3)
        G = Hq // Hkv
        kr = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vr = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        mask = (torch.arange(Sk, device=dev)[None, :]
                < L[:, None].long())[:, None, None, :]
        qs = q[:, :, None, :]
        out["library_ms"] = time_call(lambda: F.scaled_dot_product_attention(
            qs, kr, vr, attn_mask=mask), 20)
    return out


def serving_heads() -> list[tuple]:
    """(query heads, KV heads, head_dim) of the decode attention of every
    served family with attention layers (``configs.ARCHS``)."""
    return sorted({(c.n_heads, c.n_kv_heads, c.head_dim)
                   for c in map(get_config, ARCHS)
                   if any(spec.kind == "attn" for spec in c.period)})


def check_flash(B, Sq, Sk, Hq, Hkv, dh, dtype, dev, gen, causal=True,
                window=-1, timed=True) -> dict:
    """flash_attention against its plain version; timed beside SDPA
    (``enable_gqa``; ``is_causal`` for a square causal mask, else a boolean
    mask)."""
    q = randn(gen, (B, Sq, Hq, dh), dtype, dev)
    k = randn(gen, (B, Sk, Hkv, dh), dtype, dev)
    v = randn(gen, (B, Sk, Hkv, dh), dtype, dev)
    kw = dict(causal=causal, window=window)
    want = ops.flash_attention(q, k, v, force="ref", **kw)
    k0 = ops.FLASH_LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if ops.FLASH_LAUNCHES != k0 + 1:
        raise AssertionError("flash_attention did not launch the kernel")
    shape = (f"B={B} Sq={Sq} Sk={Sk} {Hq}/{Hkv}/{dh} {str(dtype)[6:]} "
             f"{'causal' if causal else 'bidirectional'}"
             + (f" window={window}" if window > 0 else ""))
    out = {"shape": shape,
           "max_abs_err": attn_err(got, want, dtype, f"flash {shape}")}
    if timed:
        q_pos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        k_pos = torch.arange(Sk, device=dev)[None, :]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
        pairs = int(mask.sum())
        es = q.element_size()
        nbytes = (2 * B * Sq * Hq + 2 * B * Sk * Hkv) * dh * es
        flops = 4 * dh * Hq * B * pairs
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops, dtype)
        out["ms"] = time_call(lambda: ops.flash_attention(q, k, v, **kw), 10)
        out["kernel_source"] = flash_mod.SOURCE[dtype] + ".cu"
        out["tflop_s"] = flops / out["ms"] / 1e9
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["plain_ms"] = time_call(lambda: ops.flash_attention(
            q, k, v, force="ref", **kw), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if causal and window <= 0 and Sq == Sk:
            lib = dict(is_causal=True)
        elif not causal and window <= 0:
            lib = {}
        else:
            lib = dict(attn_mask=mask)
        out["library_ms"] = time_call(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **lib), 10)
    return out


def check_rglru(B, S, W, dtype, dev, gen, timed=True) -> dict:
    """rglru_scan against its plain version: bit-identical (both take the
    same float32 steps, each product and sum rounded)."""
    a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                  device=dev)).to(dtype)
    gx = randn(gen, (B, S, W), dtype, dev) * 0.1
    h0 = randn(gen, (B, W), dtype, dev) * 0.1
    want = ops.rglru_scan(a, gx, h0, force="ref")
    k0 = ops.RGLRU_LAUNCHES
    got = ops.rglru_scan(a, gx, h0)
    torch.cuda.synchronize()
    if ops.RGLRU_LAUNCHES != k0 + 1:
        raise AssertionError("rglru_scan did not launch the kernel")
    shape = f"B={B} S={S} W={W} {str(dtype)[6:]}"
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"rglru_scan {shape}: kernel differs from the "
                             f"plain version by {err}")
    out = {"shape": shape, "max_abs_err": err}
    if timed:
        es = a.element_size()
        # a, gx read and hs written once, h0 read and hT written once;
        # a product and a sum per step and channel, in float32
        nbytes = 3 * B * S * W * es + 2 * B * W * es
        out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * B * S * W,
                                                 torch.float32)
        out["ms"] = time_call(lambda: ops.rglru_scan(a, gx, h0), 20)
        out["device_ms"] = time_graph(lambda: ops.rglru_scan(a, gx, h0), 20,
                                      GRAPH_CALLS if S == 1 else 1)
        out["plain_ms"] = time_call(lambda: ops.rglru_scan(
            a, gx, h0, force="ref"), 2)
        out["library_ms"] = None
    return out


def extreme_decays(gen, shape, dev) -> torch.Tensor:
    """w = exp(-exp(x)), x uniform in [-6, 4] (the model's decay form, from
    ~1e-24 to ~0.9975), with exact zeros, float32 denormals and exact ones
    mixed in."""
    w = torch.exp(-torch.exp(-6.0 + 10.0 * torch.rand(
        shape, generator=gen, device=dev)))
    pick = torch.rand(shape, generator=gen, device=dev)
    w[pick < 0.05] = 0.0
    w[(pick >= 0.05) & (pick < 0.08)] = 1e-40
    w[pick >= 0.92] = 1.0
    return w


def check_rwkv6(B, S, H, dh, dtype, dev, gen, timed=True,
                extreme=False) -> dict:
    """rwkv6_scan against its plain version from a nonzero state; outputs
    within RWKV6_TOL, the last state within 1e-5 (float32).  Decays in
    [0.9, 0.999), or from 0 to 1 (``extreme_decays``)."""
    r = randn(gen, (B, S, H, dh), dtype, dev)
    k = randn(gen, (B, S, H, dh), dtype, dev) * 0.2
    v = randn(gen, (B, S, H, dh), dtype, dev) * 0.2
    w = (extreme_decays(gen, (B, S, H, dh), dev) if extreme else
         0.9 + 0.099 * torch.rand((B, S, H, dh), generator=gen, device=dev))
    u = randn(gen, (H, dh), dtype, dev) * 0.1
    s0 = randn(gen, (B, H, dh, dh), torch.float32, dev)
    want = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    k0 = ops.RWKV6_LAUNCHES
    got = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    if ops.RWKV6_LAUNCHES != k0 + 1:
        raise AssertionError("rwkv6_scan did not launch the kernel")
    shape = (f"B={B} S={S} H={H} dh={dh} {str(dtype)[6:]}"
             + (" decays 0..1" if extreme else ""))
    if not (torch.isfinite(got[0].float()).all()
            and torch.isfinite(got[1]).all()):
        raise AssertionError(f"rwkv6_scan {shape}: not finite")

    def excess(g, w, tol):
        """max |g - w| and its largest ratio to tol + tol |w|"""
        d = (g.float() - w.float()).abs()
        return float(d.max()), float((d / (tol + tol * w.float().abs()))
                                     .max())

    err, over = excess(got[0], want[0], RWKV6_TOL[dtype])
    err_s, over_s = excess(got[1], want[1], RWKV6_TOL[torch.float32])
    if not (over <= 1 and over_s <= 1):
        raise AssertionError(f"rwkv6_scan {shape}: |kernel - plain| = {err} "
                             f"(out), {err_s} (state), {max(over, over_s)} "
                             "times the tolerance")
    out = {"shape": shape, "max_abs_err": err, "state_max_abs_err": err_s}
    if timed:
        es = r.element_size()
        n = B * S * H * dh
        # r, k, v read and out written (model dtype), w read (float32),
        # u read, s0 read and sT written (float32).  Float32 flops per head
        # and step: 3 dh^2 for the update w S + k v^T, 2 dh^2 for r . S,
        # and 5 dh for the bonus, (sum_i r_i u_i k_i) v added to out (the
        # kernel's own 7 dh^2 forms u k v per element: more than needed)
        nbytes = 4 * n * es + 4 * n + H * dh * es + 2 * B * H * dh * dh * 4
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, B * S * H * (5 * dh * dh + 5 * dh), torch.float32)
        out["ms"] = time_call(lambda: ops.rwkv6_scan(r, k, v, w, u, s0), 10)
        out["device_ms"] = time_graph(
            lambda: ops.rwkv6_scan(r, k, v, w, u, s0), 10,
            GRAPH_CALLS if S == 1 else 1)
        out["plain_ms"] = time_call(lambda: ops.rwkv6_scan(
            r, k, v, w, u, s0, force="ref"), 1)
        out["library_ms"] = None
    return out


@contextlib.contextmanager
def swapped(name, fn, mod=ops):
    """``mod.<name>`` (``ops`` by default) is ``fn`` while the block runs:
    the model looks its kernels up in ``ops`` (and the MoE layers their
    router in ``layers``) at every call, so this changes one function of a
    run and leaves the others as they are."""
    kept = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield kept
    finally:
        setattr(mod, name, kept)


def plain_version(name):
    """``ops.<name>`` run as its plain version whatever the caller asks."""
    kernel = getattr(ops, name)
    return lambda *a, force=None, **kw: kernel(*a, force="ref", **kw)


def model_f32(arch, dev) -> dict:
    """``arch`` at full width in float32: a 512-token prefill and 8 decode
    steps through the kernels and through the plain versions, both fed the
    kernel run's greedy tokens; logits must agree within LOGIT_TOL.  For a
    model with RWKV-6 layers, ``scan_f64_witness`` too."""
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    params = init(cfg, 0, dev)
    tokens = torch.randint(0, cfg.vocab, (1, 512),
                           generator=torch.Generator().manual_seed(1))
    feed = []

    def run(force):
        cache = init_cache(cfg, 1, 512 + 8, device=dev)
        logits, cache = prefill(params, cfg, {"tokens": tokens.to(dev)},
                                cache, force=force)
        seq = [logits]
        for i in range(8):
            if len(feed) == i:
                feed.append(logits.argmax(-1).to(torch.int32))
            logits, cache = decode_step(params, cfg, feed[i], cache, 512 + i,
                                        force=force)
            seq.append(logits)
        return torch.stack(seq).float()

    t0 = time.perf_counter()
    got, want = run(None), run("ref")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{arch} f32: non-finite logits")
    err = float((got - want).abs().max())
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{arch} f32: logits differ by {err} "
                             f"(tolerance {LOGIT_TOL})")
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    out = {"layers": cfg.n_layers, "max_abs_err": err, "tol": LOGIT_TOL,
           "max_abs_logit": float(want.abs().max()),
           "argmax_equal": f"{same}/{got.shape[0]}", "wall_s": wall,
           "param_gb": sum(t.numel() for t in _leaves(params)) * 4 / 1e9}
    if any(spec.kind == "rwkv" for spec in cfg.period):
        out["scan_f64_witness"] = scan_f64_witness(lambda: run(None), got,
                                                   want, torch.float32)
    del params
    torch.cuda.empty_cache()
    return out


def cut_depth(params, cfg, layers: int):
    """``params`` and ``cfg`` of a model whose period is one layer (as
    rwkv6_3b's), cut to its first ``layers`` layers: the groups' stacked
    leaves are sliced (views), everything else is shared."""
    if len(cfg.period) != 1 or not 1 <= layers <= cfg.n_layers:
        raise ValueError(f"cannot cut {cfg.name} to {layers} layers")

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:layers]

    return (params | {"groups": cut(params["groups"])},
            dataclasses.replace(cfg, n_layers=layers))


def scan_f64_witness(run, got, want, dtype) -> dict:
    """Where a model's kernel-vs-plain gap comes from when it runs
    ``rwkv6_scan``.  ``run()``, the kernel run returning its logits, runs
    once more with every ``rwkv6_scan`` call done in float64 (the plain
    version on float64 copies, rounded back to the model's ``dtype``) and
    everything else as before.  ``per_call``: over the run's calls, the
    largest distance of the kernel and of the plain version from that
    float64 scan on the model's own inputs, over the call's largest |out|.
    ``logits``: the distance of the kernel run and of the plain run from
    the float64-scan run.  If each call lies within the dtype's rounding
    of float64 and the kernel run about as far as the
    plain run, the gap between them is rounding of the scan (each sums in
    its own order) that the model carries to its logits.  Fails if the
    kernel lies farther than RWKV6_TOL[dtype] from the float64 scan in a
    call, or farther than WITNESS_RATIO times the plain run from the
    float64-scan run."""
    per_call = {"kernel": 0.0, "plain": 0.0}

    def scan64(r, k, v, w, u, s0, *, force=None):
        exact, sT = rwkv6_mod.rwkv6_scan_ref(
            *(x.double() for x in (r, k, v, w, u, s0)))
        scale = float(exact.abs().max())
        for side, f in (("kernel", None), ("plain", "ref")):
            o = kernel(r, k, v, w, u, s0, force=f)[0]
            per_call[side] = max(per_call[side], float(
                (o.double() - exact).abs().max()) / scale)
        return exact.to(r.dtype), sT.float()

    with swapped("rwkv6_scan", scan64) as kernel:
        wit = run()
    logits = {"kernel": float((got - wit).abs().max()),
              "plain": float((want - wit).abs().max())}
    if not (per_call["kernel"] <= RWKV6_TOL[dtype]
            and logits["kernel"] <= WITNESS_RATIO * logits["plain"]):
        raise AssertionError(f"rwkv6_scan against a float64 scan: per call "
                             f"{per_call}, at the logits {logits}")
    return {"per_call_rel": per_call, "logits_abs": logits}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def step_launches(cfg) -> dict:
    """Launches of each kernel in one decode step of ``cfg``: one for each
    layer of the kind the kernel serves."""
    out = dict.fromkeys(KIND_KERNEL.values(), 0)
    for spec in cfg.layer_specs():
        out[KIND_KERNEL[spec.kind]] += 1
    return out


def param_bytes(cfg) -> int:
    """Bytes of ``cfg``'s parameters in its dtype (from ``param_shapes``)."""
    es = torch.tensor([], dtype=torch_dtype(cfg.dtype)).element_size()
    return es * sum(math.prod(s) for s in _leaves(param_shapes(cfg)))


def release(*eps) -> None:
    """Free endpoints' weights, lanes and graphs (their memory pools)."""
    for ep in eps:
        ep.params = None
        ep.lanes.clear()
    gc.collect()
    torch.cuda.empty_cache()


def decode_step_time(ep, n=8) -> dict:
    """Where a full-width decode step's time goes, on ``ep``'s first lane.
    eager_wall / eager_host: n eager ``decode_step`` calls back to back (a
    step as the parent engine ran it), the host clock to one synchronise at
    the end / without it (host ~ wall: the host sets the pace).
    graph_wall: n replays of the lane's graph, the host clock to a
    synchronise: a step as the engine runs it now.  device: the n replays
    timed by CUDA events, the card's work with no gap between launches.
    ``profile``: ``step_profile`` over n replays.  attn_call_us / op_us:
    host time of one decode_attention call at this shape (models with
    attention) and of one small PyTorch op, without a synchronise."""
    params, cfg, dev = ep.params, ep.cfg, ep.device
    cache = init_cache(cfg, 1, ep.cache_len, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)

    def steps():
        t, c = tok, cache
        for i in range(n):
            logits, c = decode_step(params, cfg, t, c, i)
            t = logits.argmax(-1).to(torch.int32)

    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    lane = ep.lanes[0]
    lane.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        ep.step(lane)
    torch.cuda.synchronize()
    graph_wall = time.perf_counter() - t0
    lane.reset()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        ep.step(lane)
    e1.record()
    torch.cuda.synchronize()
    dev_ms = e0.elapsed_time(e1) / n
    out = {"eager_wall_ms": wall / n * 1e3, "eager_host_ms": host / n * 1e3,
           "graph_wall_ms": graph_wall / n * 1e3, "device_ms": dev_ms,
           "eager_idle_share": 1 - dev_ms / (wall / n * 1e3),
           "graph_idle_share": 1 - dev_ms / (graph_wall / n * 1e3),
           "profile": step_profile(ep, lane, n)}

    q = torch.zeros((1, cfg.n_heads, cfg.head_dim),
                    dtype=torch_dtype(cfg.dtype), device=dev)
    kc = [c["k"][0] for c in cache["groups"].values() if "k" in c]
    if kc:
        lengths = torch.full((1,), 8, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            ops.decode_attention(q, kc[0], kc[0], lengths)
        out["attn_call_us"] = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        q.add(q)
    out["op_us"] = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    return out


def _device_us(evt) -> float:
    """An event's own device microseconds, under either of the profiler's
    names for them."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(evt, name, None)
        if t is not None:
            return float(t)
    return 0.0


def step_profile(ep, lane, n) -> dict:
    """``torch.profiler`` over n replays of ``lane``'s graph: the device ms
    a step of each serving kernel (its own kernels: decode's split and
    merge, the scans' passes), of the matrix products (the matrix
    library's kernels, ``MATMUL_KERNELS``) and of the other ops, the
    largest of those, and each kernel's calls a step (its first kernel
    name: one a wrapper call at the serving shapes).  Fails unless each
    kernel's calls are the launches the graph captured."""
    from torch.profiler import ProfilerActivity, profile

    lane.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ep.step(lane)
        torch.cuda.synchronize()
    ms = dict.fromkeys([*PROFILE_KERNELS, "matmul", "other"], 0.0)
    calls = dict.fromkeys(PROFILE_KERNELS, 0)
    other: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t, name = _device_us(evt) / 1e3 / n, evt.key
        kernel = next((k for k, names in PROFILE_KERNELS.items()
                       if any(x in name for x in names)), None)
        if kernel is not None:
            ms[kernel] += t
            if PROFILE_KERNELS[kernel][0] in name:
                calls[kernel] += evt.count
        elif any(x in name.lower() for x in MATMUL_KERNELS):
            ms["matmul"] += t
        else:
            ms["other"] += t
            other[name[:80]] = other.get(name[:80], 0.0) + t
    total = sum(ms.values())
    if total <= 0:
        raise AssertionError("torch.profiler saw no kernel of the replays")
    want = {k: n * ep.captured.get(k, 0) for k in PROFILE_KERNELS}
    if calls != want:
        raise AssertionError(f"{ep.name}: the profiler counts {calls} kernel "
                             f"calls over {n} replays, the graph captured "
                             f"{ep.captured} a step")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return {"ms_per_step": ms, "total_ms": total,
            "calls_per_step": {k: v // n for k, v in calls.items() if v},
            "top_other_ms": dict(top)}


def graph_vs_eager(ep, steps=8) -> dict:
    """The lane graph's logits over ``steps`` replays from a zeroed lane
    against ``decode_step`` called eagerly (pos a tensor on the card) on a
    fresh cache fed the same tokens, twice: the same kernels in the same
    order, so the difference is meant to be 0.  Where it is not, the two
    eager runs say whether the eager step itself varies; the difference is
    then held to BF16_LOGIT_RTOL of the largest |logit|."""
    lane = ep.lanes[0]
    lane.reset()
    got, fed = [], []
    for _ in range(steps):
        fed.append(lane.token.clone())
        ep.step(lane)
        got.append(lane.logits.float())

    def eager():
        cache = init_cache(ep.cfg, 1, ep.cache_len, device=ep.device)
        out = []
        for i, tok in enumerate(fed):
            logits, cache = decode_step(
                ep.params, ep.cfg, tok, cache,
                torch.tensor(i, dtype=torch.int32, device=ep.device))
            out.append(logits.float())
        return torch.stack(out)

    got, want = torch.stack(got), eager()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{ep.name}: replayed logits not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    out = {"steps": steps, "max_abs_diff": err, "max_abs_logit": scale,
           "argmax_equal": f"{int((got.argmax(-1) == want.argmax(-1)).sum())}"
                           f"/{steps}"}
    if err:
        again = float((eager() - want).abs().max())
        out["eager_vs_eager"] = again
        out["cause"] = ("the eager step varies from run to run" if again
                        else "the captured step computes otherwise than "
                             "the eager one (the eager runs agree)")
        if not err <= BF16_LOGIT_RTOL * scale:
            raise AssertionError(f"{ep.name}: graph against eager {out}")
    return out


def full_width_burst(arch, dev, layers=None):
    """The launcher's two endpoints of ``arch`` at full width
    (``serve.make_endpoints``: one copy of the weights from seed 0 behind
    two generation profiles; ``layers`` cuts the depth), on an engine of 2
    slots, policy fc: estimator warm-up 3 + 3 calls and a burst of 12 (30%
    heavy), with every count set to 0 just before and read just after.
    Returns (engine, endpoints, burst summary, ``ops.launches()`` over the
    run, graph replays over it by endpoint, decode steps, engine
    construction s).  Runs on any tree's engine (``tools/scan_bench.py
    --mode serve``): one that replays no graph gives no replays, and an
    older launcher, whose endpoints build their own weights in the engine,
    is called as it was."""
    if "layers" in inspect.signature(serve.make_endpoints).parameters:
        short, long_ = serve.make_endpoints(arch, True, dev, layers)
    else:
        short, long_ = serve.make_endpoints(arch, full_width=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServingEngine([short, long_], slots=2, policy="fc", seed=0,
                        device=dev)
    warm_s = time.perf_counter() - t0
    steps0 = eng.decode_steps
    ops.reset_launches()
    summ = serve.run_burst(eng, short.name, long_.name, 12, 0.3)
    counts = ops.launches()
    # warming an endpoint replays nothing: these are the run's replays
    replays = dict(getattr(eng, "replays", {}))
    return (eng, [short, long_], summ, counts, replays,
            eng.decode_steps - steps0, warm_s)


def serving_burst(arch, dev, layers=None) -> tuple[dict, list]:
    """The serving main path of ``arch`` at full width, bfloat16
    (``full_width_burst``).  Every decode step must be one replay of a
    lane's graph, each graph must have captured one launch of each kernel
    for each layer of the kernel's kind and no plain version, the replays'
    launches (replays x captured) are the path's kernel launches, and
    nothing is launched eagerly during the run.  Then the graph against
    the eager step (``graph_vs_eager``) and the step's time
    (``decode_step_time``).  Returns the numbers and the endpoints."""
    eng, eps, summ, counts, replays, steps, warm_s = full_width_burst(
        arch, dev, layers)
    cfg = eps[0].cfg
    if eps[0].params is not eps[1].params:
        raise AssertionError(f"{arch}: the endpoints hold two weight copies")
    if cfg.dtype != "bfloat16" or cfg != dataclasses.replace(
            get_config(arch), n_layers=cfg.n_layers):
        raise AssertionError(f"unexpected config {cfg}")
    per_step = {k: v for k, v in step_launches(cfg).items() if v}
    for ep in eps:
        if ep.captured != per_step or len(ep.lanes) != 2:
            raise AssertionError(f"{ep.name}: captured {ep.captured} in "
                                 f"{len(ep.lanes)} lanes, expected "
                                 f"{per_step} in 2")
    if sum(replays.values()) != steps:
        raise AssertionError(f"{arch}: {steps} decode steps, replays "
                             f"{replays}")
    if any(v["kernel"] or v["plain"] for v in counts.values()):
        raise AssertionError(f"{arch}: launched outside the graphs during "
                             f"the burst: {counts}")
    launches = eng.kernel_launches()
    if launches != {k: steps * v for k, v in per_step.items()}:
        raise AssertionError(f"{arch}: launches {launches} in {steps} "
                             f"replays of {per_step} a step")
    if summ["n"] != 12:
        raise AssertionError(f"{arch} serving burst completed {summ['n']} "
                             "of 12")
    for key in ("R_avg", "R_p50", "R_p95"):
        if not math.isfinite(summ[key]) or summ[key] <= 0:
            raise AssertionError(f"{arch} serving burst: {key} = "
                                 f"{summ[key]}")
    out = {"arch": arch, "layers": cfg.n_layers,
           "param_gb": param_bytes(cfg) / 1e9, "burst": summ,
           "steps": steps, "replays": replays,
           "per_step_launches": per_step, "launches": launches,
           "prewarm_s": warm_s,
           "ms_per_decode_step": summ["wall_s"] / summ["decode_steps"] * 1e3,
           "tokens_per_s": summ["decode_steps"] / summ["wall_s"],
           "graph_vs_eager": graph_vs_eager(eps[0]),
           "step": decode_step_time(eps[0])}
    del eng
    return out, eps


def print_burst(sv: dict) -> None:
    b = sv["burst"]
    n_rep = sum(sv["replays"].values())
    kern = ", ".join(f"{k} kernel launches {v} ({n_rep} replays x "
                     f"{sv['per_step_launches'][k]} captured), plain 0"
                     for k, v in sv["launches"].items())
    ge = sv["graph_vs_eager"]
    cut = (f" cut to {sv['layers']} layers"
           if sv["arch"] == "llama4_scout_17b_a16e" else "")
    print(f"serving main path: {sv['arch']}{cut} bf16, 2 endpoints, slots 2, "
          f"fc, one CUDA graph a lane: n={b['n']} R_avg="
          f"{b['R_avg'] * 1e3:.3f} ms R_p50={b['R_p50'] * 1e3:.3f} ms "
          f"R_p95={b['R_p95'] * 1e3:.3f} ms cold_starts={b['cold_starts']} "
          f"decode_steps={b['decode_steps']} "
          f"({sv['ms_per_decode_step']:.3f} ms per step, "
          f"{sv['tokens_per_s']:.1f} tokens/s; card "
          f"{sv['step']['device_ms']:.3f} ms a step); graph vs eager "
          f"max |diff| {ge['max_abs_diff']}"
          + (f" ({ge['cause']})" if "cause" in ge else "") + f"; {kern}",
          flush=True)
    print(f"serving details [{sv['arch']}]: " + json.dumps(sv), flush=True)


def serving_path(dev) -> dict:
    """qwen3_1_7b's serving main path (``serving_burst``), then one
    2,048-token prefill and 16 decode steps."""
    out, (short, long_) = serving_burst("qwen3_1_7b", dev)
    cfg = short.cfg
    if cfg.n_layers != QWEN3_LAYERS:
        raise AssertionError(f"unexpected config {cfg}")

    # one long prompt through flash_attention, then decode from its cache
    params = short.params
    tokens = torch.randint(0, cfg.vocab, (1, 2048),
                           generator=torch.Generator().manual_seed(2))
    cache = init_cache(cfg, 1, 2048 + 16, device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": tokens.to(dev)}, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    seq = [logits]
    t0 = time.perf_counter()
    for i in range(16):
        logits, cache = decode_step(params, cfg,
                                    logits.argmax(-1).to(torch.int32),
                                    cache, 2048 + i)
        seq.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n = ops.launches()
    if n["flash_attention"] != {"kernel": QWEN3_LAYERS, "plain": 0}:
        raise AssertionError(f"prefill: flash_attention launches "
                             f"{n['flash_attention']}")
    if n["decode_attention"] != {"kernel": 16 * QWEN3_LAYERS, "plain": 0}:
        raise AssertionError(f"decode after prefill: decode_attention "
                             f"launches {n['decode_attention']}")
    seq = torch.stack(seq)
    if seq.shape != (17, 1, cfg.padded_vocab) or not torch.isfinite(
            seq.float()).all():
        raise AssertionError(f"prefill/decode logits: shape {seq.shape}, "
                             "or not finite")
    # the same prompt again into a fresh cache: the first prefill at this
    # length also pays for its allocations and the matrix library's plans
    warm_cache = init_cache(cfg, 1, 2048 + 16, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, cfg, {"tokens": tokens.to(dev)}, warm_cache)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del warm_cache, params, cache
    out |= {"prefill_launches": n["flash_attention"]["kernel"],
            "prefill_2048_ms": t_prefill * 1e3,
            "prefill_2048_warm_ms": t_warm * 1e3,
            "decode_after_prefill_ms_per_step": t_decode / 16 * 1e3}
    release(short, long_)
    return out


def prompt_run(params, cfg, dev, batch, n, feed, force):
    """A prefill of ``batch`` (``tokens`` (1, S), and ``embeds`` and
    ``positions`` where given) and ``n`` greedy decode steps: (logits
    (n + 1, 1, V) float32, prefill s, decode s a step, the last cache).
    Step i is fed ``feed[i]``, which the first run to reach it appends (its
    own greedy token), so later runs are fed the first run's tokens."""
    S = batch["tokens"].shape[1]
    cache = init_cache(cfg, 1, S + n, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg,
                            {k: v.to(dev) for k, v in batch.items()}, cache,
                            force=force)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    seq = [logits]
    t0 = time.perf_counter()
    for i in range(n):
        if len(feed) == i:
            feed.append(logits.argmax(-1).to(torch.int32))
        logits, cache = decode_step(params, cfg, feed[i], cache, S + i,
                                    force=force)
        seq.append(logits)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / max(n, 1)
    return torch.stack(seq).float(), t_prefill, t_decode, cache


def widen(tree):
    """A parameter tree in float32 (bf16 widens exactly)."""
    if isinstance(tree, dict):
        return {k: widen(v) for k, v in tree.items()}
    return tree.float()


def long_prompt(params, cfg, dev, S=4096, n=16, gate_logits=True) -> dict:
    """An S-token bf16 prefill and n decode steps through the kernels and
    through the plain versions (fed the kernel run's greedy tokens);
    logits within BF16_LOGIT_RTOL of the largest |logit| where
    ``gate_logits``.  With S past recurrentgemma's window of 2,048 its
    ring wraps in prefill (position s in slot s % 2,048) and every decode
    step overwrites the oldest slot.  ``carriers`` says which kernel
    carries the gap (``gap_carriers``, which fails a kernel run farther
    from the float32 run than WITNESS_RATIO times the plain run); a model
    with RWKV-6 layers also runs ``scan_f64_witness`` (each call and the
    logits against a float64 scan).  Without ``gate_logits`` the
    kernel-vs-plain gap is reported, and those two witnesses decide."""
    tokens = torch.randint(0, cfg.vocab, (1, S),
                           generator=torch.Generator().manual_seed(3))
    feed = []

    def run(params, cfg, force):
        return prompt_run(params, cfg, dev, {"tokens": tokens}, n, feed,
                          force)

    runs, out = {}, {}
    per_step = step_launches(cfg)
    n_attn = per_step["decode_attention"]
    for force in (None, "ref"):
        ops.reset_launches()
        seq, t_prefill, t_decode, cache = run(params, cfg, force)
        got = ops.launches()
        side = "kernel" if force is None else "plain"
        want = {"event_step": 0, "flash_attention": n_attn,
                "decode_attention": n * n_attn,
                "rglru_scan": (n + 1) * per_step["rglru_scan"],
                "rwkv6_scan": (n + 1) * per_step["rwkv6_scan"]}
        for name, v in want.items():
            exp = {"kernel": 0, "plain": 0} | {side: v}
            if got[name] != exp:
                raise AssertionError(f"{S}-token prefill + {n} steps "
                                     f"({side}): {name} launches "
                                     f"{got[name]}, expected {exp}")
        runs[side] = seq
        out[side] = {"prefill_ms": t_prefill * 1e3,
                     "decode_ms_per_step": t_decode * 1e3,
                     "launches": {k: v[side] for k, v in got.items()
                                  if v[side]}}
    ring = {c["k"].shape[2] for c in cache["groups"].values() if "k" in c}
    del cache
    got, want = runs["kernel"], runs["plain"]
    if got.shape != (n + 1, 1, cfg.padded_vocab) or not (
            torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{S}-token prefill: logits {got.shape} or not "
                             "finite")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if gate_logits and not err <= BF16_LOGIT_RTOL * scale:
        raise AssertionError(f"{S}-token prefill + {n} steps: kernels and "
                             f"plain differ by {err} (largest |logit| "
                             f"{scale}, tolerance {BF16_LOGIT_RTOL})")
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    out |= {"S": S, "decode_steps": n, "ring_slots": sorted(ring),
            "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "rtol": BF16_LOGIT_RTOL,
            "logits_gated": gate_logits,
            "argmax_equal": f"{same}/{got.shape[0]}"}
    if any(spec.kind == "rwkv" for spec in cfg.period):
        out["scan_f64_witness"] = scan_f64_witness(
            lambda: run(params, cfg, None)[0], got, want,
            torch_dtype(cfg.dtype))
    out["carriers"] = gap_carriers(run, params, cfg, runs,
                                   list(out["kernel"]["launches"]))
    torch.cuda.empty_cache()
    return out


def gap_carriers(run, params, cfg, runs, names) -> dict:
    """Which kernel carries the kernel-vs-plain gap of ``long_prompt``.
    The kernel run once more for each kernel of the path (``names``) with
    that one kernel swapped to its plain version, and the plain versions
    in float32 on the same weights (the bf16 weights widened, exactly), a
    yardstick with little rounding.  For each bf16 run: its distance from the plain
    run and from the float32 run, over the largest |logit| of the plain
    run, at the prefill's logits and over the decode steps.  Fails if the
    kernel run lies farther than WITNESS_RATIO times the plain run from
    the float32 run."""
    def dist(a, b):
        scale = float(runs["plain"].abs().max())
        d = (a - b).abs()
        return {"prefill": float(d[0].max()) / scale,
                "decode": float(d[1:].max()) / scale}

    for name in names:
        with swapped(name, plain_version(name)):
            runs[f"{name} plain"] = run(params, cfg, None)[0]
    params32 = widen(params)
    f32 = run(params32, dataclasses.replace(cfg, dtype="float32"), "ref")[0]
    del params32
    out = {label: {"vs_plain": dist(seq, runs["plain"]),
                   "vs_f32": dist(seq, f32)}
           for label, seq in runs.items()}
    near, plain = out["kernel"]["vs_f32"], out["plain"]["vs_f32"]
    if any(near[k] > WITNESS_RATIO * plain[k] for k in near):
        raise AssertionError(f"bf16 kernel run {near} from the float32 "
                             f"run, the plain run {plain}")
    return out


def recurrent_serving(arch, dev) -> dict:
    """``arch``'s serving main path (``serving_burst``), its decode-step
    breakdown, and the 4,096-token prefill of ``long_prompt``."""
    out, eps = serving_burst(arch, dev)
    params, cfg = eps[0].params, eps[0].cfg
    release(*eps)   # the lanes and their graphs: room for a float32 copy
    out["long_prompt"] = long_prompt(params, cfg, dev,
                                     gate_logits=arch in LOGIT_GATED)
    if arch == "rwkv6_3b":
        out["gated_prompt"] = long_prompt(
            *cut_depth(params, cfg, RWKV6_GATED_LAYERS), dev, S=RWKV6_GATED_S)
    del params
    torch.cuda.empty_cache()
    return out


def llama4_layers(dev) -> int:
    """The depth of llama4_scout_17b_a16e at full width whose bf16 weights
    leave LLAMA4_FREE_GB of the card's free memory free."""
    cfg = get_config(LLAMA4)
    one, two = (param_bytes(dataclasses.replace(cfg, n_layers=k))
                for k in (1, 2))
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] - LLAMA4_FREE_GB * 1e9
    return max(1, min(cfg.n_layers, int((free - (one - (two - one)))
                                        // (two - one))))


def routing_recorder(calls: list, imposed: list | None = None):
    """A ``layers.moe_route`` that appends each call's experts (T, k) to
    ``calls``.  With ``imposed`` (another run's ``calls``), the c-th call
    takes ``imposed[c]``'s experts, weighted by its own gates renormalised
    over them: the router's own weights wherever the experts agree."""
    route = model_layers.moe_route

    def call(router, xt, k):
        w, i = route(router, xt, k)
        if imposed is not None:
            i = imposed[len(calls)]
            g = torch.softmax(xt.float() @ router.float(), dim=-1).gather(1, i)
            w = g / g.sum(-1, keepdim=True)
        calls.append(i.clone())
        return w, i
    return call


def first_flip(got: list, want: list, S: int, n_moe: int) -> dict:
    """Where two runs' routing first picks another set of experts: the
    least position (prompt positions 0..S-1 in the prefill's calls, S + i
    in decode step i's) at which any MoE layer's experts differ, its layer
    and both sets; ``flips`` counts the (call, token) pairs that differ,
    those past the first included, which it may have caused."""
    out = {"position": None, "flips": 0}
    for c, (a, b) in enumerate(zip(got, want)):
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
        rows = differ.nonzero().flatten().tolist()
        out["flips"] += len(rows)
        if not rows:
            continue
        pos = rows[0] if c < n_moe else S + (c - n_moe) // n_moe
        if out["position"] is None or pos < out["position"]:
            t = rows[0] if c < n_moe else 0
            out |= {"position": pos, "moe_layer": c % n_moe,
                    "kernel_experts": a[t].tolist(),
                    "plain_experts": b[t].tolist()}
    return out


def prompt_check(params, cfg, dev) -> dict:
    """A PROMPT_S-token bf16 prefill and PROMPT_STEPS decode steps through
    the kernels and through the plain versions (fed the kernel run's
    greedy tokens); an M-RoPE model takes random ``embeds`` and (3, 1, S)
    positions, t increasing along the prompt and h, w not.  The kernel run
    must launch flash_attention once and decode_attention PROMPT_STEPS
    times a layer, the plain run none.  ``per_call``: the kernel run once
    more with every attention call also run as its plain version on the
    same inputs, each held to ATTN_TOL (the kernels' own bf16 tolerance).
    The logits must lie within BF16_LOGIT_RTOL of the largest |logit| of
    the plain run's.  In a MoE model a bf16 difference in the router's
    input may pick another expert for a token (a jump, not rounding), so
    both runs record each MoE layer's experts (``routing_recorder``) and
    the gate holds the logits whose positions all precede the first
    token routed otherwise (``first_flip``; all of them where none is);
    then the plain versions run once more with the kernel run's routing
    imposed, and all their logits are held to the kernel run's."""
    S, n = PROMPT_S, PROMPT_STEPS
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, S), generator=gen)}
    if cfg.mrope:
        batch["embeds"] = torch.randn((1, S, cfg.d_model), generator=gen)
        t = torch.arange(S)[None]
        batch["positions"] = torch.stack([
            t, torch.randint(0, 64, (1, S), generator=gen),
            torch.randint(0, 64, (1, S), generator=gen)]).to(torch.int32)
    n_attn = step_launches(cfg)["decode_attention"]
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    feed, runs, routes, out = [], {}, {}, {}
    for force in (None, "ref"):
        side = "kernel" if force is None else "plain"
        routes[side] = []
        ops.reset_launches()
        with swapped("moe_route", routing_recorder(routes[side]),
                     model_layers):
            seq, t_prefill, t_decode, cache = prompt_run(
                params, cfg, dev, batch, n, feed, force)
        got = ops.launches()
        for name, v in (("flash_attention", n_attn),
                        ("decode_attention", n * n_attn)):
            exp = {"kernel": 0, "plain": 0} | {side: v}
            if got[name] != exp:
                raise AssertionError(f"{cfg.name} prompt check ({side}): "
                                     f"{name} launches {got[name]}, "
                                     f"expected {exp}")
        if len(routes[side]) != (n + 1) * n_moe:
            raise AssertionError(f"{cfg.name} prompt check ({side}): "
                                 f"{len(routes[side])} routings, expected "
                                 f"{(n + 1) * n_moe}")
        runs[side] = seq
        out[side] = {"prefill_ms": t_prefill * 1e3,
                     "decode_ms_per_step": t_decode * 1e3}
    del cache
    per_call = dict.fromkeys(("flash_attention", "decode_attention"), 0.0)

    def both(name):
        def call(*a, force=None, **kw):
            got = kernel[name](*a, **kw)
            err = float((got.float() - kernel[name](
                *a, force="ref", **kw).float()).abs().max())
            per_call[name] = max(per_call[name], err)
            return got
        return call

    kernel = {name: getattr(ops, name) for name in per_call}
    with swapped("flash_attention", both("flash_attention")), \
            swapped("decode_attention", both("decode_attention")):
        prompt_run(params, cfg, dev, batch, n, feed, None)
    if not all(v <= ATTN_TOL[torch.bfloat16] for v in per_call.values()):
        raise AssertionError(f"{cfg.name} prompt check: kernel against plain "
                             f"on the same inputs {per_call} (tolerance "
                             f"{ATTN_TOL[torch.bfloat16]})")
    got, want = runs["kernel"], runs["plain"]
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{cfg.name} prompt check: logits not finite")

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    out |= {"S": S, "decode_steps": n, "embeds": "embeds" in batch,
            "flash_launches": n_attn, "decode_launches": n * n_attn,
            "per_call_max_abs_err": per_call,
            "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "argmax_equal": f"{same}/{n + 1}"}
    gated = n + 1
    if n_moe:
        flip = first_flip(routes["kernel"], routes["plain"], S, n_moe)
        # logits entry j (the prefill's, then step j - 1's) reads positions
        # up to S - 1 + j
        if flip["position"] is not None:
            gated = min(n + 1, max(0, flip["position"] - S + 1))
        imposed = []
        with swapped("moe_route", routing_recorder(imposed, routes["kernel"]),
                     model_layers):
            forced = prompt_run(params, cfg, dev, batch, n, feed, "ref")[0]
        out["routing"] = flip | {
            "moe_calls": len(routes["kernel"]),
            "imposed_rel_err": rel(got, forced),
            "imposed_argmax_equal":
                f"{int((got.argmax(-1) == forced.argmax(-1)).sum())}"
                f"/{n + 1}"}
        if not out["routing"]["imposed_rel_err"] <= BF16_LOGIT_RTOL:
            raise AssertionError(f"{cfg.name} prompt check: with the kernel "
                                 f"run's routing imposed on the plain run "
                                 f"{out['routing']} (tolerance "
                                 f"{BF16_LOGIT_RTOL})")
    out["gated_logits"] = f"{gated}/{n + 1}"
    if gated:
        out["gated_rel_err"] = rel(got[:gated], want[:gated])
        if not out["gated_rel_err"] <= BF16_LOGIT_RTOL:
            raise AssertionError(f"{cfg.name} prompt check: kernels and "
                                 f"plain differ by {out['gated_rel_err']} of "
                                 f"the largest |logit| over the first "
                                 f"{gated} logits (tolerance "
                                 f"{BF16_LOGIT_RTOL})")
    return out


def family_serving(arch, dev, layers=None) -> dict:
    """``arch``'s serving main path (``serving_burst``), then its prompt
    check (``prompt_check``)."""
    out, eps = serving_burst(arch, dev, layers)
    params, cfg = eps[0].params, eps[0].cfg
    release(*eps)
    out["prompt_check"] = prompt_check(params, cfg, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=40,
                    help="seeds of the mega grid to run (the grid has 2000)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    for launcher in ops.EVENT_STEP_LAUNCHERS:
        ops._event_step_lib(launcher)
    dec_mod._lib()
    for dtype in flash_mod.SOURCE:
        flash_mod._lib(dtype)
    rglru_mod._lib()
    rwkv6_mod._lib()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(logs) or 'cached'}); nvcc seconds by source: "
          + json.dumps({k: round(v, 1) for k, v in
                        sorted(build.BUILD_SECONDS.items())}), flush=True)
    for src, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {src}: {line}")

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 2. kernel vs plain on the card, at the mega bucket shapes --------
    sept = check_kernel("sept", 256, dev, timed=True)
    fc = check_kernel("fc", 256, dev, timed=True)
    pad = check_kernel("rect", 100, dev, timed=False)   # 28 padded cells
    # 16 nodes x 18 cores pad to 512 slots: the wide path
    wide = check_kernel("fc", 20, dev, timed=True, tile=False, nodes=16,
                        cores=18)
    if not wide["plan"]["wide"]:
        raise AssertionError(f"16 x 18 cores: plan {wide['plan']}")
    for r in (sept, fc, pad, wide):
        print("event_step vs plain: " + json.dumps(r), flush=True)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3. the main path --------------------------------------------------
    cells, rows, wall, timings, launches, ref_launches = main_sweep(
        args.seeds, dev)
    phase1 = (cells, rows, wall)      # phase 3j runs the same cells
    if launches == 0 or ref_launches != 0:
        raise AssertionError(f"main path launches: kernel {launches}, "
                             f"plain {ref_launches}")
    for c, r in zip(cells, rows):
        want = 11 * max(1, round(16 * c.intensity / 10))
        if r["n"] != want:
            raise AssertionError(f"{c.label()} seed {c.seed}: n={r['n']}, "
                                 f"burst has {want}")
        for k in ("R_avg", "R_p95", "max_c"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{c.label()} seed {c.seed}: {k}="
                                     f"{r[k]}")
    print(f"main path: {len(cells)} cells in {wall:.3f} s = "
          f"{len(cells) / wall:.1f} cells/s (fill {timings['fill_s']:.3f} s, "
          f"device {timings['device_s']:.3f} s = "
          f"{timings['device_s'] / wall:.1%} of the wall, fold "
          f"{timings['fold_s']:.3f} s, other "
          f"{wall - sum(timings.values()):.3f} s); kernel launches "
          f"{launches}, plain launches {ref_launches}", flush=True)

    # stratified sample: every (policy, intensity, nodes) stratum once,
    # the seed rotating over the strata
    index = {(c.policy, c.intensity, c.nodes, c.seed): i
             for i, c in enumerate(cells)}
    strata = sorted({k[:3] for k in index})
    sample = [index[s + (k % args.seeds,)] for k, s in enumerate(strata)]
    want = plain_rows([cells[i] for i in sample], dev)
    for i, w in zip(sample, want):
        if rows[i] != w:
            raise AssertionError(f"{cells[i].label()} seed {cells[i].seed}: "
                                 "kernel row differs from the plain row")
    print(f"sample: {len(sample)} cells recomputed through the plain "
          "version on the card, rows equal", flush=True)

    kern = {"name": "event_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_step.cu",
            "replaces": "src/repro/kernels/event_step.py:52",
            "launches": launches, "launches_by_path": {"main path": launches},
            "max_abs_err": max(sept["max_abs_err"], fc["max_abs_err"],
                               pad["max_abs_err"], wide["max_abs_err"]),
            "ms": fc["ms"], "plain_ms": fc["plain_ms"],
            "bound_ms": fc["bound_ms"], "bound_by": fc["bound_by"],
            "library_ms": None,
            "shape": f"fc bucket, {fc['bsz']} cells, n_b={fc['n_b']}, "
                     "4 nodes x 8 slots",
            "sept_ms": sept["ms"], "sept_plain_ms": sept["plain_ms"],
            "sept_bound_ms": sept["bound_ms"], "ms_4096": fc["ms_4096"],
            "bound_ms_4096": fc["bound_ms_4096"],
            "sept_ms_4096": sept["ms_4096"],
            "sept_bound_ms_4096": sept["bound_ms_4096"],
            "ns_per_step": fc["ns_per_step"],
            "ns_per_step_4096": fc["ns_per_step_4096"],
            "sept_ns_per_step": sept["ns_per_step"],
            "plan": fc["plan"], "sweep_cells_per_s": len(cells) / wall,
            "sweep_device_s": timings["device_s"],
            "sweep_device_share": timings["device_s"] / wall,
            "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
            "wide_bound_ms": wide["bound_ms"],
            "wide_ns_per_step": wide["ns_per_step"],
            "wide_shape": f"fc bucket, {wide['cells']} cells, "
                          f"n_b={wide['n_b']}, 16 nodes x 18 cores"}

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3b. the frozen-priority kernel vs plain, then its main paths ------
    # (plain versions held to at most 256 cells a bucket)
    fz = {
        "single_fc_c10_v120": check_freeze(
            "single fc c10 v120", [("fc", 1, 10, 120, s, None, 10)
                                   for s in range(256)], dev),
        "single_sept_c10_v120": check_freeze(
            "single sept c10 v120", [("sept", 1, 10, 120, s, None, 10)
                                     for s in range(256)], dev),
        "push_fc_ll_4x8": check_freeze(
            "push fc least_loaded 4x8 v30", [
                ("fc", 4, 8, 30, s, "least_loaded", 16)
                for s in range(256)], dev),
        "push_fc_home_4x8": check_freeze(
            "push fc home 4x8 v30", [("fc", 4, 8, 30, s, "home", 16)
                                     for s in range(256)], dev),
        "push_fc_home_fig6": check_freeze(
            "push fc home 4x18 v30 (72-core burst)", [
                ("fc", 4, 18, 30, s, "home", 72) for s in range(64)], dev),
        "push_fc_home_16x18": check_freeze(
            "push fc home 16x18 v5 (288-core burst)", [
                ("fc", 16, 18, 5, 0, "home", 288)], dev),
    }
    if not fz["push_fc_home_16x18"]["plan"]["wide"]:
        raise AssertionError(f"16 x 18 push: {fz['push_fc_home_16x18']}")
    for r in fz.values():
        print("freeze event_step vs plain: " + json.dumps(r), flush=True)
    single, _ = freeze_path("single-node path", table3_cells(48), dev)
    push, _ = freeze_path("push path", push_cells(20), dev)
    main_fz = fz["single_fc_c10_v120"]
    kern_fz = {
        "name": "event_step_freeze", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step.cu",
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": single["launches"] + push["launches"],
        "launches_by_path": {"single-node path": single["launches"],
                             "push path": push["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in fz.values()),
        "ms": main_fz["ms"], "plain_ms": main_fz["plain_ms"],
        "bound_ms": main_fz["bound_ms"], "bound_by": main_fz["bound_by"],
        "library_ms": None,
        "shape": f"single fc c10 v120, {main_fz['bsz']} cells, "
                 f"n_b={main_fz['n_b']}",
        "ns_per_step": main_fz["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "ns_per_step", "n_b", "bsz")}
                  for k, r in fz.items()},
        "single_cells_per_s": single["cells_per_s"],
        "single_device_share": single["device_share"],
        "push_cells_per_s": push["cells_per_s"],
        "push_device_share": push["device_share"]}

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3c. capacity dynamics and node speeds: the float64 pull kernel vs
    # plain, then the autoscaler frontier and the straggler grid -----------
    # the frontier and straggler checks' cells are a stratified sample of
    # their grids' float64 cells, so their plain rows hold the paths' rows
    fr80 = frontier_cells(5)
    st75 = straggler_pull_cells()
    dy, plain = {}, {}
    for k, case, cells in (
            ("frontier", "frontier fc 2-5 x 8 cores -> 7, pd 10 / 30 / 60, "
             "v40 (40-core burst)", dyn_sample(fr80)),
            ("straggler", "straggler pull fc 4 x 8, v18 / v45 / v96, node 0 "
             "2-8x slow (n_b 4096)", dyn_sample(st75)),
            ("fail_het", "pull fc 3 x 6, rolling kill at 8 s, node 0 5x "
             "slow, v16 / v45", [
                 sweep.SweepCell(policy="fc", nodes=3, cores=6,
                                 intensity=v, seed=s, fail_spec=((0, 8.0),),
                                 degrade=((0, 1.0, 300.0, 5.0),))
                 for v in (16, 45) for s in range(4)]),
            ("wide", "pull 34 x 1 core -> 40 nodes, node 3 killed at 5 s, "
             "fifo / eect / rect v60 (the wide path)", wide_dyn_cells())):
        dy[k], rows_k = check_f64(case, cells, dev)
        plain.update(rows_k)
        print("dyn event_step vs plain: " + json.dumps(dy[k]), flush=True)
    if sum(dy["fail_het"]["failures"]) == 0:
        raise AssertionError("the failure bucket lost no call")
    if not dy["wide"]["plan"]["wide"] or sum(dy["wide"]["failures"]) == 0:
        raise AssertionError(f"the wide bucket: {dy['wide']}")
    frontier, fr_rows = dyn_path("frontier path", fr80, dev, plain)
    fr640 = frontier_cells(40)
    cut, cut_rows = dyn_path("frontier 40-seed path", fr640, dev)
    if [r for c, r in zip(fr640, cut_rows) if c.seed < 5] != fr_rows:
        raise AssertionError("the 40-seed cut's first 5 seeds differ from "
                             "the frontier grid's rows")
    print("frontier 40-seed path: its rows of seeds 0-4 equal the frontier "
          "path's", flush=True)
    straggler, _ = dyn_path("straggler pull path", st75, dev, plain)
    for line in frontier_claim(fr80, fr_rows):
        print(f"frontier: {line}", flush=True)
    main_dy = dy["frontier"]
    paths_dy = {"frontier path": frontier["launches"],
                "frontier 40-seed path": cut["launches"],
                "straggler pull path": straggler["launches"]}
    kern_dy = {
        "name": "event_step_dyn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step.cu",
        "replaces": "src/repro/core/fastpath.py:821",
        "launches": sum(paths_dy.values()), "launches_by_path": paths_dy,
        "max_abs_err": max(r["max_abs_err"] for r in dy.values()),
        "ms": main_dy["ms"], "plain_ms": main_dy["plain_ms"],
        "bound_ms": main_dy["bound_ms"], "bound_by": main_dy["bound_by"],
        "library_ms": None,
        "shape": f"frontier bucket, {main_dy['cells']} cells, "
                 f"n_b={main_dy['n_b']}, up to 7 of 8 nodes x 8 slots",
        "ns_per_step": main_dy["ns_per_step"],
        "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "ns_per_step", "n_b", "bsz",
                                         "plan")}
                  for k, r in dy.items()},
        **{f"{k}_{f}": r[f] for k, r in (("frontier", frontier),
                                          ("frontier_640", cut),
                                          ("straggler", straggler))
           for f in ("cells_per_s", "device_share")}}

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3d. workloads and cold starts ------------------------------------
    workload_paths(dev, kern_fz, kern_dy)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3e. cold starts, node speeds and dynamics on push and one node ----
    kern_f64 = freeze64_paths(dev, kern_fz)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3f. straggler hedging: steal and duplicate ----------------------
    kern_hedge = hedge_paths(dev, {"event_step": kern,
                                   "event_step_freeze": kern_fz,
                                   "event_step_dyn": kern_dy,
                                   "event_step_freeze64": kern_f64})

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3g. request resilience: timeouts, retries, shedding ---------------
    kern_res = res_paths(dev, kern_fz)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3h. the chunked stream replay on pull: the planet fleet -----------
    kern_stream = stream_paths(dev)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3i. the chunked stream replay on push and one node: the planet
    # fleet under push ----------------------------------------------------
    kern_fstream = freeze_stream_paths(dev, kern_stream["planet"])

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 3j. the sweep runner: run_sweep, run_cell's stream routing --------
    rn = runner_paths(dev, *phase1)
    for row_k in (kern, kern_fz, kern_dy, kern_f64, kern_hedge, kern_res,
                  kern_stream, kern_fstream):
        for label, n in rn["launches"].get(row_k["name"], {}).items():
            row_k["launches_by_path"][label] = n
            row_k["launches"] += n
    kern["sweep_runner"] = rn["runner"]

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 4. attention kernels vs plain on the card ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    full = [1, 300, 32768, 17000, 4096, 32768, 9999, 32768]
    dec = {
        "decode_32k": check_decode(8, 32768, 16, 8, 128, bf, full, dev, gen),
        "f32_4k": check_decode(8, 4096, 16, 8, 128, f32,
                               [min(n, 4096) for n in full], dev, gen),
        "serving": check_decode(1, 36, 16, 8, 128, bf, [20], dev, gen),
        "deepseek_mha": check_decode(4, 4096, 32, 32, 128, bf,
                                     [4096, 1, 2500, 4000], dev, gen),
        "zero_and_odd": check_decode(3, 1000, 16, 8, 128, bf, [0, 1000, 537],
                                     dev, gen, timed=False),
        # recurrentgemma_9b: MQA, 16 query heads of 256; its full window
        # ring and its serving cache
        "rg_ring_2k": check_decode(1, 2048, 16, 1, 256, bf, [2048], dev,
                                   gen),
        "rg_serving": check_decode(1, 36, 16, 1, 256, bf, [20], dev, gen),
        "rg_f32_odd": check_decode(3, 1000, 16, 1, 256, f32, [0, 1000, 537],
                                   dev, gen, timed=False),
    }
    # every served family's decode heads at the launcher's cache lengths
    # (one split, no merge: Sk <= ONE_SPLIT_KEYS), a row for each length
    # 0..Sk a call's steps reach
    for Hq, Hkv, dh in serving_heads():
        for _, p, g in serve.PROFILES:
            Sk = Endpoint("", None, prompt_len=p, gen_len=g).cache_len
            dec[f"serving_{Hq}_{Hkv}_{dh}_{Sk}"] = check_decode(
                Sk + 1, Sk, Hq, Hkv, dh, bf, list(range(Sk + 1)), dev, gen,
                timed=False)
    fl = {
        "prefill_4k": check_flash(1, 4096, 4096, 16, 8, 128, bf, dev, gen),
        "serving_2k": check_flash(1, 2048, 2048, 16, 8, 128, bf, dev, gen),
        "window": check_flash(1, 2048, 2048, 16, 8, 128, bf, dev, gen,
                              window=1024),
        "bidirectional": check_flash(1, 1024, 1024, 16, 8, 128, bf, dev,
                                     gen, causal=False),
        "sq_lt_sk": check_flash(1, 512, 2048, 16, 8, 128, bf, dev, gen),
        "odd_f32": check_flash(1, 1000, 1000, 16, 8, 128, f32, dev, gen),
        "odd_bf16": check_flash(2, 777, 777, 16, 8, 128, bf, dev, gen,
                                timed=False),
        "deepseek_mha": check_flash(1, 2048, 2048, 32, 32, 128, bf, dev,
                                    gen),
        "masked_rows": check_flash(1, 300, 200, 16, 8, 128, f32, dev, gen,
                                   timed=False),
        # recurrentgemma_9b's prefill width: window 2,048, 16/1/256
        "rg_prefill_4k": check_flash(1, 4096, 4096, 16, 1, 256, bf, dev, gen,
                                     window=2048),
        "rg_f32_odd": check_flash(1, 1000, 1000, 16, 1, 256, f32, dev, gen,
                                  window=300, timed=False),
    }
    for case, r in dec.items():
        print(f"decode_attention vs plain [{case}]: " + json.dumps(r),
              flush=True)
    for case, r in fl.items():
        print(f"flash_attention vs plain [{case}]: " + json.dumps(r),
              flush=True)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 5. the recurrence kernels vs plain on the card --------------------
    # recurrentgemma_9b's RG-LRU width (4,096) and rwkv6_3b's heads (40 of
    # 64), at the prefill length of 4,096 and at one decode step
    # (B = 2, widths whose rows are not 16-byte aligned, decays from 0 to
    # 1 at the edges of rwkv6_scan's chunks, float32 at S = 4,096)
    C = rwkv6_mod.CHUNK
    rg = {
        "prefill_4k": check_rglru(1, 4096, 4096, bf, dev, gen),
        "decode": check_rglru(1, 1, 4096, bf, dev, gen),
        "f32_odd": check_rglru(3, 333, 1000, f32, dev, gen, timed=False),
        "slots": check_rglru(2, 1, 4096, bf, dev, gen, timed=False),
        "b2_4k": check_rglru(2, 4096, 4096, bf, dev, gen, timed=False),
        "w700": check_rglru(1, 4096, 700, bf, dev, gen, timed=False),
        "w1": check_rglru(1, 4096, 1, bf, dev, gen, timed=False),
    }
    rw = {
        "prefill_4k": check_rwkv6(1, 4096, 40, 64, bf, dev, gen),
        "decode": check_rwkv6(1, 1, 40, 64, bf, dev, gen),
        "f32_odd": check_rwkv6(2, 77, 40, 64, f32, dev, gen, timed=False),
        "f32_prefill_4k": check_rwkv6(1, 4096, 40, 64, f32, dev, gen),
        **{f"extreme_{S}": check_rwkv6(2, S, 40, 64, f32, dev, gen,
                                       timed=False, extreme=True)
           for S in (C - 1, C, C + 1, 4096)},
        "extreme_4096_bf16": check_rwkv6(2, 4096, 40, 64, bf, dev, gen,
                                         timed=False, extreme=True),
    }
    for case, r in rg.items():
        print(f"rglru_scan vs plain [{case}]: " + json.dumps(r), flush=True)
    for case, r in rw.items():
        print(f"rwkv6_scan vs plain [{case}]: " + json.dumps(r), flush=True)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 6. the models at full width, float32, kernels vs plain ------------
    for arch in ("qwen3_1_7b", "recurrentgemma_9b", "rwkv6_3b"):
        mf = model_f32(arch, dev)
        print(f"{arch} float32, 512-token prefill + 8 decode steps, kernels "
              "vs plain versions: " + json.dumps(mf), flush=True)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 7. the serving main paths at full width, bfloat16 ------------------
    # each burst runs with every count set to 0 just before it and read
    # just after (serving_burst)
    sv = serving_path(dev)
    print_burst(sv)
    rec = {arch: recurrent_serving(arch, dev)
           for arch in ("recurrentgemma_9b", "rwkv6_3b")}
    for r in rec.values():
        print_burst(r)
    lp = rec["recurrentgemma_9b"]["long_prompt"]
    print(f"recurrentgemma_9b bf16, {lp['S']}-token prefill (ring of "
          f"{lp['ring_slots']} slots) + {lp['decode_steps']} decode steps, "
          f"kernels vs plain versions: " + json.dumps(lp), flush=True)
    lpw = rec["rwkv6_3b"]["long_prompt"]
    print(f"rwkv6_3b bf16, {lpw['S']}-token prefill + "
          f"{lpw['decode_steps']} decode steps, kernels vs plain versions: "
          f"prefill_ms {lpw['kernel']['prefill_ms']:.3f} (plain "
          f"{lpw['plain']['prefill_ms']:.3f}); " + json.dumps(lpw),
          flush=True)
    gp = rec["rwkv6_3b"]["gated_prompt"]
    print(f"rwkv6_3b bf16 cut to {RWKV6_GATED_LAYERS} layer(s), {gp['S']}-"
          f"token prefill + {gp['decode_steps']} decode steps, kernels vs "
          f"plain versions, logits gated: rel_err {gp['rel_err']:.4g} (rtol "
          f"{gp['rtol']}); " + json.dumps(gp), flush=True)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    # -- 8. the other decoder-only families at full width, bfloat16 (5.) ---
    more = {arch: family_serving(arch, dev) for arch in MORE_ARCHS}
    more[LLAMA4] = family_serving(LLAMA4, dev, llama4_layers(dev))
    print(f"{LLAMA4}: {more[LLAMA4]['layers']} of "
          f"{get_config(LLAMA4).n_layers} layers at full width "
          f"({more[LLAMA4]['param_gb']:.1f} GB of bf16 weights), the depth "
          f"that leaves {LLAMA4_FREE_GB} GB of the card free", flush=True)
    for r in more.values():
        print_burst(r)
        pc = r["prompt_check"]
        rt = pc.get("routing")
        gate = f"{pc['gated_logits']} logits gated at rtol {BF16_LOGIT_RTOL}"
        if rt:
            gate = ("MoE routing first differs at "
                    + (f"position {rt['position']} (MoE layer "
                       f"{rt['moe_layer']}: experts {rt['kernel_experts']} "
                       f"against {rt['plain_experts']})"
                       if rt["position"] is not None else "no position")
                    + f"; {gate}; with the kernel run's routing imposed on "
                    f"the plain run rel_err {rt['imposed_rel_err']:.4g}")
        print(f"{r['arch']} bf16, {pc['S']}-token prefill"
              + (" (embeds, 3D positions)" if pc["embeds"] else "")
              + f" + {pc['decode_steps']} decode steps, kernels vs plain "
              f"versions: rel_err {pc['rel_err']:.4g} ({gate}), each "
              f"attention call within {ATTN_TOL[torch.bfloat16]} of its "
              "plain version; " + json.dumps(pc), flush=True)

    # kernel launches of each serving path, by kernel
    paths = {
        "qwen3_1_7b burst": sv["launches"],
        "qwen3_1_7b 2048-token prefill + 16 steps": {
            "flash_attention": sv["prefill_launches"],
            "decode_attention": 16 * QWEN3_LAYERS},
        "recurrentgemma_9b burst": rec["recurrentgemma_9b"]["launches"],
        "recurrentgemma_9b 4096-token prefill + 16 steps":
            lp["kernel"]["launches"],
        "rwkv6_3b burst": rec["rwkv6_3b"]["launches"],
        "rwkv6_3b 4096-token prefill + 16 steps": lpw["kernel"]["launches"],
        f"rwkv6_3b ({RWKV6_GATED_LAYERS} layer) {gp['S']}-token prefill + "
        "16 steps (gated)": gp["kernel"]["launches"],
    }
    for arch, r in more.items():
        paths[f"{arch} burst"] = r["launches"]
        pc = r["prompt_check"]
        paths[f"{arch} {pc['S']}-token prefill + {pc['decode_steps']} "
              "steps"] = {"flash_attention": pc["flash_launches"],
                          "decode_attention": pc["decode_launches"]}

    def by_path(name):
        return {p: n[name] for p, n in paths.items() if n.get(name)}

    def row(name, main, side, replaces, cases):
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": replaces,
               "launches": sum(by_path(name).values()),
               "launches_by_path": by_path(name),
               "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
               "ms": main["ms"], "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "library_ms": main["library_ms"], "shape": main["shape"]}
        if "device_ms" in main:
            out["device_ms"] = main["device_ms"]
        for side_name, r in side.items():
            out |= {f"{side_name}_{k}": r[k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                "library_ms") if k in r}
        return out

    flash_row = row("flash_attention", fl["prefill_4k"],
                    {"main_path": fl["serving_2k"], "rg": fl["rg_prefill_4k"]},
                    "src/repro/kernels/flash_attention.py:28", fl)
    # bfloat16 (every timed case and the serving path) on the tensor cores,
    # float32 on the CUDA cores
    flash_row["source"] = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
    flash_row["sources"] = {
        str(dtype)[6:]: f"src/repro_torch/kernels/csrc/{name}.cu"
        for dtype, name in flash_mod.SOURCE.items()}
    kernels = [
        kern,
        kern_fz,
        kern_dy,
        kern_f64,
        kern_hedge,
        kern_res,
        kern_stream,
        kern_fstream,
        flash_row,
        row("decode_attention", dec["decode_32k"],
            {"main_path": dec["serving"], "rg": dec["rg_ring_2k"],
             "rg_main_path": dec["rg_serving"]},
            "src/repro/kernels/decode_attention.py:27", dec),
        row("rglru_scan", rg["prefill_4k"], {"decode": rg["decode"]},
            "src/repro/kernels/rglru_scan.py:23", rg),
        row("rwkv6_scan", rw["prefill_4k"],
            {"decode": rw["decode"], "f32": rw["f32_prefill_4k"]},
            "src/repro/kernels/rwkv6_scan.py:27", rw),
    ]
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
