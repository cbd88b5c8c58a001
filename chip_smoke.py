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
   engine in bfloat16 (two endpoints, estimator warm-up, a burst of 12
   calls, policy fc), and one 2,048-token prefill with 16 decode steps.
3. The serving path at the full widths of recurrentgemma_9b (RG-LRU,
   RG-LRU, MQA attention with window 2,048, head_dim 256; 38 layers) and
   rwkv6_3b (32 RWKV-6 layers, 40 heads of 64): ``rglru_scan`` and
   ``rwkv6_scan`` at the prefill width (S = 4,096) and at S = 1, the
   attention kernels at recurrentgemma's width; each model in float32, a
   512-token prefill and 8 decode steps, kernels against plain versions
   (rwkv6_3b also against its scan in float64); each served in bfloat16
   as in 2; and one 4,096-token bf16 prefill with 16 decode steps on
   recurrentgemma, which wraps its window-2,048 ring, kernels against
   plain versions, one kernel at a time and float32.

Any failure exits non-zero.  The last lines are the card's name and power
limit, one JSON object with each kernel's numbers, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import fastpath  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.planes import make_planes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels.decode_attention import split_plan  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv6_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode_step, init, init_cache  # noqa: E402
from repro_torch.models import prefill  # noqa: E402
from repro_torch.models.model import torch_dtype  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_S = 67e12        # H100 SXM float32 rate outside the tensor cores
BF16_OPS_S = 989e12       # H100 SXM dense bf16 tensor-core rate
PEAK_OPS = {torch.float32: FP32_OPS_S, torch.bfloat16: BF16_OPS_S}
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def mega_bucket(policy: str, n_cells: int, seed0: int = 0):
    """Host inputs of a real mega-grid bucket: intensity 30 on 4 nodes x 8
    cores, bursts sized for 16 cores (n_b = 1024)."""
    cells = []
    for s in range(seed0, seed0 + n_cells):
        c = sweep.SweepCell(policy=policy, nodes=4, cores=8, intensity=30,
                            seed=s, workload_cores=16)
        reqs = sweep.make_workload(c)
        cells.append(fastpath._ScanCell(
            requests=reqs, feats=fastpath._arrival_features(reqs),
            cores=8, nodes=4, policy=policy))
    keys = {c.bucket() for c in cells}
    if len(keys) != 1:
        raise AssertionError(f"cells span several bucket shapes: {keys}")
    (key,) = keys
    return key, cells, fastpath._fill_bucket(key, cells)


def bucket_tensors(key, host, dev):
    """A filled bucket on the card, its carry planes and its static
    ``event_step`` arguments, as the bucket runner makes them."""
    static = fastpath._scan_static(key)
    inp = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    return inp, clk, ctr, static


def time_graph(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` captured once in a CUDA graph and
    replayed: the card's time without the host's launch gaps, which set
    ``time_call`` for a kernel of a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_call(graph.replay, reps)


def time_call(fn, reps: int) -> float:
    """Milliseconds per call by CUDA events, after one warm-up call."""
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


def needed_bytes(cells, f_len: int, i_len: int, use_fc: bool) -> int:
    """Bytes the scan of ``cells`` must move, each read once and each write
    once, counted from each cell's own size rather than the bucket's padded
    one.  A cell of ``n`` calls over ``F`` functions reads its carry planes,
    rows ``[:n+1]`` of t / fnid / p / cost (row ``n`` is the +inf tail and
    the no-op index), the ``(n+1) x F`` counts it looks up with FC (none
    without), the ``n`` queue entries of ``fn_ev``, four coefficients,
    cores and nodes, and writes rows ``[:n]`` of the four outputs."""
    total = 0
    for c in cells:
        n, n_fns = len(c.feats.t), len(c.feats.fns)
        total += 4 * (f_len + i_len + 4 * (n + 1) + n + 4 + 2 + 4 * n)
        if use_fc:
            total += 4 * (n + 1) * n_fns
    return total


def check_kernel(policy: str, n_cells: int, dev, timed: bool) -> dict:
    """Kernel against the plain version on the card: rows [:n_b] of all
    four outputs must be bit-identical."""
    key, cells, host = mega_bucket(policy, n_cells)
    inp, clk, ctr, static = bucket_tensors(key, host, dev)
    n_b = key[1]
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
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
           "n_b": n_b, "max_abs_err": err}
    if timed:
        out["ms"] = time_call(lambda: ops.event_step(
            clk, ctr, inp, **static), reps=20)
        out["plain_ms"] = time_call(lambda: ops.event_step(
            clk, ctr, inp, force="ref", **static), reps=1)
        moved = needed_bytes(cells, int(clk.shape[1]), int(ctr.shape[1]),
                             static["use_fc"])
        # floating-point operations this data needs: 2 n events per cell;
        # per event a ring update (2) and the dispatch (3), and per queued
        # function its estimate and priority (6, 9 with FC counts)
        per_fn = 9 if static["use_fc"] else 6
        ops_n = sum(2 * n * (5 + len(c.feats.fns) * per_fn)
                    for n, c in zip(n_real, cells))
        # occupancy: the same bucket tiled to 4096 cells, enough one-warp
        # blocks to fill every SM
        wide = {k: v.repeat(16, *([1] * (v.dim() - 1)))
                for k, v in inp.items()}
        wclk, wctr = clk.repeat(16, 1), ctr.repeat(16, 1)
        out["ms_4096"] = time_call(lambda: ops.event_step(
            wclk, wctr, wide, **static), reps=5)
        out["bytes"] = moved
        out["operations"] = ops_n
        t_bytes = moved / HBM_BYTES_S * 1e3
        t_ops = ops_n / FP32_OPS_S * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out["bound_ms_4096"] = 16 * out["bound_ms"]
    return out


def plain_rows(cells, dev) -> list[dict]:
    """Metrics rows of ``cells`` through the plain version on the card,
    composed from the bucket runner's own steps (bucket, fill, planes, scan,
    metrics fold)."""
    groups: dict[tuple, list[int]] = {}
    prepared = []
    for i, c in enumerate(cells):
        reqs = sweep.make_workload(c)
        sc = fastpath._ScanCell(requests=reqs,
                                feats=fastpath._arrival_features(reqs),
                                cores=c.cores, nodes=c.nodes,
                                policy=c.policy)
        prepared.append(sc)
        groups.setdefault(sc.bucket(), []).append(i)
    rows: list = [None] * len(cells)
    for key, idxs in groups.items():
        part = [prepared[i] for i in idxs]
        inp, clk, ctr, static = bucket_tensors(
            key, fastpath._fill_bucket(key, part), dev)
        finish = ops.event_step(clk, ctr, inp, force="ref",
                                **static)[1].cpu().numpy()
        for b, i in enumerate(idxs):
            mo = fastpath._cell_scan_metrics(
                part[b], finish[b].astype(np.float64), {})
            rows[i] = sweep._metrics_from_scan(cells[i], mo)
    return rows

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
        out["plain_ms"] = time_call(lambda: ops.rglru_scan(
            a, gx, h0, force="ref"), 2)
        out["library_ms"] = None
    return out


def check_rwkv6(B, S, H, dh, dtype, dev, gen, timed=True) -> dict:
    """rwkv6_scan against its plain version from a nonzero state; outputs
    within RWKV6_TOL, the last state within 1e-5 (float32)."""
    r = randn(gen, (B, S, H, dh), dtype, dev)
    k = randn(gen, (B, S, H, dh), dtype, dev) * 0.2
    v = randn(gen, (B, S, H, dh), dtype, dev) * 0.2
    w = 0.9 + 0.099 * torch.rand((B, S, H, dh), generator=gen, device=dev)
    u = randn(gen, (H, dh), dtype, dev) * 0.1
    s0 = randn(gen, (B, H, dh, dh), torch.float32, dev)
    want = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    k0 = ops.RWKV6_LAUNCHES
    got = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    if ops.RWKV6_LAUNCHES != k0 + 1:
        raise AssertionError("rwkv6_scan did not launch the kernel")
    shape = f"B={B} S={S} H={H} dh={dh} {str(dtype)[6:]}"

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
        out["plain_ms"] = time_call(lambda: ops.rwkv6_scan(
            r, k, v, w, u, s0, force="ref"), 1)
        out["library_ms"] = None
    return out


@contextlib.contextmanager
def swapped(name, fn):
    """``ops.<name>`` is ``fn`` while the block runs: the model looks its
    kernels up in ``ops`` at every call, so this changes one kernel of a
    run and leaves the others as they are."""
    kept = getattr(ops, name)
    setattr(ops, name, fn)
    try:
        yield kept
    finally:
        setattr(ops, name, kept)


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
        out["scan_f64_witness"] = scan_f64_witness(run, got, want)
    del params
    torch.cuda.empty_cache()
    return out


def scan_f64_witness(run, got, want) -> dict:
    """Where a float32 model's kernel-vs-plain gap comes from when it runs
    ``rwkv6_scan``.  The model runs once more with every ``rwkv6_scan``
    call done in float64 (the plain version on float64 copies, rounded
    back to float32) and everything else as before.  ``per_call``: over
    the run's calls, the largest distance of the kernel and of the plain
    version from that float64 scan on the model's own inputs, over the
    call's largest |out|.  ``logits``: the distance of the kernel run and of
    the plain run from the float64-scan run.  If each call lies within
    float32 rounding of float64 and the kernel run about as far as the
    plain run, the gap between them is float32 rounding of the scan (each
    sums in its own order) that the model carries to its logits.  Fails
    if the kernel lies farther than
    RWKV6_TOL (float32) from the float64 scan in a call, or farther than
    WITNESS_RATIO times the plain run from the float64-scan run."""
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
        wit = run(None)
    logits = {"kernel": float((got - wit).abs().max()),
              "plain": float((want - wit).abs().max())}
    if not (per_call["kernel"] <= RWKV6_TOL[torch.float32]
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


def decode_step_time(params, cfg, dev, n=8) -> dict:
    """Where a full-width decode step's time goes.  wall: n steps enqueued
    back to back, one synchronise at the end.  host: the same n calls timed
    on the host without a synchronise (host ~ wall: the host sets the
    pace).  device: one step captured in a CUDA graph and replayed n times,
    timed by CUDA events: the card's work with no gaps between launches.
    attn_call_us / op_us: host time of one decode_attention call at this
    shape (models with attention) and of one small PyTorch op, without a
    synchronise."""
    cache = init_cache(cfg, 1, 64, device=dev)
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

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_step(params, cfg, tok, cache, 5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        decode_step(params, cfg, tok, cache, 5)
    dev_ms = time_call(graph.replay, n)
    out = {"wall_ms": wall / n * 1e3, "host_ms": host / n * 1e3,
           "device_ms": dev_ms,
           "device_idle_share": 1 - dev_ms / (wall / n * 1e3)}

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
    del graph
    return out


def serving_burst(arch, dev) -> tuple[dict, list]:
    """The serving main path of ``arch`` at full width, bfloat16: the
    launcher's two endpoints, slots 2, policy fc, estimator warm-up 3 + 3,
    a burst of 12 calls (30% heavy).  Every decode step must launch each of
    its kernels once for each layer of the kernel's kind, and no plain
    version.  Returns the numbers and the endpoints."""
    short, long_ = serve.make_endpoints(arch, full_width=True)
    cfg = short.cfg
    if cfg.dtype != "bfloat16" or cfg != get_config(arch):
        raise AssertionError(f"unexpected config {cfg}")
    t0 = time.perf_counter()
    eng = ServingEngine([short, long_], slots=2, policy="fc", seed=0,
                        device=dev)
    warm_s = time.perf_counter() - t0
    steps0 = eng.decode_steps
    ops.reset_launches()
    summ = serve.run_burst(eng, short.name, long_.name, 12, 0.3)
    n = ops.launches()
    steps = eng.decode_steps - steps0
    per_step = step_launches(cfg)
    for name, got in n.items():
        want = {"kernel": steps * per_step.get(name, 0), "plain": 0}
        if got != want:
            raise AssertionError(f"{arch} serving burst: {name} launches "
                                 f"{got}, expected {want}")
    if summ["n"] != 12:
        raise AssertionError(f"{arch} serving burst completed {summ['n']} "
                             "of 12")
    for key in ("R_avg", "R_p50", "R_p95"):
        if not math.isfinite(summ[key]) or summ[key] <= 0:
            raise AssertionError(f"{arch} serving burst: {key} = "
                                 f"{summ[key]}")
    out = {"arch": arch, "burst": summ, "steps": steps,
           "per_step_launches": {k: v for k, v in per_step.items() if v},
           "launches": {k: v["kernel"] for k, v in n.items()
                        if v["kernel"]},
           "prewarm_s": warm_s,
           "ms_per_decode_step": summ["wall_s"] / summ["decode_steps"] * 1e3,
           "tokens_per_s": summ["decode_steps"] / summ["wall_s"]}
    del eng
    return out, [short, long_]


def print_burst(sv: dict) -> None:
    b = sv["burst"]
    kern = ", ".join(f"{k} kernel launches {v} ({sv['per_step_launches'][k]}"
                     f" a step), plain 0" for k, v in sv["launches"].items())
    print(f"serving main path: {sv['arch']} bf16, 2 endpoints, slots 2, fc: "
          f"n={b['n']} R_avg={b['R_avg'] * 1e3:.3f} ms R_p50="
          f"{b['R_p50'] * 1e3:.3f} ms R_p95={b['R_p95'] * 1e3:.3f} ms "
          f"cold_starts={b['cold_starts']} decode_steps="
          f"{b['decode_steps']} ({sv['ms_per_decode_step']:.3f} ms per "
          f"step, {sv['tokens_per_s']:.1f} tokens/s); {kern}", flush=True)
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
    del warm_cache
    out |= {"prefill_launches": n["flash_attention"]["kernel"],
            "prefill_2048_ms": t_prefill * 1e3,
            "prefill_2048_warm_ms": t_warm * 1e3,
            "decode_after_prefill_ms_per_step": t_decode / 16 * 1e3,
            "step": decode_step_time(params, cfg, dev)}
    del short, long_, params, cache
    torch.cuda.empty_cache()
    return out


def long_prompt(params, cfg, dev, S=4096, n=16) -> dict:
    """An S-token bf16 prefill and n decode steps through the kernels and
    through the plain versions (fed the kernel run's greedy tokens);
    logits within BF16_LOGIT_RTOL of the largest |logit|.  With S past
    recurrentgemma's window of 2,048 its ring wraps in prefill (position s
    in slot s % 2,048) and every decode step overwrites the oldest slot.
    ``carriers`` says which kernel carries the gap (``gap_carriers``)."""
    tokens = torch.randint(0, cfg.vocab, (1, S),
                           generator=torch.Generator().manual_seed(3))
    feed = []

    def run(params, cfg, force):
        """(logits (n + 1, 1, V) float32, prefill s, decode s a step, the
        last cache)"""
        cache = init_cache(cfg, 1, S + n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": tokens.to(dev)},
                                cache, force=force)
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
        t_decode = (time.perf_counter() - t0) / n
        return torch.stack(seq).float(), t_prefill, t_decode, cache

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
    if not err <= BF16_LOGIT_RTOL * scale:
        raise AssertionError(f"{S}-token prefill + {n} steps: kernels and "
                             f"plain differ by {err} (largest |logit| "
                             f"{scale}, tolerance {BF16_LOGIT_RTOL})")
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    out |= {"S": S, "decode_steps": n, "ring_slots": sorted(ring),
            "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "rtol": BF16_LOGIT_RTOL,
            "argmax_equal": f"{same}/{got.shape[0]}"}
    out["carriers"] = gap_carriers(run, params, cfg, runs)
    torch.cuda.empty_cache()
    return out


def gap_carriers(run, params, cfg, runs) -> dict:
    """Which kernel carries the kernel-vs-plain gap of ``long_prompt``.
    The kernel run once more for each kernel of the path with that one
    kernel swapped to its plain version, and the plain versions in float32
    on the same weights (the bf16 weights widened, exactly), a yardstick
    with little rounding.  For each bf16 run: its distance from the plain
    run and from the float32 run, over the largest |logit| of the plain
    run, at the prefill's logits and over the decode steps.  Fails if the
    kernel run lies farther than WITNESS_RATIO times the plain run from
    the float32 run."""
    def dist(a, b):
        scale = float(runs["plain"].abs().max())
        d = (a - b).abs()
        return {"prefill": float(d[0].max()) / scale,
                "decode": float(d[1:].max()) / scale}

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        return tree.float()

    for name in ("flash_attention", "decode_attention", "rglru_scan"):
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
    breakdown, and for recurrentgemma the 4,096-token prefill of
    ``long_prompt``."""
    out, eps = serving_burst(arch, dev)
    params, cfg = eps[0].params, eps[0].cfg
    del eps         # the batch endpoint's weights: room for a float32 copy
    torch.cuda.empty_cache()
    if arch == "recurrentgemma_9b":
        out["long_prompt"] = long_prompt(params, cfg, dev)
    out["step"] = decode_step_time(params, cfg, dev)
    del params
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
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    ops._event_step_lib()
    dec_mod._lib()
    for dtype in flash_mod.SOURCE:
        flash_mod._lib(dtype)
    rglru_mod._lib()
    rwkv6_mod._lib()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)
    for src, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {src}: {line}")

    # -- 2. kernel vs plain on the card, at the mega bucket shapes --------
    sept = check_kernel("sept", 256, dev, timed=True)
    fc = check_kernel("fc", 256, dev, timed=True)
    pad = check_kernel("rect", 100, dev, timed=False)   # 28 padded cells
    for r in (sept, fc, pad):
        print("event_step vs plain: " + json.dumps(r), flush=True)

    # -- 3. the main path --------------------------------------------------
    spec = sweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                           nodes=(2, 4), cores=(8,),
                           intensities=(10, 15, 20, 25, 30),
                           seeds=args.seeds, workload_cores=16)
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
    launches, ref_launches = ops.KERNEL_LAUNCHES, ops.REF_LAUNCHES
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
          f"device {timings['device_s']:.3f} s, fold "
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
            "launches": launches,
            "max_abs_err": max(sept["max_abs_err"], fc["max_abs_err"],
                               pad["max_abs_err"]),
            "ms": fc["ms"], "plain_ms": fc["plain_ms"],
            "bound_ms": fc["bound_ms"], "bound_by": fc["bound_by"],
            "library_ms": None,
            "shape": f"fc bucket, {fc['bsz']} cells, n_b={fc['n_b']}, "
                     "4 nodes x 8 slots",
            "sept_ms": sept["ms"], "sept_plain_ms": sept["plain_ms"],
            "sept_bound_ms": sept["bound_ms"], "ms_4096": fc["ms_4096"],
            "bound_ms_4096": fc["bound_ms_4096"],
            "sept_ms_4096": sept["ms_4096"],
            "sept_bound_ms_4096": sept["bound_ms_4096"]}

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

    # -- 5. the recurrence kernels vs plain on the card --------------------
    # recurrentgemma_9b's RG-LRU width (4,096) and rwkv6_3b's heads (40 of
    # 64), at the prefill length of 4,096 and at one decode step
    rg = {
        "prefill_4k": check_rglru(1, 4096, 4096, bf, dev, gen),
        "decode": check_rglru(1, 1, 4096, bf, dev, gen),
        "f32_odd": check_rglru(3, 333, 1000, f32, dev, gen, timed=False),
        "slots": check_rglru(2, 1, 4096, bf, dev, gen, timed=False),
    }
    rw = {
        "prefill_4k": check_rwkv6(1, 4096, 40, 64, bf, dev, gen),
        "decode": check_rwkv6(1, 1, 40, 64, bf, dev, gen),
        "f32_odd": check_rwkv6(2, 77, 40, 64, f32, dev, gen, timed=False),
    }
    for case, r in rg.items():
        print(f"rglru_scan vs plain [{case}]: " + json.dumps(r), flush=True)
    for case, r in rw.items():
        print(f"rwkv6_scan vs plain [{case}]: " + json.dumps(r), flush=True)

    # -- 6. the models at full width, float32, kernels vs plain ------------
    for arch in ("qwen3_1_7b", "recurrentgemma_9b", "rwkv6_3b"):
        mf = model_f32(arch, dev)
        print(f"{arch} float32, 512-token prefill + 8 decode steps, kernels "
              "vs plain versions: " + json.dumps(mf), flush=True)

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
    }

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
        for side_name, r in side.items():
            out |= {f"{side_name}_{k}": r[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
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
        flash_row,
        row("decode_attention", dec["decode_32k"],
            {"main_path": dec["serving"], "rg": dec["rg_ring_2k"],
             "rg_main_path": dec["rg_serving"]},
            "src/repro/kernels/decode_attention.py:27", dec),
        row("rglru_scan", rg["prefill_4k"], {"decode": rg["decode"]},
            "src/repro/kernels/rglru_scan.py:23", rg),
        row("rwkv6_scan", rw["prefill_4k"], {"decode": rw["decode"]},
            "src/repro/kernels/rwkv6_scan.py:27", rw),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
