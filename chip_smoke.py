"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seeds N]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version on the card at the main
path's shapes, then drives the main path -- ``run_cells_scan(metrics_only=
True)`` over the mega grid's axes (5 policies x {2, 4} nodes x 8 cores x
intensities 10-30, bursts sized for 16 cores) -- and checks what comes out.
The mega grid has 2,000 seeds; the default of 40 seeds (2,000 cells) is a
cut of it, and ``--seeds`` raises it.

Any failure exits non-zero.  The last lines are the card's name and power
limit, one JSON object with each kernel's numbers, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import fastpath  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.planes import make_planes  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_S = 67e12        # H100 SXM float32 rate outside the tensor cores


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
    print(card)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
