"""Card times of the port's kernels, to compare two trees.

    python3 tools/scan_bench.py [--src DIR]
                                [--mode scans|event_step|freeze|dyn|
                                        freeze64|hedge|res|stream|sweep|
                                        serve]
                                [--profile] [--repeat N] [--arch ARCH]
                                [--invocations N] [--assignment pull|push]

Imports ``repro_torch`` from DIR (default: the ``src`` of the checkout
this script is in), builds its kernels, and prints one JSON line per case
with the kernel's time by CUDA events over back-to-back calls (``ms``),
each case's least time on the card (``bound_ms``, as ``chip_smoke.py``
counts it) and the largest |kernel - plain| of one call.

``--mode scans`` (the default): the two recurrence kernels at
recurrentgemma_9b's RG-LRU width and rwkv6_3b's heads, at the 4,096-token
prefill and at one decode step (B = 1 and the engine's 2 slots), also
timed by CUDA-graph replay (``card_ms``: the card's time without the
host's launch gaps, which set ``ms`` at S = 1; a call of 50 in one graph
there).  ``--profile`` adds each launched kernel's device time from
``torch.profiler``.

``--mode event_step``: the event scan on the mega grid's buckets as
``chip_smoke.py`` checks them (256 cells of intensity 30 on 4 nodes x 8
cores, n_b = 1,024, SEPT and FC) and each tiled to 4,096 cells, with
``ns_per_step``: kernel time over the longest cell's 2 n event steps.
Its ``bound_ms`` is the bytes' time (its operations take less), the bytes
counted by ``chip_smoke.needed_bytes``.

``--mode freeze``: the float32 frozen-priority kernel on
``chip_smoke.py``'s freeze checks but the 16 x 18 one (Table 3's single-node
FC and SEPT buckets at 10 cores, intensity 120; push FC on 4 x 8 cores,
least-loaded and home; Fig 6's fleet), each bucket built by DIR's own
bucket runner: ``ms``.

``--mode dyn``: the float64 pull kernel on ``chip_smoke.py``'s four
float64 checks (the frontier and straggler grids' samples, the failure +
speed bucket, the autoscaled bucket past 32 nodes on the wide path), each
bucket built by DIR's own bucket runner: ``ms``.

``--mode freeze64``: the float64 frozen-priority kernel on
``chip_smoke.py``'s six checks of it (the cold matrix's push buckets, the
straggler grid's slowed push bucket, the steal matrix's cells without
hedging, cold single-node cells): ``ms``.  DIR must have that kernel.

``--mode hedge``: the float64 frozen-priority kernel's hedged
instantiations on ``chip_smoke.py``'s six checks of them (the straggler
grid's hedged push bucket, the steal matrix's FC cells with a kill and the
autoscaler, the dup matrix's push cells at intensity 16, a cold bucket
with node speeds, one node, 3 x 24 cores): ``ms`` and ``ns_per_step``
(over the longest cell's steps, which the kernel counts).  DIR must have
hedging.

``--mode res``: the float64 frozen-priority kernel's resilience
instantiations on ``chip_smoke.py``'s six checks of them (the retry
storm's bucket, FC with backoff and shedding at intensity 40, the home
balancer with immediate retries, an absolute timeout, one node, 3 x 24
cores): ``ms`` and ``ns_per_step`` (over the longest cell's steps, which
the kernel counts).  DIR must have resilience.

``--mode stream``: the chunked stream replay on the planet fleet as
``chip_smoke.py`` runs it (``chip_smoke.planet_fleet``: 10,000 functions,
96 nodes autoscaling to 128, chunk 4,096) over the first
``--invocations`` invocations (default 32,768): one JSON line with the
replay's invocations/s and chunks, and the stream kernel's ``ms`` on the
first chunk past half the prefix (its start planes replayed 3 times, after
one check against the plain version) with ``ns_per_step`` over its
arrivals and completions.  ``--profile`` adds the replay once more under
``torch.profiler``: the card's ms in the event-step kernels, in copies,
fills and other kernels, and their share of that replay's wall.  DIR must have the stream.  ``--assignment
push`` replays the planet fleet under push instead
(``chip_smoke.planet_push_fleet``, least-loaded) through the
frozen-priority stream kernels, and times the float64 kernel on the same
chunk (``chip_smoke.check_freeze_stream``, ``ns_per_step`` over the
kernel's steps); DIR must have the push stream.

``--mode sweep``: the sweep's main path as ``chip_smoke.py`` runs it
(``chip_smoke.main_sweep``, 2,000 cells), once on one seed to warm up and
then ``--repeat`` times, one JSON line each: cells/s and the host and
device phases.  Several such processes, alternating between two trees,
give each tree's spread in one call.

``--mode serve``: one arch's serving burst at full width in bf16 as
``chip_smoke.py`` runs it (``chip_smoke.full_width_burst``: the launcher's
two endpoints sharing one copy of the weights, slots 2, fc, 12 calls),
one JSON line: R_avg / R_p50 / R_p95, ms per decode step, tokens/s, the
engine's construction s, the kernel launches (replays x captured where
DIR's engine replays CUDA graphs, else the eager counts), and one decode
step's card time (``card_ms``): the engine's own lane graph replayed where
DIR's engine captures one, else ``decode_step`` captured at pos 5, as the
eager engine's tree measured it.  One process a (tree, arch), alternating
trees, compares DIR's engine with another's in one call.

With ``--src``, ``repro_torch`` comes from DIR; ``chip_smoke.py`` (from
this script's checkout) is imported after it and so runs DIR's code.

Run it once per tree in one call (parent, change, change, parent) to
compare them on one card; the first line is the card's name and power
limit.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_S = 67e12        # H100 SXM float32 rate outside the tensor cores


def time_call(fn, reps: int) -> float:
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


def time_graph(fn, reps: int, calls: int = 1) -> float:
    """Milliseconds per call of ``fn``, ``calls`` calls captured in one CUDA
    graph and replayed ``reps`` times: no host launch gaps, and the graph's
    own launch spread over ``calls`` calls."""
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


def kernel_times(fn, reps: int = 5) -> dict:
    """Device milliseconds per call of each CUDA kernel ``fn`` launches,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0)
        if t:
            out[evt.key[:60]] = t / reps / 1e3
    return out


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / FP32_OPS_S) * 1e3


def rglru_case(ops, B, S, W, dtype, gen, reps):
    dev = "cuda"
    a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                  device=dev)).to(dtype)
    gx = (0.1 * torch.randn((B, S, W), generator=gen, device=dev)).to(dtype)
    h0 = (0.1 * torch.randn((B, W), generator=gen, device=dev)).to(dtype)
    got = ops.rglru_scan(a, gx, h0)
    want = ops.rglru_scan(a, gx, h0, force="ref")
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    es = a.element_size()
    fn = lambda: ops.rglru_scan(a, gx, h0)  # noqa: E731
    return {"kernel": "rglru_scan",
            "shape": f"B={B} S={S} W={W} {str(dtype)[6:]}",
            "ms": time_call(fn, reps),
            "card_ms": time_graph(fn, reps, 1 if S > 1 else 50),
            "bound_ms": bound_ms(3 * B * S * W * es + 2 * B * W * es,
                                 2 * B * S * W),
            "max_abs_err": err, "fn": fn}


def rwkv6_case(ops, B, S, H, dh, dtype, gen, reps):
    dev = "cuda"
    r = torch.randn((B, S, H, dh), generator=gen, device=dev).to(dtype)
    k = (0.2 * torch.randn((B, S, H, dh), generator=gen,
                           device=dev)).to(dtype)
    v = (0.2 * torch.randn((B, S, H, dh), generator=gen,
                           device=dev)).to(dtype)
    w = 0.9 + 0.099 * torch.rand((B, S, H, dh), generator=gen, device=dev)
    u = (0.1 * torch.randn((H, dh), generator=gen, device=dev)).to(dtype)
    s0 = torch.randn((B, H, dh, dh), generator=gen, device=dev)
    got = ops.rwkv6_scan(r, k, v, w, u, s0)
    want = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    err = float((got[0].float() - want[0].float()).abs().max())
    es = r.element_size()
    n = B * S * H * dh
    fn = lambda: ops.rwkv6_scan(r, k, v, w, u, s0)  # noqa: E731
    return {"kernel": "rwkv6_scan",
            "shape": f"B={B} S={S} H={H} dh={dh} {str(dtype)[6:]}",
            "ms": time_call(fn, reps),
            "card_ms": time_graph(fn, reps, 1 if S > 1 else 50),
            "bound_ms": bound_ms(
                4 * n * es + 4 * n + H * dh * es + 2 * B * H * dh * dh * 4,
                B * S * H * (5 * dh * dh + 5 * dh)),
            "max_abs_err": err, "fn": fn}


def event_step_cases(needed_bytes, reps: int = 20):
    """(name, fn, check, longest n, bytes) of each event scan case: the
    mega grid's SEPT and FC buckets (256 cells) and each tiled to 4,096
    cells.  ``check()`` returns the largest |kernel - plain| (the plain
    version on the 256-cell buckets)."""
    from repro_torch.core import fastpath, sweep
    from repro_torch.core.planes import make_planes
    from repro_torch.kernels import ops

    for policy in ("sept", "fc"):
        cells = []
        for seed in range(256):
            c = sweep.SweepCell(policy=policy, nodes=4, cores=8,
                                intensity=30, seed=seed, workload_cores=16)
            reqs = sweep.make_workload(c)
            cells.append(fastpath._ScanCell(
                requests=reqs, feats=fastpath._arrival_features(reqs),
                cores=8, nodes=4, policy=policy))
        (key,) = {c.bucket() for c in cells}
        static = fastpath._scan_static(key)
        inp = {k: torch.from_numpy(v).cuda()
               for k, v in fastpath._fill_bucket(key, cells).items()}
        clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               window=static["window"])
        n_max = max(len(c.feats.t) for c in cells)
        nbytes = needed_bytes(cells, static)

        def check(clk=clk, ctr=ctr, inp=inp, static=static, n=key[1]):
            ref = ops.event_step(clk, ctr, inp, force="ref", **static)
            got = ops.event_step(clk, ctr, inp, **static)
            return max(float((a[:, :n].double() - b[:, :n].double())
                             .abs().max()) for a, b in zip(ref[:4], got[:4]))

        yield (f"{policy}_256", lambda clk=clk, ctr=ctr, inp=inp,
               static=static: ops.event_step(clk, ctr, inp, **static),
               check, n_max, nbytes, reps)
        wide = {k: v.repeat(16, *([1] * (v.dim() - 1)))
                for k, v in inp.items()}
        wclk, wctr = clk.repeat(16, 1), ctr.repeat(16, 1)
        yield (f"{policy}_4096", lambda: ops.event_step(
            wclk, wctr, wide, **static), None, n_max, 16 * nbytes, 5)


def dyn_cases(chip_smoke):
    """(name, fn) of each float64 pull case, built by the imported tree's
    bucket runner from ``chip_smoke.py``'s cells."""
    from repro_torch.core import fastpath, sweep
    from repro_torch.core.planes import make_planes
    from repro_torch.kernels import ops

    cases = {
        "frontier": chip_smoke.dyn_sample(chip_smoke.frontier_cells(5)),
        "straggler": chip_smoke.dyn_sample(
            chip_smoke.straggler_pull_cells()),
        "fail_het": [sweep.SweepCell(policy="fc", nodes=3, cores=6,
                                     intensity=v, seed=s,
                                     fail_spec=((0, 8.0),),
                                     degrade=((0, 1.0, 300.0, 5.0),))
                     for v in (16, 45) for s in range(4)],
        "wide": chip_smoke.wide_dyn_cells()}
    for name, cells in cases.items():
        prepared = []
        for c in cells:
            reqs = sweep.make_workload(c)
            prepared.append(fastpath._ScanCell(
                requests=reqs, feats=fastpath._arrival_features(reqs),
                cores=c.cores, nodes=c.nodes, policy=c.policy,
                dynamics=sweep._cell_dynamics(c),
                profile=sweep._cell_profile(c)))
        key = tuple(max(col) for col in zip(*{c.bucket() for c in prepared}))
        static = fastpath._scan_static(key)
        inp = {k: torch.from_numpy(v).cuda()
               for k, v in fastpath._fill_bucket(key, prepared).items()}
        clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               window=static["window"], dyn=static["dyn"])
        yield name, (lambda clk=clk, ctr=ctr, inp=inp, static=static:
                     ops.event_step(clk, ctr, inp, **static))


def freeze_cases(chip_smoke):
    """(name, fn) of each float32 frozen-priority case, built by the
    imported tree's bucket runner from ``chip_smoke.py``'s freeze checks."""
    from repro_torch.core import fastpath
    from repro_torch.core.planes import make_planes
    from repro_torch.kernels import ops

    cases = {
        "single_fc_c10_v120": [("fc", 1, 10, 120, s, None, 10)
                               for s in range(256)],
        "single_sept_c10_v120": [("sept", 1, 10, 120, s, None, 10)
                                 for s in range(256)],
        "push_fc_ll_4x8": [("fc", 4, 8, 30, s, "least_loaded", 16)
                           for s in range(256)],
        "push_fc_home_4x8": [("fc", 4, 8, 30, s, "home", 16)
                             for s in range(256)],
        "push_fc_home_fig6": [("fc", 4, 18, 30, s, "home", 72)
                              for s in range(64)]}
    for name, specs in cases.items():
        key, _, host = chip_smoke.freeze_bucket(specs)
        static = fastpath._scan_static(key)
        inp = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               window=static["window"], freeze=True,
                               fc_push=static["fc_push"],
                               fc_ring=static["fc_ring"])
        yield name, (lambda clk=clk, ctr=ctr, inp=inp, static=static:
                     ops.event_step(clk, ctr, inp, **static))


def freeze64_cases(chip_smoke):
    """(name, fn) of each float64 frozen-priority case: ``chip_smoke.py``'s
    checks of that kernel, built by the imported tree's bucket runner."""
    from repro_torch.core import fastpath
    from repro_torch.kernels import ops

    cold, strag = chip_smoke.cold_push_cells(), \
        chip_smoke.straggler_push_cells()
    cases = {
        "cold_push_fc": [c for c in cold if c.policy == "fc"],
        "cold_push_sept": [c for c in cold if c.policy == "sept"],
        "straggler_push": [c for c in strag if c.degrade is not None],
        "steal_fc": chip_smoke.steal_cells("fc"),
        "steal_sept": chip_smoke.steal_cells("sept"),
        "single_cold": chip_smoke.single_cold_cells()}
    dev = torch.device("cuda")
    for name, cells in cases.items():
        prepared = [chip_smoke.scan_cell(c) for c in cells]
        key = tuple(max(col) for col in zip(*{c.bucket() for c in prepared}))
        inp, clk, ctr, static = chip_smoke.bucket_tensors(
            key, fastpath._fill_bucket(key, prepared), dev)
        yield name, (lambda clk=clk, ctr=ctr, inp=inp, static=static:
                     ops.event_step(clk, ctr, inp, **static))


def hedge_cases(chip_smoke):
    """(name, fn) of each hedged case: ``chip_smoke.py``'s checks of the
    hedged kernels, built by the imported tree's bucket runner."""
    from repro_torch.core import fastpath
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    for name, _, cells in chip_smoke.hedge_check_cases():
        prepared = [chip_smoke.scan_cell(c) for c in cells]
        key = tuple(max(col) for col in zip(*{c.bucket() for c in prepared}))
        inp, clk, ctr, static = chip_smoke.bucket_tensors(
            key, fastpath._fill_bucket(key, prepared), dev, prepared)
        yield name, (lambda clk=clk, ctr=ctr, inp=inp, static=static:
                     ops.event_step(clk, ctr, inp, **static))


def res_cases(chip_smoke):
    """(name, fn) of each resilience case: ``chip_smoke.py``'s checks of
    the res kernel, built by the imported tree's bucket runner."""
    from repro_torch.core import fastpath
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    for name, _, prepared in chip_smoke.res_check_cases():
        key = tuple(max(col) for col in zip(*{c.bucket() for c in prepared}))
        inp, clk, ctr, static = chip_smoke.bucket_tensors(
            key, fastpath._fill_bucket(key, prepared), dev, prepared)
        yield name, (lambda clk=clk, ctr=ctr, inp=inp, static=static:
                     ops.event_step(clk, ctr, inp, **static))


def stream_profile(chip_smoke, invocations: int, fleet: dict) -> dict:
    """The planet prefix replayed once more under ``torch.profiler``: its
    wall (the profiler's cost included) and the card's time in the
    event-step kernels, in copies between host and card, in fills and in
    other kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import streamscan

    stream = chip_smoke.planet_model().stream(chip_smoke.PLANET_SEED,
                                              max_invocations=invocations)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streamscan.simulate_cluster_stream(
            stream, chunk=chip_smoke.PLANET_CHUNK, device="cuda", **fleet)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = {"event_step_kernel": 0.0, "memcpy": 0.0, "memset": 0.0,
          "other": 0.0}
    calls = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t, name = chip_smoke._device_us(evt) / 1e3, evt.key
        if re.search(r"(dyn|freeze64|freeze|event_step)_kernel", name):
            ms["event_step_kernel"] += t
            calls += evt.count
        elif "memcpy" in name.lower():
            ms["memcpy"] += t
        elif "memset" in name.lower():
            ms["memset"] += t
        else:
            ms["other"] += t
    busy = sum(ms.values())
    return {"wall_s": wall, "device_ms": ms, "kernel_calls": calls,
            "card_busy_ms": busy, "card_busy_share": busy / 1e3 / wall}


def stream_case(chip_smoke, invocations: int, push: bool = False,
                profiled: bool = False) -> dict:
    """``--mode stream``'s numbers: the planet prefix's replay (under push
    with ``push``), then the stream kernel on its first chunk past half the
    prefix; with ``profiled``, the replay's split of the card's time."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    half = invocations // 2
    fleet = (chip_smoke.planet_push_fleet() if push
             else chip_smoke.planet_fleet())
    timings: dict = {}
    cap, res = chip_smoke.capture_chunk(
        chip_smoke.planet_model().stream(chip_smoke.PLANET_SEED,
                                         max_invocations=invocations),
        dev, chip_smoke.PLANET_CHUNK, lambda i, before, st: before >= half,
        timings=timings, **fleet)
    kernel = "event_step_freeze_stream" if push else "event_step_stream"
    launches = ops.launches()[kernel]
    check = chip_smoke.check_freeze_stream if push else chip_smoke.check_stream
    row = check("planet push" if push else "planet", cap, len(res.fns), dev)
    return {"kernel": kernel, "case": "planet push" if push else "planet",
            "invocations": res.n, "chunks": res.chunks,
            "invocations_per_s": res.n / res.wall_s, "wall_s": res.wall_s,
            "fill_s": timings["fill_s"], "device_s": timings["device_s"],
            "chunk": row["chunk"], "n_b": row["n_b"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "ns_per_step": row["ns_per_step"],
            "bound_ms": row["bound_ms"],
            "bound_ms_all_fns": row.get("bound_ms_all_fns"),
            "max_abs_err": row["max_abs_err"],
            "launches": launches} | (
                {"profile": stream_profile(chip_smoke, invocations, fleet)}
                if profiled else {})


def serve_case(chip_smoke, arch: str) -> dict:
    """``--mode serve``'s numbers for ``arch`` on the imported tree."""
    from repro_torch.models import decode_step, init_cache

    dev = torch.device("cuda")
    eng, eps, summ, counts, replays, steps, warm_s = (
        chip_smoke.full_width_burst(arch, dev))
    ep = eps[0]
    if replays:
        lane = ep.lanes[0]
        lane.reset()
        card_ms = time_call(lambda: ep.step(lane), 8)
        how = "lane graph replay"
        launches = eng.kernel_launches()
    else:
        cache = init_cache(ep.cfg, 1, ep.cache_len, device=dev)
        tok = torch.zeros((1,), dtype=torch.int32, device=dev)
        card_ms = time_graph(lambda: decode_step(ep.params, ep.cfg, tok,
                                                 cache, 5), 8)
        how = "decode_step captured at pos 5"
        launches = {k: v["kernel"] for k, v in counts.items()
                    if v["kernel"]}
    return {"arch": arch, "n": summ["n"], "R_avg": summ["R_avg"],
            "R_p50": summ["R_p50"], "R_p95": summ["R_p95"],
            "decode_steps": summ["decode_steps"], "wall_s": summ["wall_s"],
            "ms_per_decode_step": summ["wall_s"] / summ["decode_steps"] * 1e3,
            "tokens_per_s": summ["decode_steps"] / summ["wall_s"],
            "prewarm_s": warm_s, "steps": steps,
            "replays": sum(replays.values()), "launches": launches,
            "plain": {k: v["plain"] for k, v in counts.items()
                      if v["plain"]},
            "card_ms": card_ms, "card_how": how}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--mode", choices=("scans", "event_step", "freeze",
                                       "dyn", "freeze64", "hedge", "res",
                                       "stream", "sweep", "serve"),
                    default="scans")
    ap.add_argument("--invocations", type=int, default=1 << 15,
                    help="the planet prefix replayed (--mode stream)")
    ap.add_argument("--assignment", choices=("pull", "push"), default="pull",
                    help="the planet fleet's regime (--mode stream)")
    ap.add_argument("--arch", default="qwen3_1_7b",
                    help="the arch served (--mode serve)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed sweeps after the warm-up (--mode sweep)")
    ap.add_argument("--profile", action="store_true",
                    help="add each kernel's device time at S > 1, or "
                         "the stream replay's split of the card's time "
                         "(torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_bench: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ops
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.mode == "serve":
        print(json.dumps({"src": args.src} | serve_case(chip_smoke,
                                                        args.arch)),
              flush=True)
        return 0
    if args.mode == "stream":
        print(json.dumps({"src": args.src} | stream_case(
            chip_smoke, args.invocations, args.assignment == "push",
            args.profile)), flush=True)
        return 0
    if args.mode == "sweep":
        dev = torch.device("cuda")
        chip_smoke.main_sweep(1, dev)
        for i in range(args.repeat):
            cells, _, wall, tm, launches, plain = chip_smoke.main_sweep(
                40, dev)
            print(json.dumps({
                "src": args.src, "run": i, "cells": len(cells),
                "cells_per_s": len(cells) / wall, "wall_s": wall,
                "fill_s": tm["fill_s"], "device_s": tm["device_s"],
                "fold_s": tm["fold_s"],
                "other_s": wall - sum(tm.values()),
                "launches": launches, "plain_launches": plain}),
                flush=True)
        return 0
    modes = {"freeze": ("event_step_freeze", freeze_cases),
             "dyn": ("event_step_dyn", dyn_cases),
             "freeze64": ("event_step_freeze64", freeze64_cases),
             "hedge": ("event_step_hedge", hedge_cases),
             "res": ("event_step_res", res_cases)}
    if args.mode in modes:
        kernel, cases = modes[args.mode]
        for name, fn in cases(chip_smoke):
            out = {"src": args.src, "kernel": kernel, "case": name,
                   "ms": time_call(fn, 10)}
            if args.mode in ("hedge", "res"):
                steps = int(fn()[4]["stepc"].max())
                out["ns_per_step"] = out["ms"] * 1e6 / steps
            print(json.dumps(out), flush=True)
        return 0
    if args.mode == "event_step":
        for name, fn, check, n_max, nbytes, reps in event_step_cases(
                chip_smoke.needed_bytes):
            out = {"src": args.src, "kernel": "event_step", "case": name}
            if check is not None:
                out["max_abs_err"] = check()
            out["ms"] = time_call(fn, reps)
            out["ns_per_step"] = out["ms"] * 1e6 / (2 * n_max)
            out["bound_ms"] = nbytes / HBM_BYTES_S * 1e3
            print(json.dumps(out), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("prefill_4k", rglru_case, (1, 4096, 4096, bf), 20),
        ("decode", rglru_case, (1, 1, 4096, bf), 200),
        ("slots", rglru_case, (2, 1, 4096, bf), 200),
        ("prefill_4k", rwkv6_case, (1, 4096, 40, 64, bf), 10),
        ("f32_prefill_4k", rwkv6_case, (1, 4096, 40, 64, f32), 10),
        ("decode", rwkv6_case, (1, 1, 40, 64, bf), 200),
        ("slots", rwkv6_case, (2, 1, 40, 64, bf), 200),
    ]
    for name, case, shape, reps in cases:
        out = case(ops, *shape, gen, reps)
        fn = out.pop("fn")
        if args.profile and shape[1] > 1:
            out["kernels_ms"] = kernel_times(fn)
        out = {"src": args.src, "case": name} | out
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
