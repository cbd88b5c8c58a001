"""The CUDA ``event_step`` kernel against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so these tests carry the ``gpu``
marker and skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py

This file imports no JAX, so it runs where only the port is installed.
Tolerance: 0 -- rows ``[:n]`` of start / finish / prio / node are
bit-identical (row ``n`` is the no-op sentinel).  Inputs: buckets filled
from real bursts for all five policies with FC counts on and off, padded to
a power of two (so one cell is an idle padded cell), and the same buckets
with every time rounded to 1/8 s, where events and priorities tie exactly.
The real-burst buckets carry the pull coefficients, all in {0, 1}; the
hand-built buckets of ``_smoke_inputs`` add an FC-ish coefficient of 0.3
and a warm-seeded estimator ring, so inexact products and sums show any
change in the order of operations.

The kernel's own paths, each chosen by shape (``ops.event_step_plan``):
the mega grid's buckets (n_b 256 / 512 / 1,024 on 2 and 4 nodes, cores
below the padded slot count, a padded cell), a 4,096-cell chunk and a
chunk whose blocks hold cells of different lengths (several cells a
block), rows too long to stage in shared memory (read from device
memory), 64 to 256 slots a cell (2, 4 and 8 slots a lane), wider cells
(the wide path: 512 slots, 300 functions, and a runtime ring too large for
shared memory), and negative channel costs, where the FC window's start
steps back.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.workload import generate_burst
from repro_torch.kernels import ops
from repro_torch.kernels.event_step import fc_prefix_counts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _bucket(policy, use_fc, quantum=None):
    cells = []
    for s in range(3):
        reqs = generate_burst(cores=8, intensity=12, seed=s)
        cells.append(tfp._ScanCell(requests=reqs,
                                   feats=tfp._arrival_features(reqs),
                                   cores=4, nodes=2 + s, policy=policy))
    shapes = {c.bucket()[1:] for c in cells}
    key = (2 if use_fc else 0,) + tuple(max(col) for col in zip(*shapes))
    host = tfp._fill_bucket(key, cells)
    if quantum is not None:
        for k in ("t", "p", "cost"):
            host[k] = (np.round(host[k] / quantum) * quantum).astype(
                np.float32)
    return host, tfp._scan_static(key), key[1]


@pytest.mark.gpu
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_kernel_matches_plain_on_card(cuda, policy, use_fc, quantum):
    host, static, n = _bucket(policy, use_fc, quantum)
    assert host["cores"][-1] == 0                  # the padded cell
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    k0 = ops.KERNEL_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), \
            f"{name} diverged ({policy}, use_fc={use_fc}, q={quantum})"


def _smoke_inputs(use_fc, B=3, n=8, F=2, NN=2, NS=4, W=4, KQ=8, seed=0,
                  quantum=None):
    """Small hand-built bucket (a copy of the JAX package's test input, so
    this file imports no JAX): sorted arrivals, a warm-seeded estimator
    ring, and FIFO / SEPT / FC-ish coefficient rows.  With ``quantum`` every
    time is a multiple of it, so events and priorities tie exactly."""
    rng = np.random.default_rng(seed)
    n1 = n + 1
    inp = {
        "t": np.full((B, n1), np.inf, dtype=np.float32),
        "fnid": np.zeros((B, n1), dtype=np.int32),
        "p": np.zeros((B, n1), dtype=np.float32),
        "cost": np.zeros((B, n1), dtype=np.float32),
        "coef": np.zeros((B, 5), dtype=np.float32),
        "cores": np.zeros(B, dtype=np.int32),
        "nodes": np.ones(B, dtype=np.int32),
        "ring0": np.zeros((B, 1, F, W), dtype=np.float32),
        "rsum0": np.zeros((B, 1, F), dtype=np.float32),
        "rlen0": np.zeros((B, 1, F), dtype=np.int32),
        "rpos0": np.zeros((B, 1, F), dtype=np.int32),
        "cumf": np.zeros((B, n1 if use_fc else 1, F), dtype=np.float32),
        "fn_ev": np.full((B, F, KQ), n, dtype=np.int32),
    }
    coefs = [[1.0, 0.0, 0.0, 0.0, 0.0],      # FIFO
             [0.0, 0.0, 1.0, 0.0, 0.0],      # SEPT
             [0.0, 0.0, 1.0, 0.3, 0.0]]      # FC-ish
    for b in range(B):
        t = np.sort(rng.uniform(0, 2.0, n)).astype(np.float32)
        fn = rng.integers(0, F, n).astype(np.int32)
        p = rng.lognormal(-1, 0.5, n).astype(np.float32)
        cost = 0.001
        if quantum is not None:
            t = np.round(t / quantum) * quantum
            p = np.maximum(np.round(p / quantum), 1) * quantum
            cost = quantum
        inp["t"][b, :n] = t
        inp["fnid"][b, :n] = fn
        inp["p"][b, :n] = p
        inp["cost"][b, :n] = cost
        inp["coef"][b] = coefs[b % len(coefs)]
        inp["cores"][b] = 1 + (b % 2)
        inp["nodes"][b] = 1 + b % NN
        inp["ring0"][b, 0, :, 0] = 0.5
        inp["rsum0"][b, 0, :] = 0.5
        inp["rlen0"][b, 0, :] = 1
        if use_fc:
            for f in range(F):
                inp["cumf"][b, 1:, f] = np.cumsum(fn == f)
        for f in range(F):
            ev = np.nonzero(fn == f)[0]
            inp["fn_ev"][b, f, :len(ev)] = ev
    static = dict(freeze=False, fc_push=False, dyn=False, het=False,
                  hedge=False, cold=False, dup=False, n_nodes=NN,
                  n_slots=NS, window=W, use_fc=use_fc, horizon=1.0,
                  n_steps=2 * n + 2)
    return inp, static, n


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_matches_plain_on_smoke_bucket(cuda, use_fc, quantum, seed):
    kw = {} if quantum is None else dict(B=6, n=24, F=3, NN=3, KQ=32)
    host, static, n = _smoke_inputs(use_fc, seed=seed, quantum=quantum,
                                    **kw)
    assert (host["coef"][:, 3] == np.float32(0.3)).any()
    inp, _, _ = bucket_from_numpy(host, device=cuda)
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    k0 = ops.KERNEL_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), \
            f"{name} diverged (use_fc={use_fc}, q={quantum}, seed={seed})"


def _mixed_bucket(specs, use_fc, n_b=None):
    """A filled bucket of real-burst cells, one for each ``(policy, nodes,
    cores, intensity, seed)`` of ``specs`` (bursts sized for 16 cores, as
    the mega grid's), padded to a power of two; the policies' coefficients
    ride in one bucket whose FC counts are forced on or off.  ``n_b``
    widens the rows past the longest cell."""
    cells = []
    for policy, nodes, cores, intensity, seed in specs:
        reqs = generate_burst(cores=16, intensity=intensity, seed=seed)
        cells.append(tfp._ScanCell(requests=reqs,
                                   feats=tfp._arrival_features(reqs),
                                   cores=cores, nodes=nodes, policy=policy))
    shape = tuple(max(col) for col in zip(*(c.bucket()[1:] for c in cells)))
    if n_b is not None:
        shape = (n_b,) + shape[1:]
    key = (2 if use_fc else 0,) + shape
    return tfp._fill_bucket(key, cells), tfp._scan_static(key), key


def _matches_plain(host, static, cuda, what):
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    if static["use_fc"]:    # the counts the kernel keeps from t and fnid
        assert torch.equal(inp["cumf"], fc_prefix_counts(
            inp["t"], inp["fnid"], inp["cumf"].shape[2])), what
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    n = inp["t"].shape[1] - 1
    k0 = ops.KERNEL_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    # every real call was dispatched
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what


POLICIES = ("fifo", "sept", "eect", "rect", "fc")
# intensity of a 16-core burst whose n fills each bucket: 176, 352, 528 calls
MEGA_INTENSITY = {256: 10, 512: 20, 1024: 30}


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("n_b", [256, 512, 1024])
def test_kernel_matches_plain_on_mega_shapes(cuda, n_b, nodes, use_fc):
    specs = [(POLICIES[s % 5], nodes, 6, MEGA_INTENSITY[n_b], s)
             for s in range(7)]
    host, static, key = _mixed_bucket(specs, use_fc)
    assert key[1] == n_b and key[3] == 8          # 6 cores on 8 slots
    assert host["cores"][-1] == 0                  # the padded cell
    plan = ops.event_step_plan(n1=n_b + 1, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"], n_fns=key[4],
                               window=static["window"])
    assert plan["staged"] and plan["per_lane"] == 1
    _matches_plain(host, static, cuda, f"n_b={n_b}, nodes={nodes}, "
                   f"use_fc={use_fc}")


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_matches_plain_on_4096_cell_chunk(cuda, use_fc):
    """A chunk of the bucket runner's full size (``CHUNK_CELLS_CUDA``):
    16 distinct cells tiled 256 times."""
    specs = [(POLICIES[s % 5], 2 + 2 * (s % 2), 8, 6 + s % 5, s)
             for s in range(16)]
    host, static, _ = _mixed_bucket(specs, use_fc)
    reps = tfp.CHUNK_CELLS_CUDA // 16
    host = {k: np.repeat(v, reps, axis=0) for k, v in host.items()}
    assert host["t"].shape[0] == tfp.CHUNK_CELLS_CUDA
    _matches_plain(host, static, cuda, f"4096 cells, use_fc={use_fc}")


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_matches_plain_with_cells_of_different_n_in_a_block(
        cuda, use_fc):
    """More cells than SMs, so each block holds several consecutive cells,
    and neighbours alternate between short and long bursts (n 66 and
    176 in one n_b = 256 bucket)."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    count = 2 * n_sm + 8
    specs = [(POLICIES[s % 5], 4, 8, 4 if s % 2 else 10, s)
             for s in range(count)]
    host, static, key = _mixed_bucket(specs, use_fc)
    n_real = np.isfinite(host["t"]).sum(1)
    assert key[1] == 256 and n_real[0] == 176 and n_real[1] == 66
    _matches_plain(host, static, cuda, f"mixed n, use_fc={use_fc}")


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_reads_rows_too_long_to_stage_from_device_memory(
        cuda, use_fc):
    """n_b = 32,768: the rows (~460 KB a cell) exceed a block's shared
    memory, so the plan reads them from device memory."""
    specs = [(POLICIES[s % 5], 4, 8, 10, s) for s in range(3)]
    host, static, key = _mixed_bucket(specs, use_fc, n_b=32768)
    plan = ops.event_step_plan(n1=32769, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"], n_fns=key[4],
                               window=static["window"])
    assert not plan["staged"]
    _matches_plain(host, static, cuda, f"rows from device memory, "
                   f"use_fc={use_fc}")


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,per_lane", [(8, 2), (16, 4), (32, 8)])
def test_kernel_matches_plain_with_several_slots_a_lane(cuda, nodes,
                                                        per_lane):
    specs = [(POLICIES[s % 5], nodes, 8, 30, s) for s in range(5)]
    host, static, key = _mixed_bucket(specs, True)
    plan = ops.event_step_plan(n1=key[1] + 1, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"], n_fns=key[4],
                               window=static["window"])
    assert plan["per_lane"] == per_lane
    _matches_plain(host, static, cuda, f"{nodes} nodes x 8 slots")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [4, 5, 6])
def test_kernel_matches_plain_when_the_window_steps_back(cuda, seed):
    """Negative channel costs let a completion land before an earlier
    event, so now - horizon falls and the FC window's start steps back
    (tests/test_torch_event_step.py holds the same inputs on the CPU)."""
    host, static, n = _smoke_inputs(True, B=6, n=24, F=3, NN=3, KQ=32,
                                    seed=seed, quantum=0.125)
    host["cost"][:, :n] = -0.25
    static = dict(static, horizon=0.25)
    inp, _, _ = bucket_from_numpy(host, device=cuda)
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({seed})"


def _plan(host, static):
    return ops.event_step_plan(n1=host["t"].shape[1],
                               n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               n_fns=host["fn_ev"].shape[1],
                               window=static["window"])


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_matches_plain_on_16_nodes_of_18_cores(cuda, use_fc):
    """16 nodes x 18 cores pad to 16 x 32 = 512 slots: the wide path, 16
    slots a lane in device memory."""
    specs = [(POLICIES[s % 5], 16, 18, 30, s) for s in range(5)]
    host, static, key = _mixed_bucket(specs, use_fc)
    assert static["n_nodes"] * static["n_slots"] == 512
    plan = _plan(host, static)
    assert plan["wide"] and plan["per_lane"] == 16
    _matches_plain(host, static, cuda, f"16 x 18, use_fc={use_fc}")


@pytest.mark.gpu
@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("quantum", [None, 0.125])
def test_kernel_matches_plain_with_more_than_256_functions(cuda, use_fc,
                                                          quantum):
    host, static, n = _smoke_inputs(use_fc, B=4, n=600, F=300, NN=2, KQ=16,
                                    seed=7, quantum=quantum)
    plan = _plan(host, static)
    assert plan["wide"] and plan["per_lane"] == 10
    _matches_plain(host, static, cuda, f"300 functions, use_fc={use_fc}, "
                   f"q={quantum}")


@pytest.mark.gpu
def test_kernel_matches_plain_with_a_ring_too_large_for_shared_memory(
        cuda):
    host, static, n = _smoke_inputs(True, B=3, n=40, F=16, NN=2, W=4000,
                                    KQ=16, seed=8)
    plan = _plan(host, static)
    assert plan["wide"] and plan["per_lane"] == 1
    _matches_plain(host, static, cuda, "16 x 4,000 ring")


@pytest.mark.gpu
def test_simulate_cluster_scan_on_16_nodes_matches_the_cpu(cuda):
    """The public entry point at its default 18 cores a node, 16 nodes:
    the card's records equal the CPU's (plain version)."""
    burst = generate_burst(cores=16 * 18, intensity=2, seed=3)
    # the first 7 functions: all 18 containers of each stay warm in 40 GB
    fns = sorted({r.fn for r in burst})[:7]
    reqs = [r for r in burst if r.fn in fns]
    assert tfp.cluster_scan_eligible(reqs, nodes=16, cores=18)

    def records(device):
        res = tfp.simulate_cluster_scan(reqs, nodes=16, device=device)
        return [(r.fn, r.r, r.start, r.finish, r.priority, r.node)
                for r in res.requests]

    k0 = ops.KERNEL_LAUNCHES
    got = records(cuda)
    assert ops.KERNEL_LAUNCHES == k0 + 1
    want = records("cpu")
    assert len(got) == len(reqs) and got == want
