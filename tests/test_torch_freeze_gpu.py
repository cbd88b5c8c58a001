"""The CUDA frozen-priority ``event_step`` kernel (single-node and push
cells) against its plain PyTorch version, on the card.  A CUDA kernel has no
CPU mode, so these tests carry the ``gpu`` marker and skip where there is
no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_freeze_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_freeze_scan.py`` holds the plain version to the JAX
oracle on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish /
prio / node are bit-identical (row ``n`` is the no-op sentinel).

Inputs: buckets filled from real bursts for the five policies on one node
and under push (least-loaded on 3 nodes, padded to 4; home on 2 and 4),
padded to a power of two (one idle cell), and the same buckets with every
time rounded to 1/8 s, where SEPT and FC priorities tie exactly;
hand-built buckets with a warm-seeded ring, an FC-ish coefficient of 0.3
and random routes; Table 3's largest single-node bucket (10 cores at
intensity 120, n_b = 2,048) and Fig 6's fleet (4 x 18 cores, a 72-core
burst, n_b = 4,096, FC rings of 256); the kernel's own paths, each chosen
by shape (``ops.event_step_plan(..., freeze=True)``): 2, 4 and 8 slots a
lane, a 4,096-cell chunk and cells of different n in one block, rows too
long to stage (estimators and queue in device memory), and 16 nodes x 18
cores (512 slots: the wide path).  And the entry points on the card against
their CPU runs.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.workload import generate_burst
from repro_torch.kernels import ops

POLICIES = ("fifo", "sept", "eect", "rect", "fc")
OFF = dict(dyn=False, het=False, hedge=False, cold=False, dup=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _bucket(specs, n_b=None, quantum=None):
    """A filled bucket of real-burst cells, one for each ``(policy, nodes,
    cores, intensity, seed, lb, burst cores)`` of ``specs`` (``lb`` None:
    a single-node cell), padded to a power of two, its static arguments and
    key.  ``n_b`` widens the rows past the longest cell; with ``quantum``
    every time is a multiple of it."""
    cells = []
    for policy, nodes, cores, intensity, seed, lb, wcores in specs:
        reqs = generate_burst(cores=wcores, intensity=intensity, seed=seed)
        cells.append(tfp._ScanCell(
            requests=reqs, feats=tfp._arrival_features(reqs), cores=cores,
            nodes=nodes, policy=policy,
            assignment="single" if lb is None else "push",
            lb=lb or "least_loaded"))
    keys = {c.bucket() for c in cells}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    if n_b is not None:
        key = key[:1] + (n_b,) + key[2:]
    host = tfp._fill_bucket(key, cells)
    if quantum is not None:
        for k in ("t", "p", "cost"):
            host[k] = (np.round(host[k] / quantum) * quantum).astype(
                np.float32)
        host["p"] = np.where(np.isfinite(host["t"]),
                             np.maximum(host["p"], quantum), 0).astype(
                                 np.float32)
    return host, tfp._scan_static(key), key


def _plan(host, static):
    return ops.event_step_plan(n1=host["t"].shape[1],
                               n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               n_fns=host["ring0"].shape[2],
                               window=static["window"], freeze=True,
                               fc_push=static["fc_push"],
                               fc_ring=static["fc_ring"])


def _matches_plain(host, static, cuda, what, inp=None):
    if inp is None:
        inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"], freeze=True,
                           fc_push=static["fc_push"],
                           fc_ring=static["fc_ring"])
    n = inp["t"].shape[1] - 1
    k0, r0 = ops.FREEZE_LAUNCHES, ops.FREEZE_REF_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert (ops.FREEZE_LAUNCHES, ops.FREEZE_REF_LAUNCHES) == (k0 + 1, r0 + 1)
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    # every real call was dispatched, onto one of its cell's nodes
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what
    assert bool((got[3][:, :n] < inp["nodes"][:, None])[real].all()), what
    return got


FLEETS = [(1, None), (3, "least_loaded"), (2, "home"), (4, "home")]


@pytest.mark.gpu
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("fleet", FLEETS, ids=lambda f: f"{f[0]}{f[1] or ''}")
@pytest.mark.parametrize("policy", POLICIES)
def test_freeze_kernel_matches_plain_on_real_buckets(cuda, policy, fleet,
                                                     quantum):
    nodes, lb = fleet
    specs = [(policy, nodes, 4, 8, s, lb, 4 * nodes) for s in range(3)]
    host, static, key = _bucket(specs, quantum=quantum)
    assert host["cores"][-1] == 0                  # the padded cell
    assert static["fc_push"] == (policy == "fc" and nodes > 1)
    assert _plan(host, static)["staged"]
    got = _matches_plain(host, static, cuda, f"{policy}, {nodes} nodes, "
                         f"{lb}, q={quantum}")
    if quantum is not None and policy in ("sept", "fc"):
        # ties really occur: equal frozen priorities within a cell
        n = int(np.isfinite(host["t"][0]).sum())
        assert len(torch.unique(got[2][0, :n])) < n


def _smoke_inputs(fc_push, B=6, n=24, F=3, NN=4, NS=4, W=4, R=8, seed=0,
                  quantum=None):
    """Hand-built frozen-priority bucket (a copy of
    ``tests/test_torch_freeze_scan.py``'s, so this file imports no JAX)."""
    rng = np.random.default_rng(seed)
    n1 = n + 1
    f32, i32 = np.float32, np.int32
    inp = {
        "t": np.full((B, n1), np.inf, dtype=f32),
        "fnid": np.zeros((B, n1), dtype=i32),
        "p": np.zeros((B, n1), dtype=f32),
        "cost": np.zeros((B, n1), dtype=f32),
        "cnt": np.zeros((B, n1), dtype=f32),
        "home0": np.zeros((B, n1), dtype=i32),
        "coef": np.zeros((B, 5), dtype=f32),
        "cores": np.zeros(B, dtype=i32),
        "nodes": np.ones(B, dtype=i32),
        "route": np.zeros(B, dtype=i32),
        "ring0": rng.uniform(0.1, 2.0, (B, NN, F, W)).astype(f32),
        "rsum0": rng.uniform(0.5, 6.0, (B, NN, F)).astype(f32),
        "rlen0": rng.integers(0, W + 1, (B, NN, F)).astype(i32),
        "rpos0": rng.integers(0, W, (B, NN, F)).astype(i32),
        "cumf": np.zeros((B, 1, F), dtype=f32),
        "fn_ev": np.zeros((B, 1, 1), dtype=i32),
    }
    coefs = [[1.0, 0.0, 0.0, 0.0, 0.0],      # FIFO
             [0.0, 0.0, 1.0, 0.0, 0.0],      # SEPT
             [0.0, 0.0, 1.0, 0.3, 0.0],      # FC-ish
             [1.0, 0.0, 1.0, 0.0, 0.0],      # EECT
             [0.0, 1.0, 1.0, 0.0, 0.0]]      # RECT
    for b in range(B):
        t = np.sort(rng.uniform(0, 2.0, n)).astype(f32)
        fn = rng.integers(0, F, n).astype(i32)
        p = rng.lognormal(-1, 0.5, n).astype(f32)
        cost = 0.001
        if quantum is not None:
            t = np.round(t / quantum) * quantum
            p = np.maximum(np.round(p / quantum), 1) * quantum
            cost = quantum
        nodes = 1 + b % NN
        inp["t"][b, :n] = t
        inp["fnid"][b, :n] = fn
        inp["p"][b, :n] = p
        inp["cost"][b, :n] = cost
        inp["cnt"][b, :n] = rng.integers(1, 6, n)
        inp["home0"][b, :n] = rng.integers(0, nodes, n)
        inp["coef"][b] = coefs[b % len(coefs)]
        inp["cores"][b] = 1 + (b % 2)
        inp["nodes"][b] = nodes
        inp["route"][b] = b // 2 % 2
    static = dict(OFF, freeze=True, use_fc=False, fc_push=fc_push,
                  n_nodes=NN, n_slots=NS, window=W,
                  fc_ring=R if fc_push else 1, horizon=0.5,
                  n_steps=2 * n + 2)
    return inp, static, n


@pytest.mark.gpu
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fc_push", [False, True])
def test_freeze_kernel_matches_plain_on_smoke_buckets(cuda, fc_push, seed,
                                                      quantum):
    host, static, n = _smoke_inputs(fc_push, seed=seed, quantum=quantum)
    inp, _, _ = bucket_from_numpy(host, device=cuda)
    _matches_plain(host, static, cuda, f"fc_push={fc_push}, seed={seed}, "
                   f"q={quantum}", inp=inp)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["sept", "fc"])
def test_freeze_kernel_on_table3_largest_bucket(cuda, policy):
    """One node of 10 cores at intensity 120: n_b = 2,048, long queues."""
    specs = [(policy, 1, 10, 120, s, None, 10) for s in range(5)]
    host, static, key = _bucket(specs)
    assert key[1] == 2048 and _plan(host, static)["staged"]
    _matches_plain(host, static, cuda, f"c10 v120 {policy}")


@pytest.mark.gpu
@pytest.mark.parametrize("lb", ["least_loaded", "home"])
def test_freeze_kernel_on_fig6_fleet(cuda, lb):
    """FC push on 4 x 18 cores with a 72-core burst: n_b = 4,096 and the
    FC rings of 256 entries in device memory."""
    specs = [("fc", 4, 18, 30, s, lb, 72) for s in range(3)]
    host, static, key = _bucket(specs)
    assert key[1] == 4096 and static["fc_push"] and static["fc_ring"] >= 128
    plan = _plan(host, static)
    assert plan["staged"] and plan["scratch_words"] > 0
    _matches_plain(host, static, cuda, f"fig6 {lb}")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["rect", "fc"])
@pytest.mark.parametrize("lb", ["least_loaded", "home"])
@pytest.mark.parametrize("nodes,per_lane", [(8, 2), (16, 4), (32, 8)])
def test_freeze_kernel_with_several_slots_a_lane(cuda, nodes, per_lane, lb,
                                                 policy):
    specs = [(policy, nodes, 8, 4, s, lb, 8 * nodes) for s in range(5)]
    host, static, key = _bucket(specs)
    assert _plan(host, static)["per_lane"] == per_lane
    _matches_plain(host, static, cuda, f"{nodes} nodes x 8 slots, {lb}, "
                   f"{policy}")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["sept", "fc"])
def test_freeze_kernel_on_a_4096_cell_chunk(cuda, policy):
    """A chunk of the bucket runner's full size: 16 distinct push cells
    (both balancers) tiled 256 times, 16 cells a block."""
    specs = [(policy, 4, 8, 6 + s % 5, s,
              ("least_loaded", "home")[s % 2], 16) for s in range(16)]
    host, static, _ = _bucket(specs)
    reps = tfp.CHUNK_CELLS_CUDA // 16
    host = {k: np.repeat(v, reps, axis=0) for k, v in host.items()}
    _matches_plain(host, static, cuda, f"4096 cells, {policy}")


@pytest.mark.gpu
def test_freeze_kernel_with_cells_of_different_n_in_a_block(cuda):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    specs = [(POLICIES[s % 5], 1, 8, 4 if s % 2 else 12, s, None, 8)
             for s in range(2 * n_sm + 8)]
    host, static, _ = _bucket(specs)
    n_real = np.isfinite(host["t"]).sum(1)
    assert n_real[0] > 2 * n_real[1]
    _matches_plain(host, static, cuda, "mixed n")


@pytest.mark.gpu
@pytest.mark.parametrize("lb", [None, "least_loaded", "home"])
def test_freeze_kernel_keeps_rows_too_long_to_stage_in_device_memory(
        cuda, lb):
    """n_b = 16,384: estimators, queue and rows (~360 KB a cell) exceed a
    block's shared memory, so the plan keeps them in device memory."""
    nodes = 1 if lb is None else 3
    specs = [("fc", nodes, 4, 10, s, lb, 4 * nodes) for s in range(3)]
    host, static, key = _bucket(specs, n_b=16384)
    plan = _plan(host, static)
    assert not plan["staged"] and not plan["wide"]
    _matches_plain(host, static, cuda, f"unstaged, {lb}")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["sept", "fc"])
@pytest.mark.parametrize("lb", ["least_loaded", "home"])
def test_freeze_kernel_on_16_nodes_of_18_cores(cuda, lb, policy):
    """16 nodes x 18 cores pad to 512 slots: the wide path, 16 slots and
    nodes a lane in device memory."""
    specs = [(policy, 16, 18, 2, s, lb, 16 * 18) for s in range(3)]
    host, static, key = _bucket(specs)
    plan = _plan(host, static)
    assert plan["wide"] and plan["per_lane"] == 16
    _matches_plain(host, static, cuda, f"16 x 18, {lb}, {policy}")


def _records(res):
    return [(r.fn, r.r, r.start, r.finish, r.priority, r.node)
            for r in res.requests]


@pytest.mark.gpu
def test_simulate_cells_scan_on_the_card_matches_the_cpu(cuda):
    def run(device):
        batch = [(generate_burst(cores=10, intensity=v, seed=s), 10, pol)
                 for s, (v, pol) in enumerate([(30, "fc"), (60, "sept"),
                                               (30, "fifo"), (60, "rect")])]
        return [_records(r) for r in tfp.simulate_cells_scan(
            batch, device=device)]

    k0 = ops.FREEZE_LAUNCHES
    got = run(cuda)
    assert ops.FREEZE_LAUNCHES > k0
    assert got == run("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("lb", ["least_loaded", "home"])
def test_simulate_cluster_push_on_the_card_matches_the_cpu(cuda, lb):
    def run(device):
        batch = [(generate_burst(cores=16, intensity=20, seed=s), nodes, 8,
                  pol, "push", lb)
                 for s, (nodes, pol) in enumerate([(2, "fc"), (4, "sept"),
                                                   (3, "eect")])]
        return [_records(r) for r in tfp.simulate_cluster_cells_scan(
            batch, device=device)]

    k0 = ops.FREEZE_LAUNCHES
    got = run(cuda)
    assert ops.FREEZE_LAUNCHES > k0
    assert got == run("cpu")
