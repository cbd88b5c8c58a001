"""The port's frozen-priority scan (single-node and push cells) against the
JAX package.

Contracts (tolerance 0 throughout -- every comparison is ``==``):

* the plain ``event_step`` with ``freeze`` (``repro_torch.kernels.ops`` on
  CPU tensors) gives rows ``[:n]`` of start, finish, prio and node
  bit-identical to ``repro.kernels.ops.event_step(force="ref")``, the jnp
  oracle (the freeze branch of ``fastpath._scan_cell_kernel``), on the same
  inputs made with numpy from a seed: buckets filled from real bursts for
  the five policies on one node, under push least-loaded on 3 nodes (padded
  to 4, so one node never takes a call) and under push home on 2 and 3
  nodes (FC with the push rings); hand-built buckets with a warm-seeded
  ring, an FC-ish coefficient of 0.3 and random routes, so inexact products
  and sums show any change in the order of operations; and buckets whose
  times are multiples of 1/8 s, where SEPT and FC priorities tie exactly;
* the carry planes with the ``freeze`` and ``fc_push`` segments have the
  JAX package's layout and bytes;
* ``simulate_cells_scan`` and push ``simulate_cluster_cells_scan`` write
  back the JAX package's start, finish, priority and node;
* ``run_cells_scan(metrics_only=True)`` rows equal the JAX package's, key
  for key, on a grid mixing single-node, pull, push least-loaded and push
  home cells, and equal the port's own write-back rows;
* ``SweepSpec.cells()`` yields the JAX package's cells, labels and order
  with the assignment and balancer axes;
* ``stable_hash`` is the JAX package's.

The CUDA kernel is held against the plain version in
``tests/test_torch_freeze_gpu.py``, on the card.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro.core import sweep as jsweep
from repro.core.traces import stable_hash as jax_stable_hash
from repro.core.workload import generate_burst as jax_burst
from repro.kernels import ops as jops
from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import sweep as tsweep
from repro_torch.core.traces import stable_hash
from repro_torch.core.workload import PROFILES, generate_burst
from repro_torch.kernels import ops as tops

POLICIES = ("fifo", "sept", "eect", "rect", "fc")
OFF = dict(dyn=False, het=False, hedge=False, cold=False, dup=False)
# (nodes, balancer): one node, push least-loaded on 3 (padded to 4), push
# home on 2 and 3
FLEETS = [(1, None), (3, "least_loaded"), (2, "home"), (3, "home")]


def _static(key):
    """The JAX oracle's static arguments of a port bucket key."""
    flags = tfp._key_flags(key)
    _, n_b, nodes_b, slots_b, _, _, window, fc_ring = key[:8]
    return dict(OFF, **flags, n_nodes=nodes_b, n_slots=slots_b,
                window=window, n_copies=1, n_ep=1, fc_ring=fc_ring,
                horizon=60.0, n_steps=2 * n_b)


def _jax_step(inp, static):
    """The JAX oracle on a numpy bucket: (clk, ctr) and the four output
    rows as numpy arrays."""
    arrs = {k: jnp.asarray(v) for k, v in inp.items()}
    plane_kw = {k: static[k] for k in ("n_nodes", "n_slots", "window",
                                       "n_copies", "fc_ring", "freeze",
                                       "fc_push")}
    plane_kw.update(OFF)
    clk, ctr = jax.vmap(partial(jfp._make_planes, **plane_kw))(arrs)
    out = jops.event_step(clk, ctr, arrs, force="ref", **static)
    return np.asarray(clk), np.asarray(ctr), [np.asarray(o) for o in out[:4]]


def _torch_step(inp, clk, ctr, static):
    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    r0 = tops.FREEZE_REF_LAUNCHES
    out = tops.event_step(clk_t, ctr_t, tens, **static)
    assert tops.FREEZE_REF_LAUNCHES == r0 + 1 and out[4] == {}
    return [o.numpy() for o in out[:4]]


def _assert_rows_equal(ref, got, n, what):
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{name} diverged ({what})")


def _burst_bucket(policy, nodes, lb, seeds=(0, 1, 2), cores=4, intensity=8,
                  quantum=None):
    """A filled bucket of real-burst cells of one fleet (padded to a power
    of two: the last cell is an idle padded one), its key and n_b.  With
    ``quantum`` every time is rounded to a multiple of it."""
    cells = []
    for s in seeds:
        reqs = generate_burst(cores=cores * nodes, intensity=intensity,
                              seed=s)
        cells.append(tfp._ScanCell(
            requests=reqs, feats=tfp._arrival_features(reqs), cores=cores,
            nodes=nodes, policy=policy,
            assignment="single" if nodes == 1 else "push",
            lb=lb or "least_loaded"))
    keys = {c.bucket() for c in cells}
    key = tuple(max(col) for col in zip(*keys))
    inp = tfp._fill_bucket(key, cells)
    if quantum is not None:
        for k in ("t", "p", "cost"):
            inp[k] = (np.round(inp[k] / quantum) * quantum).astype(
                np.float32)
        inp["p"] = np.where(np.isfinite(inp["t"]),
                            np.maximum(inp["p"], quantum), 0).astype(
                                np.float32)
    return key, inp


@pytest.mark.parametrize("fleet", FLEETS, ids=lambda f: f"{f[0]}{f[1] or ''}")
@pytest.mark.parametrize("policy", POLICIES)
def test_burst_bucket_bit_identical(policy, fleet):
    nodes, lb = fleet
    key, inp = _burst_bucket(policy, nodes, lb)
    static = _static(key)
    assert static["freeze"] and static["fc_push"] == (policy == "fc"
                                                       and nodes > 1)
    n = key[1]
    clk, ctr, ref = _jax_step(inp, static)
    got = _torch_step(inp, clk, ctr, static)
    _assert_rows_equal(ref, got, n, f"{policy}, {nodes} nodes, {lb}")
    # every real call was dispatched once, onto one of the cell's nodes
    for b in range(3):
        m = np.isfinite(inp["t"][b, :n])
        assert (got[1][b, :n][m] > got[0][b, :n][m]).all()
        assert (got[3][b, :n][m] < nodes).all()
    if lb == "least_loaded":
        assert (got[3][:3, :n] < nodes).all()   # the padded node idles


@pytest.mark.parametrize("fleet", FLEETS, ids=lambda f: f"{f[0]}{f[1] or ''}")
@pytest.mark.parametrize("policy", ["sept", "fc"])
def test_exact_ties_bit_identical(policy, fleet):
    nodes, lb = fleet
    key, inp = _burst_bucket(policy, nodes, lb, quantum=0.125)
    static = _static(key)
    n = key[1]
    clk, ctr, ref = _jax_step(inp, static)
    # ties must really occur: equal frozen priorities within a cell
    prio = ref[2][0, :n][np.isfinite(inp["t"][0, :n])]
    assert len(np.unique(prio)) < len(prio)
    _assert_rows_equal(ref, _torch_step(inp, clk, ctr, static), n,
                       f"quantized, {policy}, {nodes} nodes, {lb}")


def _smoke_inputs(fc_push, B=6, n=24, F=3, NN=4, NS=4, W=4, R=8, seed=0,
                  quantum=None):
    """Hand-built frozen-priority bucket: sorted arrivals, a warm-seeded
    ring on every node, FIFO / SEPT / FC-ish / EECT / RECT coefficient
    rows, cells of 1 to NN nodes with random routes and home nodes, and
    random static FC counts."""
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
                  n_nodes=NN, n_slots=NS, window=W, n_copies=1, n_ep=1,
                  fc_ring=R if fc_push else 1, horizon=0.5,
                  n_steps=2 * n + 2)
    return inp, static, n


@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fc_push", [False, True])
def test_smoke_bucket_bit_identical(fc_push, seed, quantum):
    inp, static, n = _smoke_inputs(fc_push, seed=seed, quantum=quantum)
    clk, ctr, ref = _jax_step(inp, static)
    _assert_rows_equal(ref, _torch_step(inp, clk, ctr, static), n,
                       f"fc_push={fc_push}, seed={seed}, q={quantum}")


@pytest.mark.parametrize("fc_push", [False, True])
def test_planes_match_jax(fc_push):
    inp, static, _ = _smoke_inputs(fc_push)
    F, W, NN, NS = 3, static["window"], static["n_nodes"], static["n_slots"]
    spec = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
            for k, v in inp.items()}
    flags = {k: static[k] for k in ("freeze", "fc_push", "n_copies",
                                    "fc_ring")}
    ref = jfp._carry_layout(spec, n_nodes=NN, n_slots=NS, window=W,
                            **flags, **OFF)
    got = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F,
                              freeze=True, fc_push=fc_push,
                              n1=inp["t"].shape[1],
                              fc_ring=static["fc_ring"])
    assert (got.fparts, got.iparts) == (ref.fparts, ref.iparts)
    assert (got.f_len, got.i_len) == (ref.f_len, ref.i_len)
    clk_j, ctr_j, _ = _jax_step(inp, dict(static, n_steps=0))
    tens, _, _ = bucket_from_numpy(inp, device="cpu")
    clk_t, ctr_t = planes.make_planes(tens, n_nodes=NN, n_slots=NS,
                                      window=W, freeze=True,
                                      fc_push=fc_push,
                                      fc_ring=static["fc_ring"])
    assert clk_t.numpy().tobytes() == clk_j.tobytes()
    assert ctr_t.numpy().tobytes() == ctr_j.tobytes()


def test_warm_seed_on_every_node():
    """Every node's estimator starts from the profile medians (§V-A)."""
    key, inp = _burst_bucket("sept", 3, "home")
    reqs = generate_burst(cores=12, intensity=8, seed=0)
    fns = sorted({q.fn for q in reqs})
    seed_n = min(4, key[6])
    for fi, fn in enumerate(fns):
        w = np.float32(PROFILES[fn].median_s)
        assert (inp["ring0"][0, :, fi, :seed_n] == w).all()
        assert (inp["ring0"][0, :, fi, seed_n:] == 0).all()
        assert (inp["rlen0"][0, :, fi] == seed_n).all()
        assert (inp["rsum0"][0, :, fi] == np.float32(seed_n * float(
            PROFILES[fn].median_s))).all()
    assert (inp["route"][:3] == 1).all()
    assert (inp["home0"][0, :len(reqs)] < 3).all()


def _written_back(res):
    return [(q.start, q.finish, q.priority, q.node, q.c)
            for q in res.requests]


@pytest.mark.parametrize("policy", POLICIES)
def test_single_node_write_back_matches_jax(policy):
    grid = [(4, 6), (4, 15), (10, 30)]
    res_j = jfp.simulate_cells_scan(
        [(jax_burst(cores=c, intensity=v, seed=s), c, policy)
         for s, (c, v) in enumerate(grid)])
    res_t = tfp.simulate_cells_scan(
        [(generate_burst(cores=c, intensity=v, seed=s), c, policy)
         for s, (c, v) in enumerate(grid)], device="cpu")
    for rj, rt in zip(res_j, res_t):
        assert rt.meta == rj.meta and rt.nodes_used == rj.nodes_used == 1
        assert _written_back(rt) == _written_back(rj), policy


@pytest.mark.parametrize("lb", ["least_loaded", "home"])
@pytest.mark.parametrize("policy", POLICIES)
def test_push_write_back_matches_jax(policy, lb):
    grid = [(2, 6), (3, 10), (4, 15)]
    res_j = jfp.simulate_cluster_cells_scan(
        [(jax_burst(cores=4 * nodes, intensity=v, seed=s), nodes, 4, policy,
          "push", lb) for s, (nodes, v) in enumerate(grid)])
    res_t = tfp.simulate_cluster_cells_scan(
        [(generate_burst(cores=4 * nodes, intensity=v, seed=s), nodes, 4,
          policy, "push", lb) for s, (nodes, v) in enumerate(grid)],
        device="cpu")
    for (nodes, _), rj, rt in zip(grid, res_j, res_t):
        assert rt.meta == rj.meta and rt.nodes_used == nodes
        assert _written_back(rt) == _written_back(rj), (policy, lb, nodes)


def _mixed(mod, seeds=2):
    """Single-node, pull, push least-loaded and push home cells of two
    SweepSpecs of ``mod``, with the JAX package's scan backend."""
    extra = {"backends": ("scan",)} if mod is jsweep else {}
    single = mod.SweepSpec(policies=POLICIES, cores=(4,),
                           intensities=(10, 30), seeds=seeds, **extra)
    fleet = mod.SweepSpec(policies=POLICIES, assignments=("pull", "push"),
                          lbs=("least_loaded", "home"), nodes=(2, 3),
                          cores=(4,), intensities=(10,), seeds=seeds,
                          workload_cores=8, **extra)
    return single.cells() + fleet.cells()


def test_metrics_rows_match_jax():
    cells_j, cells_t = _mixed(jsweep), _mixed(tsweep)
    assert len(cells_t) == len(cells_j) == 5 * 2 * 2 + 5 * 3 * 2 * 2
    rows_j = jsweep.run_cells_scan(cells_j, metrics_only=True)
    rows_t = tsweep.run_cells_scan(cells_t, metrics_only=True, device="cpu")
    assert rows_t == rows_j
    # the write-back path gives the same rows as the metrics-only one
    sample = cells_t[::3]
    assert tsweep.run_cells_scan(sample, device="cpu") == rows_t[::3]


def test_sweep_cells_match_jax_order_and_labels():
    axes = dict(policies=("sept", "fc"), assignments=("pull", "push"),
                lbs=("least_loaded", "home"), nodes=(1, 2, 4),
                cores=(4, 8), intensities=(10, 30), seeds=3)
    cells_j = jsweep.SweepSpec(**axes).cells()
    cells_t = tsweep.SweepSpec(**axes).cells()
    # pull cells collapse the balancer axis: 2 of the 3 (assignment, lb)
    # pairs for every other choice
    assert len(cells_t) == len(cells_j) == 2 * 3 * 3 * 2 * 2 * 3
    names = [f.name for f in dataclasses.fields(tsweep.SweepCell)]
    for cj, ct in zip(cells_j, cells_t):
        assert {k: getattr(cj, k) for k in names} == dataclasses.asdict(ct)
        assert ct.label() == cj.label()
    assert any(c.label().endswith("_home") for c in cells_t)


@pytest.mark.parametrize("name", ["thumbnailer", "video-processing", "",
                                  "my-custom-fn", "ünïcode"])
def test_stable_hash_matches_jax(name):
    assert stable_hash(name) == jax_stable_hash(name)


def test_scan_eligibility_matches_jax():
    reqs = generate_burst(cores=10, intensity=30, seed=0)
    for cores in (1, 10, 20, 64):
        for policy in POLICIES + ("baseline",):
            assert tfp.scan_eligible(reqs, cores, policy) == \
                jfp.scan_eligible(reqs, cores, policy), (cores, policy)
            for asg, lb in (("pull", "least_loaded"),
                            ("push", "least_loaded"), ("push", "home"),
                            ("push", "round_robin")):
                assert tfp.cluster_scan_eligible(
                    reqs, 2, cores, policy, assignment=asg, lb=lb) == \
                    jfp.cluster_scan_eligible(
                        reqs, 2, cores, policy, assignment=asg, lb=lb), \
                    (cores, policy, asg, lb)


def test_ineligible_cells_raise():
    reqs = generate_burst(cores=4, intensity=5, seed=0)
    for item in ((reqs, 4, "baseline"),
                 (reqs, 64, "sept")):              # beyond the warm regime
        with pytest.raises(ValueError):
            tfp.simulate_cells_scan([item], device="cpu")
    # a cold start on one node runs the float64 frozen-priority scan
    # (tests/test_torch_freeze64_scan.py holds it to the JAX package);
    # outside the ample-memory regime it is ineligible
    res = tfp.simulate_cells_scan([(reqs, 4, "fc", False)], device="cpu")[0]
    assert res.cold_starts > 0 and all(q.finish > 0 for q in reqs)
    with pytest.raises(ValueError):
        tfp.simulate_cells_scan([(reqs, 4, "fc", False)], memory_mb=512,
                                device="cpu")
    with pytest.raises(ValueError):
        tfp.simulate_cluster_cells_scan(
            [(reqs, 2, 4, "fc", "push", "round_robin")], device="cpu")


def test_freeze_plan_by_shape():
    plan = partial(tops.event_step_plan, n_fns=16, window=10, freeze=True)
    # Table 3's largest bucket: one node of 10 cores (16 slots), n_b 2,048
    p = plan(n1=2049, n_nodes=1, n_slots=16, fc_push=False, fc_ring=1)
    assert p == {"per_lane": 1, "wide": False, "staged": True,
                 "cell_bytes": tops.event_step_freeze_cell_bytes(
                     2049, 1, 16, 10), "scratch_words": 0}
    assert p["cell_bytes"] % 16 == 0
    # Fig 6's fleet: 4 x 18 cores, n_b 4,096, FC rings of 256 in the scratch
    p = plan(n1=4097, n_nodes=4, n_slots=32, fc_push=True, fc_ring=256)
    assert (p["per_lane"], p["wide"], p["staged"]) == (4, False, True)
    assert p["scratch_words"] == 4 * 16 * 256
    # rows too long to stage: estimators and queue in the scratch
    p = plan(n1=32769, n_nodes=4, n_slots=8, fc_push=False, fc_ring=1)
    assert (p["staged"], p["wide"], p["cell_bytes"]) == (False, False, 0)
    assert p["scratch_words"] == (tops.event_step_freeze_est_words(4, 16, 10)
                                  + 2 * 32772)
    # 16 x 18 cores: 512 slots, the wide path
    p = plan(n1=4097, n_nodes=16, n_slots=32, fc_push=True, fc_ring=256)
    assert (p["per_lane"], p["wide"], p["staged"]) == (16, True, False)
    assert p["scratch_words"] == (8 * 32 * 16
                                  + tops.event_step_freeze_est_words(
                                      16, 16, 10)
                                  + 2 * 4100 + 16 * 16 * 256)
