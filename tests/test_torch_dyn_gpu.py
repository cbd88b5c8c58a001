"""The CUDA float64 pull ``event_step`` kernel (pull cells with capacity
dynamics -- failures, the autoscaler -- and node speeds) against its plain
PyTorch version, on the card.  A CUDA kernel has no CPU mode, so these
tests carry the ``gpu`` marker and skip where there is no card; run them on
a card with

    python -m pytest -q -m gpu tests/test_torch_dyn_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_dyn_scan.py`` holds the plain version to the JAX scan
on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish / prio / node
and the summary (calls lost and done, nodes provisioned, activation times,
dead flags) are ``torch.equal``.

Inputs: buckets filled from real bursts by the bucket runner, padded to a
power of two (one idle cell): the autoscaler frontier (FC, 2-5 nodes of 8
cores, a 40-core burst at intensity 40, up to 7 nodes) at provision delays
10, 30 and 60 s; kills mid-burst, two kills of one node and a kill after
the drain under all five policies; degradation episodes and static speeds,
and both with failures; the straggler grid's heavy bucket (4 x 8 cores, a
32-core burst at intensity 96: n_b = 4,096); cells of different n in one
block; the kernel's own paths, each chosen by shape
(``ops.event_step_plan(..., f64=True)``): 1, 2, 4 and 8 slots a lane, rows
too long to stage, and 16 nodes x 18 cores autoscaling to 20 (the wide
path); and a step budget too small, which the bucket runner refuses.

The wide path's dispatch from group summaries
(``tests/wide_dispatch_cases.py``): 300 and 2,100 functions (padded to
512 and 4,096) under all five policies with a kill that re-queues calls
(FIFO under ``dyn``: every head's priority equal), node speeds without
dynamics, cold starts, the FC window stepping forward and back (negative
costs), and EECT buckets whose two bases differ in the last place but
merge once ``now`` is added, the larger base holding the smaller head row,
in one group and in two.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.sweep import (
    SweepCell,
    _cell_dynamics,
    _cell_profile,
    make_workload,
)
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.core.request import Request
from repro_torch.core.stragglers import NodeSpeedProfile
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from wide_dispatch_cases import (  # noqa: E402
    TIE_CORES,
    TIE_NODES,
    many_fn_requests,
    merged_bases_requests,
)

POLICIES = ("fifo", "sept", "eect", "rect", "fc")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _scan_cell(c: SweepCell):
    reqs = make_workload(c)
    return tfp._ScanCell(requests=reqs, feats=tfp._arrival_features(reqs),
                         cores=c.cores, nodes=c.nodes, policy=c.policy,
                         dynamics=_cell_dynamics(c), profile=_cell_profile(c))


def _bucket(cells, n_b=None):
    """A filled bucket of ``cells`` (SweepCells) under the widest key of
    its cells (or rows ``n_b`` long), its static arguments and key."""
    prepared = [_scan_cell(c) for c in cells]
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    if n_b is not None:
        key = key[:1] + (n_b,) + key[2:]
    return tfp._fill_bucket(key, prepared), tfp._scan_static(key), key


def _plan(host, static):
    return ops.event_step_plan(n1=host["t"].shape[1],
                               n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               n_fns=host["ring0"].shape[2],
                               window=static["window"], f64=True,
                               dyn=static["dyn"])


def _matches_plain(host, static, cuda, what, complete=True):
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"], dyn=static["dyn"],
                           cold=static["cold"])
    assert clk.dtype == torch.float64
    n = inp["t"].shape[1] - 1
    k0, r0 = ops.DYN_LAUNCHES, ops.DYN_REF_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert (ops.DYN_LAUNCHES, ops.DYN_REF_LAUNCHES) == (k0 + 1, r0 + 1)
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    assert ref[4].keys() == got[4].keys()
    for k in ref[4]:
        assert torch.equal(ref[4][k], got[4][k]), f"{k} diverged ({what})"
    if not complete:        # hand-made inputs may leave a call unserved
        return got
    # every real call was dispatched, onto a node the cell could reach
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what
    if static["dyn"]:
        assert torch.equal(got[4]["ndone"].long(),
                           inp["nreq"].long()), what
    return got


FRONTIER = [SweepCell(policy="fc", nodes=n, cores=8, intensity=40,
                      autoscale=True, scale_up=2.0, max_nodes=7, seed=s,
                      workload_cores=40)
            for n in (2, 3, 4, 5) for s in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("delay", [10.0, 30.0, 60.0])
def test_dyn_kernel_on_frontier_buckets(cuda, delay):
    cells = [dataclasses.replace(c, provision_delay=delay)
             for c in FRONTIER]
    host, static, key = _bucket(cells)
    assert static["dyn"] and not static["het"] and key[1] == 2048
    assert _plan(host, static)["staged"]
    got = _matches_plain(host, static, cuda, f"frontier pd{delay:g}")
    # the autoscaler provisioned beyond some cell's initial fleet
    prov = got[4]["prov"][:len(cells)].cpu().numpy()
    assert (prov > host["nodes"][:len(cells)]).any()


FAILS = {"mid-burst": dict(fail_at=8.0),
         "two kills of one node": dict(fail_spec=((0, 20.0), (0, 5.0))),
         "after the drain": dict(fail_at=1e6),
         "rolling": dict(fail_spec=((0, 8.0), (1, 16.0)))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FAILS))
@pytest.mark.parametrize("policy", POLICIES)
def test_dyn_kernel_with_failures(cuda, policy, case):
    cells = [SweepCell(policy=policy, nodes=3, cores=6, intensity=15, seed=s,
                       **FAILS[case]) for s in range(3)]
    host, static, _ = _bucket(cells)
    got = _matches_plain(host, static, cuda, f"{policy}, {case}")
    lost = got[4]["nfail"][:3]
    if case == "after the drain":
        assert int(lost.sum()) == 0
    elif case != "two kills of one node":
        assert int(lost.sum()) > 0


HET = {"episodes": dict(degrade=((0, 5.0, 40.0, 4.0), (1, 20.0, 60.0, 2.0))),
       "speeds": dict(node_speeds=(0.25, 1.0, 0.5)),
       "episodes + failure": dict(degrade=((0, 1.0, 300.0, 5.0),),
                                  fail_spec=((0, 8.0),)),
       "speeds + autoscale": dict(node_speeds=(0.2, 1.0), autoscale=True,
                                  provision_delay=5.0, scale_up=0.25,
                                  max_nodes=5)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HET))
@pytest.mark.parametrize("policy", ["fifo", "sept", "fc"])
def test_dyn_kernel_with_node_speeds(cuda, policy, case):
    cells = [SweepCell(policy=policy, nodes=3, cores=4, intensity=16, seed=s,
                       **HET[case]) for s in range(3)]
    host, static, _ = _bucket(cells)
    assert static["het"]
    _matches_plain(host, static, cuda, f"{policy}, {case}")


@pytest.mark.gpu
def test_dyn_kernel_on_overlapping_episodes(cuda):
    """Two episodes of one node overlap (a bucket the profile class
    refuses, built by hand): the slowdown is their product."""
    cells = [SweepCell(policy="sept", nodes=2, cores=4, intensity=12, seed=s,
                       degrade=((0, 5.0, 40.0, 4.0), (1, 20.0, 60.0, 2.0)))
             for s in range(3)]
    host, static, _ = _bucket(cells)
    host["epn"][:, 1] = 0          # the second episode moves to node 0
    host["epf"][:, 1] = 3.0
    _matches_plain(host, static, cuda, "overlapping episodes")


@pytest.mark.gpu
def test_dyn_kernel_on_the_straggler_heavy_bucket(cuda):
    """4 x 8 cores, a 32-core burst at intensity 96 (3,377 calls): n_b =
    4,096, rows staged, one node 8x slow."""
    cells = [SweepCell(policy="fc", nodes=4, cores=8, intensity=96, seed=s,
                       workload_cores=32, degrade=((0, 2.0, 300.0, sev),))
             for s, sev in ((0, 8.0), (1, 2.0), (2, 4.0))]
    host, static, key = _bucket(cells)
    assert key[1] == 4096 and static["het"] and not static["dyn"]
    assert _plan(host, static)["staged"]
    _matches_plain(host, static, cuda, "straggler heavy")


@pytest.mark.gpu
def test_dyn_kernel_with_rows_too_long_to_stage(cuda):
    cells = [SweepCell(policy=p, nodes=3, cores=6, intensity=15, seed=s,
                       fail_at=8.0, degrade=((1, 2.0, 30.0, 3.0),))
             for s, p in enumerate(POLICIES[:4])]
    host, static, _ = _bucket(cells, n_b=16384)
    assert not _plan(host, static)["staged"]
    _matches_plain(host, static, cuda, "rows in place")


@pytest.mark.gpu
def test_dyn_kernel_with_cells_of_different_n_in_a_block(cuda):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    cells = [SweepCell(policy=POLICIES[s % 4], nodes=2 + s % 3, cores=4,
                       intensity=4 if s % 2 else 16, seed=s, fail_at=6.0,
                       autoscale=bool(s % 4 == 0), max_nodes=5)
             for s in range(2 * n_sm + 8)]
    host, static, _ = _bucket(cells)
    _matches_plain(host, static, cuda, "cells of different n")


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,per_lane", [(4, 1), (8, 2), (16, 4),
                                            (32, 8)])
@pytest.mark.parametrize("policy", ["rect", "fc"])
def test_dyn_kernel_with_several_slots_a_lane(cuda, policy, nodes,
                                              per_lane):
    cells = [SweepCell(policy=policy, nodes=nodes, cores=8, intensity=4,
                       seed=s, workload_cores=8 * nodes, fail_at=5.0,
                       node_speeds=(0.5,)) for s in range(3)]
    host, static, _ = _bucket(cells)
    plan = _plan(host, static)
    assert plan["per_lane"] == per_lane and not plan["wide"]
    _matches_plain(host, static, cuda, f"{nodes} nodes x 8 slots, {policy}")


@pytest.mark.gpu
def test_dyn_kernel_on_the_wide_path(cuda):
    """16 nodes x 18 cores autoscaling up to 20 pad to 32 x 32 slots: the
    wide path (state and ring in the scratch)."""
    cells = [SweepCell(policy="fc", nodes=16, cores=18, intensity=6, seed=s,
                       workload_cores=16 * 18, autoscale=True,
                       provision_delay=10.0, scale_up=0.5, max_nodes=20,
                       fail_at=30.0) for s in range(2)]
    host, static, key = _bucket(cells)
    assert key[2:4] == (32, 32)
    assert _plan(host, static)["wide"]
    _matches_plain(host, static, cuda, "16 x 18 -> 20 nodes")


@pytest.mark.gpu
def test_an_exhausted_step_budget_raises(cuda, monkeypatch):
    """The bucket runner holds every dynamic cell to ndone == n: with a
    budget cut short the kernel stops early and the runner raises."""
    cells = [_scan_cell(c) for c in FRONTIER[:2]]
    key = cells[0].bucket()
    real = tfp._scan_static

    def short(k):
        return {**real(k), "n_steps": len(cells[0].feats.t)}

    monkeypatch.setattr(tfp, "_scan_static", short)
    k0 = ops.DYN_LAUNCHES
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tfp._run_scan_bucket(key, cells, cuda)
    assert ops.DYN_LAUNCHES == k0 + 1


def _request_cell(reqs, policy, nodes, cores, **kw):
    return tfp._ScanCell(requests=reqs, feats=tfp._arrival_features(reqs),
                         cores=cores, nodes=nodes, policy=policy, **kw)


def _request_bucket(prepared):
    key = tuple(max(col) for col in zip(*{c.bucket() for c in prepared}))
    return tfp._fill_bucket(key, prepared), tfp._scan_static(key), key


def _wide_plan(host, static):
    plan = _plan(host, static)
    n_fns = host["ring0"].shape[2]
    assert plan["wide"] and n_fns > 32
    assert plan["cell_bytes"] == ops.EVENT_STEP_DYN_GROUP_BYTES * (
        -(-n_fns // 32))
    return plan


@pytest.mark.gpu
@pytest.mark.parametrize("n_fns", [300, 2100])
@pytest.mark.parametrize("policy", POLICIES)
def test_dyn_kernel_wide_functions_with_a_kill(cuda, policy, n_fns):
    """Many functions on 3 x 4 cores, node 1 killed mid-burst: its calls
    re-queue (``n_xq > 0``) beside the functions' queues."""
    dyn = ClusterDynamics(fail=((1, 6.0),), failure_detect_s=0.5)
    prepared = [_request_cell(
        many_fn_requests(Request, n_fns + 300, n_fns, seed=s, span=25.0),
        policy, 3, 4, dynamics=dyn) for s in range(2)]
    host, static, key = _request_bucket(prepared)
    assert static["dyn"] and key[4] >= n_fns
    _wide_plan(host, static)
    got = _matches_plain(host, static, cuda, f"{policy}, {n_fns} functions")
    assert int(got[4]["nfail"][:2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["sept", "fc", "rect"])
def test_dyn_kernel_wide_functions_with_speeds(cuda, policy):
    """Node speeds without dynamics (no enqueue clock) on 300 functions."""
    prof = NodeSpeedProfile(speeds=(1.0, 0.3, 5.0))
    prepared = [_request_cell(many_fn_requests(Request, 700, 300, seed=s,
                                               span=25.0),
                              policy, 3, 4, profile=prof) for s in range(2)]
    host, static, _ = _request_bucket(prepared)
    assert static["het"] and not static["dyn"]
    _wide_plan(host, static)
    _matches_plain(host, static, cuda, f"{policy}, speeds")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["sept", "fc"])
def test_dyn_kernel_wide_functions_cold(cuda, policy):
    prepared = [_request_cell(many_fn_requests(Request, 600, 300, seed=s,
                                               span=25.0),
                              policy, 3, 4, warm=False) for s in range(2)]
    host, static, _ = _request_bucket(prepared)
    assert static["cold"]
    _wide_plan(host, static)
    got = _matches_plain(host, static, cuda, f"{policy}, cold")
    assert int(got[4]["ncold"][:2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_fns", [300, 2100])
def test_dyn_kernel_wide_fc_window_steps_back(cuda, n_fns):
    """Negative channel costs let an event land before an earlier one, so
    now - horizon falls and the FC window's start steps back: each count
    that moves summarizes its group again."""
    dyn = ClusterDynamics(fail=((0, 4.0),), failure_detect_s=0.5)
    prepared = [_request_cell(
        many_fn_requests(Request, n_fns + 300, n_fns, seed=s, span=25.0),
        "fc", 3, 4, dynamics=dyn) for s in range(2)]
    host, static, _ = _request_bucket(prepared)
    n = host["t"].shape[1] - 1
    host["cost"][:, :n] = -0.25
    static = dict(static, horizon=0.5)
    assert static["use_fc"]
    _wide_plan(host, static)
    _matches_plain(host, static, cuda, f"fc window back, {n_fns}",
                   complete=False)


@pytest.mark.gpu
def test_dyn_kernel_eect_merged_bases(cuda):
    """Two bases 2^-52 apart merge into one priority once now is added;
    the larger base holds the smaller head row and wins, in one group of
    32 functions (cell 0: the group is scanned in full) and across two
    (cell 1)."""
    dyn = ClusterDynamics(fail=((0, 1e6),))
    prepared = [_request_cell(merged_bases_requests(Request, same),
                              "eect", TIE_NODES, TIE_CORES, dynamics=dyn)
                for same in (True, False)]
    host, static, key = _request_bucket(prepared)
    assert key[4] == 512
    _wide_plan(host, static)
    got = _matches_plain(host, static, cuda, "eect merged bases")
    # rows 4 and 5 are B's and A's second calls: B's, the larger base,
    # went first
    start = got[0].cpu().numpy()
    assert (start[:2, 4] < start[:2, 5]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fifo", "eect"])
def test_dyn_kernel_wide_enqueue_clock_ties_at_2048_functions(cuda, policy):
    """FIFO (every head's base 0) and EECT under the autoscaler on 2,048
    functions on 34 single-core nodes: the enqueue clock on every head."""
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=1.0,
                          scale_up_queue_per_slot=0.5, provision_delay_s=2.0,
                          max_nodes=40)
    prepared = [_request_cell(many_fn_requests(Request, 3000, 2048, seed=s,
                                               span=40.0),
                              policy, 34, 1, dynamics=dyn) for s in range(2)]
    host, static, key = _request_bucket(prepared)
    assert key[4] == 2048
    _wide_plan(host, static)
    _matches_plain(host, static, cuda, f"{policy} autoscale, 2048")
