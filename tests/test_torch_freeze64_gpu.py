"""The CUDA float64 frozen-priority ``event_step`` kernel (single-node and
push cells with capacity dynamics, node speeds or cold starts) against its
plain PyTorch version, on the card.  A CUDA kernel has no CPU mode, so
these tests carry the ``gpu`` marker and skip where there is no card; run
them on a card with

    python -m pytest -q -m gpu tests/test_torch_freeze64_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_freeze64_scan.py`` holds the plain version to the JAX
scan on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish / prio /
node and the summary (calls lost and done, nodes provisioned, activation
times, dead flags; cold starts, evictions, every row's cold-start flag)
are ``torch.equal``.

Inputs: buckets filled from real bursts by the bucket runner: the cold
matrix's push buckets (4 x 8 cores, least-loaded, a 32-core burst at
intensities 18, 96 and 140: n_b 1,024 and 4,096 staged, 8,192 on the wide
path), the straggler grid's slowed push bucket (home balancer, node 0 2-8x
slow), the steal matrix's cell without hedging (3 x 6 cores, a rolling
kill, the autoscaler, node 0 5x slow), single-node cold cells at 10 cores,
kills that lose queued calls, 1 and 2 slots a lane (4 and 8 on the wide
path), 16 nodes x 18 cores (the wide path), cells of different n in one
block, pools preset full (every release evicts); then ``run_cells_scan``
on the card against the CPU.
"""

import pytest
import torch

from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import carry_layout, make_planes
from repro_torch.core.stragglers import rolling_restart
from repro_torch.core.sweep import (
    SweepCell,
    _cell_dynamics,
    _cell_profile,
    _cluster_shaped,
    make_workload,
    run_cells_scan,
)
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _cell(policy="fc", nodes=4, cores=8, intensity=18, seed=0, **kw):
    kw.setdefault("assignment", "push")
    return SweepCell(policy=policy, nodes=nodes, cores=cores,
                     intensity=intensity, seed=seed, **kw)


def _bucket(cells):
    """A filled float64 frozen-priority bucket of ``cells`` under the
    widest key of its cells, its static arguments and key."""
    prepared = []
    for c in cells:
        reqs = make_workload(c)
        prepared.append(tfp._ScanCell(
            requests=reqs, feats=tfp._arrival_features(reqs), cores=c.cores,
            nodes=c.nodes, policy=c.policy,
            assignment=c.assignment if _cluster_shaped(c) else "single",
            lb=c.lb, warm=c.warm, dynamics=_cell_dynamics(c),
            profile=_cell_profile(c)))
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    static = tfp._scan_static(key)
    assert static["freeze"] and (static["dyn"] or static["het"]
                                 or static["cold"])
    return tfp._fill_bucket(key, prepared), static, key


def _plan(host, static):
    return ops.event_step_plan(n1=host["t"].shape[1],
                               n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               n_fns=host["ring0"].shape[2],
                               window=static["window"], freeze=True,
                               f64=True, fc_push=static["fc_push"],
                               fc_ring=static["fc_ring"], dyn=static["dyn"],
                               cold=static["cold"])


_SEG = ("freeze", "fc_push", "fc_ring", "dyn", "het", "cold")


def _matches_plain(host, static, cuda, what, free0=None):
    """Kernel against the plain version on one bucket; ``free0`` presets
    every (node, function) pool of the carry to that many containers."""
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    seg = {k: static[k] for k in _SEG}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"], **seg)
    if free0 is not None:
        lay = carry_layout(n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"],
                           n_fns=host["ring0"].shape[2],
                           n1=host["t"].shape[1], **seg)
        lo, hi = next((lo, hi) for k, lo, hi, *_ in lay.iparts
                      if k == "freec")
        ctr[:, lo:hi] = free0
    assert clk.dtype == torch.float64
    n = inp["t"].shape[1] - 1
    k0, r0 = ops.FREEZE64_LAUNCHES, ops.FREEZE64_REF_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert (ops.FREEZE64_LAUNCHES, ops.FREEZE64_REF_LAUNCHES) == \
        (k0 + 1, r0 + 1)
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    assert ref[4].keys() == got[4].keys()
    for k in ref[4]:
        assert torch.equal(ref[4][k], got[4][k]), f"{k} diverged ({what})"
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fc", "sept"])
@pytest.mark.parametrize("intensity,n_b,wide", [(18, 1024, False),
                                                (96, 4096, False),
                                                (140, 8192, True)])
def test_kernel_on_the_cold_matrix_push_buckets(cuda, intensity, n_b, wide,
                                                policy):
    cells = [_cell(policy, intensity=intensity, seed=s, workload_cores=32,
                   warm=False) for s in range(2)]
    host, static, key = _bucket(cells)
    assert key[1] == n_b and not (static["dyn"] or static["het"])
    assert _plan(host, static)["wide"] == wide
    got = _matches_plain(host, static, cuda, f"{policy} v{intensity}")
    assert bool((got[4]["ncold"][:2] > 0).all())


CASES = {
    "straggler push, home, node 0 2-8x slow": [
        _cell("fc", lb="home", workload_cores=32,
              degrade=((0, 2.0, 300.0, s),), seed=k)
        for k, s in enumerate((2.0, 4.0, 6.0, 8.0))],
    "steal matrix without hedging, fc": [
        _cell("fc", 3, 6, v, s, fail_spec=rolling_restart(1, start=8.0),
              degrade=((0, 1.0, 300.0, 5.0),), autoscale=True, scale_up=1.0,
              provision_delay=2.0, max_nodes=5)
        for v in (16, 25) for s in range(2)],
    "steal matrix without hedging, sept": [
        _cell("sept", 3, 6, v, s, fail_spec=rolling_restart(1, start=8.0),
              degrade=((0, 1.0, 300.0, 5.0),), autoscale=True, scale_up=1.0,
              provision_delay=2.0, max_nodes=5)
        for v in (16, 25) for s in range(2)],
    "kills losing queued calls": [
        _cell(p, 3, 2, 20, s, workload_cores=12,
              fail_spec=((0, 20.0), (2, 35.0)))
        for s, p in enumerate(("sept", "rect", "eect"))],
    "autoscaler alone": [
        _cell("fc", 1, 4, 30, s, workload_cores=8, autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=4)
        for s in range(3)],
    "single-node cold, fc": [
        _cell("fc", 1, 10, v, s, warm=False) for v in (30, 60)
        for s in range(2)],
    "single-node cold, sept": [
        _cell("sept", 1, 10, v, s, warm=False) for v in (30, 60)
        for s in range(2)],
    "cold + failure + speeds + autoscale": [
        _cell(p, 3, 4, 16, s, warm=False, fail_spec=((0, 8.0),),
              degrade=((1, 1.0, 300.0, 5.0),), autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=5)
        for s, p in enumerate(("eect", "fifo", "sept"))],
    "cold + node speeds, home": [
        _cell("rect", 3, 4, 16, s, lb="home", warm=False,
              node_speeds=(0.3, 1.0, 0.7), degrade=((0, 1.0, 300.0, 5.0),))
        for s in range(3)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_on_real_buckets(cuda, case):
    cells = CASES[case]
    host, static, _ = _bucket(cells)
    got = _matches_plain(host, static, cuda, case)
    nc = len(cells)
    if static["dyn"]:
        assert bool((got[4]["ndone"][:nc].cpu()
                     == torch.from_numpy(host["nreq"][:nc])).all())
    if any(c.fail_spec for c in cells):
        assert int(got[4]["nfail"][:nc].sum()) > 0
    if "queued" in case:
        assert bool((got[4]["nfail"][:nc] > cells[0].cores).any())
    if any(c.autoscale for c in cells):
        assert bool((got[4]["prov"][:nc].cpu()
                     > torch.from_numpy(host["nodes"][:nc])).any())
    if static["cold"]:
        assert bool((got[4]["ncold"][:nc] > 0).all())


@pytest.mark.gpu
def test_kernel_with_cells_of_different_n_in_a_block(cuda):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    cells = [_cell("sept", 2 + s % 3, 4, 4 if s % 2 else 16, s, warm=False)
             for s in range(2 * n_sm + 8)]
    host, static, _ = _bucket(cells)
    _matches_plain(host, static, cuda, "cells of different n")


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,per_lane", [(4, 1), (8, 2), (16, 4),
                                            (32, 8)])
def test_kernel_with_several_slots_a_lane(cuda, nodes, per_lane):
    """1 and 2 slots a lane are staged in shared memory; 4 and 8 take the
    wide path."""
    cells = [_cell("fc", nodes, 8, 4, s, workload_cores=8 * nodes,
                   fail_at=10.0) for s in range(3)]
    host, static, _ = _bucket(cells)
    plan = _plan(host, static)
    assert plan["per_lane"] == per_lane
    assert plan["wide"] == (per_lane > 2)
    _matches_plain(host, static, cuda, f"{nodes} nodes x 8 slots")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cold", "dyn"])
def test_kernel_on_the_wide_path(cuda, kind):
    """16 nodes x 18 cores pad to 16 x 32 slots: the wide path, lane
    arrays, estimators and queue in the scratch."""
    kw = (dict(warm=False) if kind == "cold"
          else dict(fail_at=10.0, degrade=((3, 1.0, 300.0, 3.0),)))
    cells = [_cell("fc", 16, 18, 6, s, workload_cores=16 * 18, **kw)
             for s in range(2)]
    host, static, key = _bucket(cells)
    assert _plan(host, static)["wide"]
    _matches_plain(host, static, cuda, f"16 x 18 {kind}")


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_with_evictions(cuda, wide):
    """Pools preset to cores + 1 free containers: every release finds its
    pool full and evicts, and no dispatch starts cold."""
    cells = ([_cell("fc", 16, 18, 6, s, workload_cores=16 * 18, warm=False)
              for s in range(2)] if wide
             else [_cell("sept", 2, 4, 12, s, warm=False)
                   for s in range(3)])
    host, static, _ = _bucket(cells)
    assert _plan(host, static)["wide"] == wide
    got = _matches_plain(host, static, cuda, "full pools",
                         free0=cells[0].cores + 1)
    nc = len(cells)
    assert bool((got[4]["nevt"][:nc] > 0).all())
    assert int(got[4]["ncold"][:nc].sum()) == 0


@pytest.mark.gpu
def test_run_cells_scan_on_the_card_equals_the_cpu(cuda):
    cells = ([_cell(p, seed=s, workload_cores=32, warm=False)
              for p in ("fc", "sept") for s in range(2)]
             + [_cell("fc", lb="home", workload_cores=32,
                      degrade=((0, 2.0, 300.0, 6.0),), seed=s)
                for s in range(2)]
             + [_cell("sept", 1, 10, 30, 0, warm=False)])
    ops.reset_launches()
    got = run_cells_scan(cells, metrics_only=True, device=cuda)
    counts = ops.launches()
    assert counts["event_step_freeze64"]["kernel"] == 4
    assert all(v["plain"] == 0 for v in counts.values())
    want = run_cells_scan(cells, metrics_only=True, device="cpu")
    assert got == want
