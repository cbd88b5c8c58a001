"""The CUDA float64 pull ``event_step`` kernel in the cold-start regime
(``warm=False`` pull cells: no warm-up, every miss a prewarmed container)
against its plain PyTorch version, on the card.  A CUDA kernel has no CPU
mode, so these tests carry the ``gpu`` marker and skip where there is no
card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_cold_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_cold_scan.py`` holds the plain version to the JAX scan
on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish / prio /
node, the cold starts, the evictions and every row's cold-start flag (and
with dynamics the summary) are ``torch.equal``.

Inputs: buckets filled from real bursts by the bucket runner: the cold
matrix's pull buckets (4 x 8 cores, a 32-core burst at intensities 18, 96
and 140: n_b 1,024, 4,096 and 8,192, rows staged), cold with a failure,
with the autoscaler, with node speeds, cells of different n in one block,
1, 2, 4 and 8 slots a lane, 16 nodes x 18 cores (the wide path, the free
counts in the scratch), and a carry whose pools start full, so that every
release evicts; then ``run_cells_scan`` on the card against the CPU.
"""

import pytest
import torch

from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import carry_layout, make_planes
from repro_torch.core.sweep import (
    SweepCell,
    _cell_dynamics,
    _cell_profile,
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
    return SweepCell(policy=policy, nodes=nodes, cores=cores,
                     intensity=intensity, seed=seed, warm=False, **kw)


def _bucket(cells):
    """A filled cold bucket of ``cells`` under the widest key of its cells,
    its static arguments and key."""
    prepared = []
    for c in cells:
        reqs = make_workload(c)
        prepared.append(tfp._ScanCell(
            requests=reqs, feats=tfp._arrival_features(reqs), cores=c.cores,
            nodes=c.nodes, policy=c.policy, warm=False,
            dynamics=_cell_dynamics(c), profile=_cell_profile(c)))
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    static = tfp._scan_static(key)
    assert static["cold"]
    return tfp._fill_bucket(key, prepared), static, key


def _plan(host, static):
    return ops.event_step_plan(n1=host["t"].shape[1],
                               n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               n_fns=host["ring0"].shape[2],
                               window=static["window"], f64=True,
                               dyn=static["dyn"], cold=True)


def _matches_plain(host, static, cuda, what, free0=None):
    """Kernel against the plain version on one bucket; ``free0`` presets
    every (node, function) pool of the carry to that many containers."""
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"], dyn=static["dyn"],
                           cold=True)
    if free0 is not None:
        lay = carry_layout(n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"],
                           n_fns=host["ring0"].shape[2],
                           n1=host["t"].shape[1], dyn=static["dyn"],
                           cold=True)
        lo, hi = next((lo, hi) for k, lo, hi, *_ in lay.iparts
                      if k == "freec")
        ctr[:, lo:hi] = free0
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
    assert ref[4].keys() == got[4].keys() >= {"ncold", "nevt", "coldq"}
    for k in ref[4]:
        assert torch.equal(ref[4][k], got[4][k]), f"{k} diverged ({what})"
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fc", "sept"])
@pytest.mark.parametrize("intensity,n_b", [(18, 1024), (96, 4096),
                                           (140, 8192)])
def test_cold_kernel_on_the_cold_matrix_pull_buckets(cuda, intensity, n_b,
                                                     policy):
    cells = [_cell(policy, intensity=intensity, seed=s, workload_cores=32)
             for s in range(2)]
    host, static, key = _bucket(cells)
    assert key[1] == n_b and not (static["dyn"] or static["het"])
    assert _plan(host, static)["staged"]
    got = _matches_plain(host, static, cuda, f"{policy} v{intensity}")
    assert bool((got[4]["ncold"][:2] > 0).all())
    assert int(got[4]["nevt"].sum()) == 0


CASES = {
    "failure": [_cell(p, 3, 4, 15, s, fail_spec=((0, 8.0), (1, 16.0)))
                for s, p in enumerate(("sept", "rect", "fifo"))],
    "autoscale": [_cell("fc", 1, 4, 30, s, workload_cores=8, autoscale=True,
                        provision_delay=5.0, scale_up=1.0, max_nodes=4)
                  for s in range(3)],
    "node speeds": [_cell(p, 3, 4, 16, s, node_speeds=(0.3, 1.0, 0.7),
                          degrade=((0, 1.0, 300.0, 5.0),))
                    for s, p in enumerate(("sept", "eect", "fifo"))],
    "failure + speeds + autoscale": [
        _cell("fc", 3, 6, 16, s, workload_cores=18, fail_spec=((0, 8.0),),
              degrade=((1, 1.0, 300.0, 5.0),), autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=5)
        for s in range(3)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cold_kernel_composes_with_dynamics_and_speeds(cuda, case):
    host, static, _ = _bucket(CASES[case])
    got = _matches_plain(host, static, cuda, case)
    if "failure" in case:
        assert int(got[4]["nfail"][:3].sum()) > 0
    if "autoscale" in case:
        assert bool((got[4]["prov"][:3].cpu()
                     > torch.from_numpy(host["nodes"][:3])).any())


@pytest.mark.gpu
def test_cold_kernel_with_cells_of_different_n_in_a_block(cuda):
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    cells = [_cell("sept", 2 + s % 3, 4, 4 if s % 2 else 16, s)
             for s in range(2 * n_sm + 8)]
    host, static, _ = _bucket(cells)
    _matches_plain(host, static, cuda, "cells of different n")


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,per_lane", [(4, 1), (8, 2), (16, 4),
                                            (32, 8)])
def test_cold_kernel_with_several_slots_a_lane(cuda, nodes, per_lane):
    cells = [_cell("fc", nodes, 8, 4, s, workload_cores=8 * nodes)
             for s in range(3)]
    host, static, _ = _bucket(cells)
    plan = _plan(host, static)
    assert plan["per_lane"] == per_lane and not plan["wide"]
    _matches_plain(host, static, cuda, f"{nodes} nodes x 8 slots")


@pytest.mark.gpu
def test_cold_kernel_on_the_wide_path(cuda):
    """16 nodes x 18 cores pad to 16 x 32 slots: the wide path, the free
    counts in the scratch."""
    cells = [_cell("fc", 16, 18, 6, s, workload_cores=16 * 18)
             for s in range(2)]
    host, static, key = _bucket(cells)
    assert _plan(host, static)["wide"]
    _matches_plain(host, static, cuda, "16 x 18 cold")


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_cold_kernel_with_evictions(cuda, wide):
    """Pools preset to cores + 1 free containers: every release finds its
    pool full and evicts, and no dispatch starts cold."""
    cells = ([_cell("fc", 16, 18, 6, s, workload_cores=16 * 18)
              for s in range(2)] if wide
             else [_cell("sept", 2, 4, 12, s) for s in range(3)])
    host, static, _ = _bucket(cells)
    assert _plan(host, static)["wide"] == wide
    got = _matches_plain(host, static, cuda, "full pools",
                         free0=cells[0].cores + 1)
    nc = len(cells)
    assert bool((got[4]["nevt"][:nc] > 0).all())
    assert int(got[4]["ncold"][:nc].sum()) == 0


@pytest.mark.gpu
def test_run_cells_scan_on_the_card_equals_the_cpu(cuda):
    cells = [_cell(p, intensity=v, seed=s, workload_cores=32)
             for p in ("fc", "sept") for v in (18, 40) for s in range(2)]
    ops.reset_launches()
    got = run_cells_scan(cells, metrics_only=True, device=cuda)
    assert ops.launches()["event_step_dyn"] == {"kernel": 4, "plain": 0}
    want = run_cells_scan(cells, metrics_only=True, device="cpu")
    assert got == want
    assert all(r["cold"] > 0 for r in got)
