"""The CUDA kernels of straggler hedging (the float64 frozen-priority
kernel's hedged instantiations: steal mode in ``csrc/event_step_hedge.cu``,
duplicate mode in ``csrc/event_step_dup.cu``) against their plain PyTorch
version, on the card.  A CUDA kernel has no CPU mode, so these tests carry
the ``gpu`` marker and skip where there is no card; run them on a card
with

    python -m pytest -q -m gpu tests/test_torch_hedge_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_hedge_scan.py`` holds the plain version to the JAX scan
on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish / prio / node
and the summary (backups, calls stolen or won by a copy, calls done, steps
taken, each row's attempts; with dynamics calls lost, nodes provisioned,
activation times, dead flags; with cold starts their counts and flags)
are ``torch.equal``.

Inputs: buckets filled from real bursts by the bucket runner: the
straggler grid's hedged push bucket (4 x 8 cores, home balancer, a 32-core
burst at intensity 18, node 0 2-8x slow), the steal matrix's cells (3 x 6
cores, least-loaded, node 0 5x slow; with a kill, the autoscaler, both or
neither; FC and SEPT), the dup matrix's push cells (intensities 16 and 45:
n_b 512 and 1,024, 4 copies a call, staged and on the wide path), cold
starts with node speeds, one node (the self-steal), 4 x 24 cores (the wide
path), cells of different n in one block, a full bucket (253 calls in 256
rows) in one launch at the strict step budget; then ``run_cells_scan`` on
the card against the CPU.
"""

import pytest
import torch

from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.sweep import (
    SweepCell,
    _cell_dynamics,
    _cell_hedging,
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


DEG5 = ((0, 1.0, 300.0, 5.0),)


def _cell(policy="fc", nodes=3, cores=6, intensity=16, seed=0, **kw):
    kw.setdefault("assignment", "push")
    kw.setdefault("hedge_multiple", 2.0)
    kw.setdefault("degrade", DEG5)
    return SweepCell(policy=policy, nodes=nodes, cores=cores,
                     intensity=intensity, seed=seed, **kw)


def _prepared(c):
    reqs = make_workload(c)
    return tfp._ScanCell(
        requests=reqs, feats=tfp._arrival_features(reqs), cores=c.cores,
        nodes=c.nodes, policy=c.policy, assignment=c.assignment, lb=c.lb,
        warm=c.warm, dynamics=_cell_dynamics(c), profile=_cell_profile(c),
        hedging=_cell_hedging(c))


def _bucket(cells):
    """A filled hedged bucket of ``cells`` under the widest key of its
    cells, its static arguments (at the strict step budget, so that every
    call finishes) and key."""
    prepared = [_prepared(c) for c in cells]
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    static = tfp._bucket_static(key, prepared)
    assert static["freeze"] and static["hedge"]
    return tfp._fill_bucket(key, prepared), static, key


def _plan(host, static):
    return ops.event_step_plan(
        n1=host["t"].shape[1], n_nodes=static["n_nodes"],
        n_slots=static["n_slots"], n_fns=host["ring0"].shape[2],
        window=static["window"], freeze=True, f64=True,
        fc_push=static["fc_push"], fc_ring=static["fc_ring"],
        dyn=static["dyn"], cold=static["cold"], hedge=True,
        dup=static["dup"], n_copies=static["n_copies"])


_SEG = ("freeze", "fc_push", "fc_ring", "dyn", "het", "cold", "hedge", "dup",
        "n_copies")


def _matches_plain(host, static, cuda, what):
    """Kernel against the plain version on one bucket: rows, summaries and
    step counts."""
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"],
                           **{k: static[k] for k in _SEG})
    assert clk.dtype == torch.float64
    n = inp["t"].shape[1] - 1
    k0, r0 = ops.HEDGE_LAUNCHES, ops.HEDGE_REF_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert (ops.HEDGE_LAUNCHES, ops.HEDGE_REF_LAUNCHES) == (k0 + 1, r0 + 1)
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    assert ref[4].keys() == got[4].keys()
    for k in ref[4]:
        assert torch.equal(ref[4][k], got[4][k]), f"{k} diverged ({what})"
    real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
    assert bool((got[1][:, :n][real] > 0).all()), what
    nreal = real.sum(1)
    assert torch.equal(got[4]["ndone"].long(), nreal), what
    # one step an event: at least the arrivals and completions
    assert bool((got[4]["stepc"].long() >= 2 * nreal).all()), what
    return got


@pytest.mark.gpu
def test_kernel_on_the_straggler_grid_hedged_bucket(cuda):
    cells = [_cell("fc", 4, 8, 18, s, lb="home", workload_cores=32,
                   degrade=((0, 2.0, 300.0, sev),), hedge_multiple=3.0)
             for sev in (2.0, 8.0) for s in range(2)]
    host, static, key = _bucket(cells)
    assert key[1] == 1024 and static["fc_push"] and not static["dyn"]
    got = _matches_plain(host, static, cuda, "straggler hedged push")
    assert bool((got[4]["nbk"][:4] > 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fc", "sept"])
@pytest.mark.parametrize("kill,autoscale", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_kernel_on_the_steal_matrix(cuda, policy, kill, autoscale):
    kw = dict(fail_spec=((0, 8.0),)) if kill else {}
    if autoscale:
        kw.update(autoscale=True, scale_up=1.0, provision_delay=2.0,
                  max_nodes=5)
    cells = [_cell(policy, intensity=v, seed=s, **kw)
             for v in (16, 25) for s in range(2)]
    host, static, key = _bucket(cells)
    assert static["dyn"] == (kill or autoscale)
    got = _matches_plain(host, static, cuda, f"steal {policy} {kw}")
    if kill:
        # more calls lost than a node's slots: queued ones too
        assert bool((got[4]["nfail"][:4] > 6).any())


@pytest.mark.gpu
@pytest.mark.parametrize("cores,wcores,intensities,wide",
                         [(6, 18, (16, 45), False), (24, 72, (6, 12), True)])
def test_kernel_on_the_dup_plan_by_shape(cuda, cores, wcores, intensities,
                                         wide):
    """Duplicate racing at n_b 512 and 1,024, 4 copies a call: the dup
    matrix's push cells (3 x 6 cores, intensities 16 and 45), their queue
    entries staged in shared memory; and 3 x 24 cores under a burst for
    72 (the wide path), in the scratch."""
    for v, n_b in zip(intensities, (512, 1024)):
        cells = [_cell("fc", 3, cores, v, s, workload_cores=wcores,
                       hedge_mode="duplicate") for s in range(2)]
        host, static, key = _bucket(cells)
        assert static["dup"] and static["n_copies"] == 4 and key[1] == n_b
        plan = _plan(host, static)
        assert (plan["wide"], plan["staged"]) == (wide, not wide)
        got = _matches_plain(host, static, cuda, f"dup v{v} c{cores}")
        assert bool((got[4]["nbk"][:2] > 0).all())


@pytest.mark.gpu
def test_kernel_on_cold_starts_with_speeds(cuda):
    cells = [_cell("fc", 4, 8, 18, s, workload_cores=32, warm=False,
                   degrade=((0, 2.0, 300.0, 8.0),), node_speeds=(1.0, 0.7))
             for s in range(2)]
    host, static, key = _bucket(cells)
    assert static["cold"] and static["het"]
    got = _matches_plain(host, static, cuda, "cold het hedge")
    assert bool((got[4]["ncold"][:2] > 0).all())


@pytest.mark.gpu
def test_kernel_on_one_node(cuda):
    """One node: a steal goes back to the node itself."""
    cells = [_cell("fc", 1, 4, 5, s, degrade=((0, 2.0, 300.0, 4.0),),
                   hedge_multiple=3.0) for s in range(4)]
    host, static, key = _bucket(cells)
    assert key[2] == 1
    got = _matches_plain(host, static, cuda, "self-steal")
    assert bool((got[4]["nbk"][:4] > 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dup", [False, True])
def test_kernel_on_the_wide_path(cuda, dup):
    cells = [_cell("sept", 4, 24, 10, s, hedge_mode="duplicate" if dup
                   else "steal") for s in range(2)]
    host, static, key = _bucket(cells)
    assert _plan(host, static)["wide"]
    _matches_plain(host, static, cuda, f"wide dup={dup}")


@pytest.mark.gpu
def test_kernel_on_cells_of_different_n(cuda):
    """Cells of 4 to 319 calls in one block (several cells a block)."""
    cells = [_cell("fc", 3, 6, v, s) for v, s in ((16, 0), (2, 1), (8, 2),
                                                  (12, 3), (1, 4))]
    host, static, key = _bucket(cells)
    assert len({int((host["t"][b] < float("inf")).sum())
                for b in range(5)}) == 5
    _matches_plain(host, static, cuda, "mixed n")


@pytest.mark.gpu
def test_a_full_bucket_scans_in_one_launch_on_the_card(cuda):
    """253 calls in 256 rows with backups: one launch at the strict step
    budget finishes every call, with the CPU's rows."""
    c = _prepared(_cell("fc", 3, 4, 10, 0, workload_cores=23))
    assert len(c.feats.t) == 253
    key = c.bucket()
    k0 = ops.HEDGE_LAUNCHES
    got = tfp._run_scan_bucket(key, [c], cuda)[0]
    assert ops.HEDGE_LAUNCHES == k0 + 1
    want = tfp._run_scan_bucket(key, [c], torch.device("cpu"))[0]
    n = len(c.feats.t)
    for a, b in zip(want[:4], got[:4]):
        assert (a[:n] == b[:n]).all()
    assert (want[4]["backups"], want[4]["steals"]) == \
        (got[4]["backups"], got[4]["steals"]) and got[4]["backups"] > 10


@pytest.mark.gpu
def test_run_cells_scan_on_the_card_equals_the_cpu(cuda):
    cells = [_cell("fc", 3, 6, 16, 0, fail_spec=((0, 8.0),)),
             _cell("sept", 3, 6, 16, 1, hedge_mode="duplicate"),
             _cell("fc", 4, 8, 18, 0, lb="home", workload_cores=32,
                   degrade=((0, 2.0, 300.0, 8.0),), hedge_multiple=3.0),
             _cell("fc", 3, 6, 16, 0, assignment="pull",
                   hedge_mode="duplicate", fail_spec=((0, 8.0),))]
    ops.reset_launches()
    got = run_cells_scan(cells, metrics_only=True, device=cuda)
    counts = ops.launches()
    assert counts["event_step_hedge"]["kernel"] == 3
    assert not any(v["plain"] for v in counts.values())
    assert run_cells_scan(cells, metrics_only=True, device="cpu") == got
    assert [r["backups"] > 0 for r in got] == [True, True, True, False]
