"""The CUDA kernel of request resilience (the float64 frozen-priority
kernel's ``RES`` instantiations, ``csrc/event_step_res.cu``: timeouts,
retries with backoff, admission shedding) against its plain PyTorch
version, on the card.  A CUDA kernel has no CPU mode, so these tests carry
the ``gpu`` marker and skip where there is no card; run them on a card
with

    python -m pytest -q -m gpu tests/test_torch_res_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_res_scan.py`` holds the plain version to the JAX scan
on the CPU).  Tolerance: 0 -- rows ``[:n]`` of start / finish / prio / node
and the summary (timeouts, sheds, retries, wasted seconds, calls
resolved, steps taken, each row's failure flag, cause and submissions) are
``torch.equal``.

Inputs: buckets filled from real bursts by the bucket runner: the
retry-storm benchmark's cells (a ramp burst for 8 cores at intensity 14,
6x over [T/3, T/2), on 2 x 4 push least-loaded SEPT, the six client
behaviours, 2 seeds), FC with backoff retries and shedding at intensity
40, the home balancer with immediate retries, an absolute timeout, one
node, 3 x 24 cores (the wide path), cells of different n and different
policies in one block; the existing float64 sets (without hedging, steal,
duplicate) on one bucket each; then ``run_cells_scan`` on the card against
the CPU.
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.sweep import (
    SweepCell,
    _cell_dynamics,
    _cell_hedging,
    _cell_profile,
    _cell_resilience,
    _cluster_shaped,
    make_workload,
    run_cells_scan,
)
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _cell(policy="sept", nodes=2, cores=4, intensity=30, seed=0, **kw):
    kw.setdefault("assignment", "push")
    return SweepCell(policy=policy, nodes=nodes, cores=cores,
                     intensity=intensity, seed=seed, **kw)


def _prepared(c):
    reqs = make_workload(c)
    return tfp._ScanCell(
        requests=reqs, feats=tfp._arrival_features(reqs), cores=c.cores,
        nodes=c.nodes, policy=c.policy,
        assignment=c.assignment if _cluster_shaped(c) else "single",
        lb=c.lb, warm=c.warm, dynamics=_cell_dynamics(c),
        profile=_cell_profile(c), hedging=_cell_hedging(c),
        resilience=_cell_resilience(c))


def _bucket(prepared):
    """A filled bucket of prepared cells under the widest key of its cells,
    its static arguments (at the strict step budget) and key."""
    keys = {c.bucket() for c in prepared}
    if len({k[0] for k in keys}) != 1:
        raise AssertionError(f"cells of several feature sets: {keys}")
    key = tuple(max(col) for col in zip(*keys))
    return (tfp._fill_bucket(key, prepared),
            tfp._bucket_static(key, prepared), key)


def _plan(host, static):
    return ops.event_step_plan(
        n1=host["t"].shape[1], n_nodes=static["n_nodes"],
        n_slots=static["n_slots"], n_fns=host["ring0"].shape[2],
        window=static["window"], freeze=True, f64=True,
        fc_push=static["fc_push"], fc_ring=static["fc_ring"],
        dyn=static["dyn"], cold=static["cold"], hedge=static["hedge"],
        dup=static["dup"], n_copies=static["n_copies"], res=static["res"])


_SEG = ("freeze", "fc_push", "fc_ring", "dyn", "het", "cold", "hedge", "dup",
        "n_copies", "res")
# each float64 set's launch counter
_COUNTER = {"res": "RES_LAUNCHES", "hedge": "HEDGE_LAUNCHES",
            "f64": "FREEZE64_LAUNCHES"}


def _matches_plain(host, static, cuda, what):
    """Kernel against the plain version on one bucket: rows and the whole
    summary, the step counts included."""
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"],
                           **{k: static[k] for k in _SEG})
    assert clk.dtype == torch.float64
    n = inp["t"].shape[1] - 1
    counter = _COUNTER["res" if static["res"] else
                       "hedge" if static["hedge"] else "f64"]
    k0 = getattr(ops, counter)
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert getattr(ops, counter) == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), f"{name} diverged ({what})"
    assert ref[4].keys() == got[4].keys()
    for k in ref[4]:
        assert torch.equal(ref[4][k], got[4][k]), f"{k} diverged ({what})"
    if static["res"]:
        real = torch.isfinite(inp["t"][:, :n]) & (inp["cores"][:, None] > 0)
        nreal = real.sum(1)
        # every call resolved: done or failed for good; one step an event:
        # each arrival, completion, timeout and retry re-arrival
        assert torch.equal(got[4]["ndn"].long(), nreal), what
        done = nreal - got[4]["nfl"][:, :n].sum(1)
        assert torch.equal(got[4]["stepc"].long(),
                           nreal + done + got[4]["nto"].long()
                           + got[4]["nrt"].long()), what
    return got


@pytest.mark.gpu
def test_kernel_on_the_storm(cuda):
    """The storm's 12 cells (6 client behaviours, 2 seeds; built as
    ``chip_smoke.py`` builds them), n_b 256: each behaviour with its
    timeouts, sheds and retries."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    host, static, key = _bucket(chip_smoke.storm_prepared(range(2)))
    assert key[1] == 256 and static["res"] and not static["fc_push"]
    got = _matches_plain(host, static, cuda, "storm")
    nto, nsh, nrt = (got[4][k][:12].cpu() for k in ("nto", "nsh", "nrt"))
    assert bool((nto > 0).all())
    for i, (name, mode, shed, _) in enumerate(
            chip_smoke.storm_items(range(2))[0]):
        assert (nsh[i] > 0) == shed, name
        assert (nrt[i] > 0) == (mode is not None), name


@pytest.mark.gpu
def test_kernel_on_fc_with_backoff_and_shedding(cuda):
    """FC (the push FC rings, at 3 times their size) with backoff retries
    and shedding at 2.0, at intensity 40."""
    cells = [_prepared(_cell("fc", 2, 4, 40, s, timeout_multiple=3.0,
                             timeout_floor_s=2.0, retry_attempts=3,
                             shed_threshold=2.0)) for s in range(4)]
    host, static, key = _bucket(cells)
    assert static["fc_push"]
    got = _matches_plain(host, static, cuda, "fc backoff shed")
    assert bool((got[4]["nsh"][:4] > 0).all())
    assert bool((got[4]["nrt"][:4] > 0).all())


@pytest.mark.gpu
def test_kernel_on_the_home_balancer_with_immediate_retries(cuda):
    cells = [_prepared(_cell(p, 3, 4, 30, s, lb="home", timeout_multiple=2.0,
                             timeout_floor_s=1.0, retry_attempts=3,
                             retry_mode="immediate"))
             for p in ("sept", "fifo") for s in range(2)]
    host, static, key = _bucket(cells)
    assert (host["route"][:4] == 1).all()
    got = _matches_plain(host, static, cuda, "home immediate")
    assert bool((got[4]["nrt"][:4] > 0).all())


@pytest.mark.gpu
def test_kernel_on_an_absolute_timeout(cuda):
    """A 0.5 s absolute timeout without retries: calls time out queued and
    running, and fail."""
    cells = [_prepared(_cell("sept", 2, 4, 30, s, timeout_multiple=3.0,
                             timeout_absolute_s=0.5)) for s in range(2)]
    host, static, key = _bucket(cells)
    assert (host["rto_p"][:2, 3] == 0.5).all()
    got = _matches_plain(host, static, cuda, "absolute timeout")
    assert bool((got[4]["nto"][:2] > 0).all())
    assert bool((got[4]["wst"][:2] > 0).all())
    assert bool(got[4]["nfl"][:2].any())


@pytest.mark.gpu
def test_kernel_on_one_node(cuda):
    cells = [_prepared(_cell("fc", 1, 4, 30, s, timeout_multiple=2.0,
                             retry_attempts=2, shed_threshold=1.0))
             for s in range(4)]
    host, static, key = _bucket(cells)
    assert key[2] == 1 and static["fc_push"]
    got = _matches_plain(host, static, cuda, "one node")
    assert bool((got[4]["nto"][:4] > 0).all())


@pytest.mark.gpu
def test_kernel_on_the_wide_path(cuda):
    """3 x 24 cores (72 slots, more than the 64 of the staged path)."""
    cells = [_prepared(_cell("sept", 3, 24, 16, s, workload_cores=36,
                             timeout_multiple=2.0, timeout_floor_s=1.0,
                             retry_attempts=3, shed_threshold=2.0))
             for s in range(2)]
    host, static, key = _bucket(cells)
    assert _plan(host, static)["wide"]
    got = _matches_plain(host, static, cuda, "wide")
    assert bool((got[4]["nto"][:2] > 0).all())


@pytest.mark.gpu
def test_kernel_on_cells_of_different_n_and_specs(cuda):
    """Cells of different sizes, policies and lifecycle policies in one
    block (several cells a block)."""
    cells = [_prepared(_cell("sept", 2, 4, v, s, **kw)) for v, s, kw in (
        (30, 0, dict(timeout_multiple=3.0, retry_attempts=4)),
        (4, 1, dict(shed_threshold=0.5)),
        (20, 2, dict(timeout_multiple=2.0, retry_attempts=2,
                     retry_mode="immediate", shed_threshold=2.0)),
        (1, 3, dict(timeout_multiple=1.0, timeout_floor_s=0.1)),
        (12, 4, dict(retry_attempts=3)))]
    host, static, key = _bucket(cells)
    assert len({int((host["t"][b] < float("inf")).sum())
                for b in range(5)}) == 5
    _matches_plain(host, static, cuda, "mixed n and specs")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f64", "steal", "dup"])
def test_existing_float64_sets_still_match(cuda, kind):
    """One bucket of each set the RES parameter must leave as it was: cold
    starts on push, steal and duplicate hedging."""
    deg = ((0, 1.0, 300.0, 5.0),)
    kw = {"f64": dict(warm=False, workload_cores=32),
          "steal": dict(degrade=deg, hedge_multiple=2.0),
          "dup": dict(degrade=deg, hedge_multiple=2.0,
                      hedge_mode="duplicate")}[kind]
    cells = [_prepared(_cell("fc", 3, 6, 16, s, **kw)) for s in range(2)]
    host, static, key = _bucket(cells)
    assert not static["res"]
    _matches_plain(host, static, cuda, kind)


@pytest.mark.gpu
def test_run_cells_scan_on_the_card_equals_the_cpu(cuda):
    cells = [_cell("sept", 2, 4, 30, 0, timeout_multiple=3.0,
                   timeout_floor_s=2.0, retry_attempts=3, shed_threshold=2.0),
             _cell("fc", 2, 4, 30, 0, timeout_multiple=3.0,
                   retry_attempts=3, retry_mode="immediate"),
             _cell("fc", 2, 4, 30, 0),
             _cell("sept", 2, 4, 30, 0, timeout_multiple=3.0,
                   timeout_absolute_s=0.01)]
    ops.reset_launches()
    got = run_cells_scan(cells, metrics_only=True, device=cuda)
    counts = ops.launches()
    assert counts["event_step_res"]["kernel"] >= 1
    assert not any(v["plain"] for v in counts.values())
    assert run_cells_scan(cells, metrics_only=True, device="cpu") == got
    assert got[0]["timed_out"] > 0 and "timed_out" not in got[2]
    # the absolute 10 ms timeout fails every call: the all-failed row
    assert got[3]["n"] == 0.0 and got[3]["n_failed"] > 0
