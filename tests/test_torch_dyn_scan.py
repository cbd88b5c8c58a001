"""The port's float64 pull scan (capacity dynamics and node speeds) against
the JAX package, on the CPU.

The JAX package scans ``dyn`` / ``het`` buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0 unless a line says otherwise):

* the ``dyn`` carry planes have the JAX package's layout and bytes, in
  float64;
* the plain ``event_step`` with ``dyn`` / ``het`` (``repro_torch.kernels.
  ops`` on CPU tensors) gives rows ``[:n]`` of start, finish, prio and node
  and the summary (calls lost and done, nodes provisioned, activation
  times, dead flags) bit-identical to the JAX oracle
  (``_scan_cell_kernel``'s float64 branch, its step records resolved last
  dispatch first as its bucket runner does) on buckets filled from real
  bursts: pull failures under the five policies, the autoscaler, both
  together, two kills of one node, a kill after the drain, a kill time
  float32 cannot hold, static speeds, degradation episodes (and two
  overlapping on one node, built by hand), speeds with failures;
* the bucket keys equal the JAX package's; ``run_cells_scan`` rows, with
  ``metrics_only`` and written back, equal the JAX package's on cuts of the
  autoscaler frontier, the straggler grid's pull half and the dup matrix's
  pull half, and ``chip_smoke.py``'s grids are the JAX package's;
* against the reference ``Cluster`` (no scan, no alias): the
  ``CROSS_CHECK_EXACT`` counters equal, the ``CROSS_CHECK_KEYS`` within
  ``CLUSTER_XCHECK_RTOL``;
* ``cluster_scan_eligible`` answers as the JAX package's; push cells with
  dynamics run and equal the JAX package's results (with the home
  balancer they are refused, as there); a step budget cut short raises.

The CUDA kernel is held against the plain version in
``tests/test_torch_dyn_gpu.py``, on the card.
"""

import dataclasses
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core import fastpath as jfp
from repro.core import stragglers as jstrag
from repro.core import sweep as jsweep
from repro.kernels import ops as jops
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import stragglers as tstrag
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.engine_bench import (  # noqa: E402
    frontier_spec,
    matrix_specs,
    straggler_spec,
)

POLICIES = ("fifo", "sept", "eect", "rect", "fc")


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _port_cell(jcell) -> tsweep.SweepCell:
    """The port's cell of a JAX package cell (the port's fields)."""
    return tsweep.SweepCell(**{f.name: getattr(jcell, f.name)
                               for f in dataclasses.fields(tsweep.SweepCell)})


def _scan_cells(cell: tsweep.SweepCell):
    """The port's and the JAX package's prepared cell of one sweep cell,
    on bursts made alike."""
    out = []
    for fp, sw in ((tfp, tsweep), (jfp, jsweep)):
        reqs = sw.make_workload(cell)
        jc = jsweep.SweepCell(**dataclasses.asdict(cell))
        out.append(fp._ScanCell(
            requests=reqs, feats=fp._arrival_features(reqs),
            cores=cell.cores, nodes=cell.nodes, policy=cell.policy,
            assignment="pull", dynamics=jsweep._cell_dynamics(jc)
            if fp is jfp else tsweep._cell_dynamics(cell),
            profile=jsweep._cell_profile(jc) if fp is jfp
            else tsweep._cell_profile(cell)))
    return out


def _bucket(cells):
    """Port bucket of ``cells`` (SweepCells), under the widest key; its
    host inputs, static arguments and key, the key checked against the
    JAX package's."""
    pairs = [_scan_cells(c) for c in cells]
    for t, j in pairs:
        assert t.bucket() == j.bucket()
    keys = {t.bucket() for t, _ in pairs}
    assert len({k[0] for k in keys}) == 1
    key = tuple(max(col) for col in zip(*keys))
    return tfp._fill_bucket(key, [t for t, _ in pairs]), \
        tfp._scan_static(key), key


def _jax_scan(host, static, key):
    """The JAX oracle on the port's numpy bucket in float64: (clk, ctr),
    rows (start, finish, prio, node) resolved last dispatch first, and the
    summary."""
    inp = dict(host)
    B, n1 = host["t"].shape
    # the oracle reads the frozen-priority inputs too (unused on pull)
    inp.update(cnt=np.zeros((B, n1)), home0=np.zeros((B, n1), np.int32),
               route=np.zeros(B, np.int32))
    st = {k: static[k] for k in ("n_nodes", "n_slots", "window",
                                 "freeze", "fc_push", "dyn", "het",
                                 "hedge", "cold", "dup", "fc_ring")}
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in inp.items()}
        clk, ctr = jax.vmap(partial(jfp._make_planes, n_copies=1,
                                    **st))(arrs)
        out = jops.event_step(clk, ctr, arrs, force="ref", n_copies=1,
                              n_ep=key[8], use_fc=static["use_fc"],
                              horizon=static["horizon"],
                              n_steps=static["n_steps"], **st)
        out = jax.tree_util.tree_map(np.asarray, out)
    if not static["dyn"]:
        return (np.asarray(clk), np.asarray(ctr), list(out[:4]), {})
    (j_s, es_s, fs_s, pj_s, kd_s), summ = out
    rows = [np.zeros((B, n1)), np.zeros((B, n1)), np.zeros((B, n1)),
            np.zeros((B, n1), dtype=np.int32)]
    for b in range(B):
        for r, v in zip(rows, (es_s, fs_s, pj_s, kd_s)):
            r[b, j_s[b]] = v[b]
    return np.asarray(clk), np.asarray(ctr), rows, summ


def _torch_scan(host, clk, ctr, static):
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    r0 = tops.DYN_REF_LAUNCHES
    out = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)), tens, **static)
    assert tops.DYN_REF_LAUNCHES == r0 + 1
    return [o.numpy() for o in out[:4]], {k: v.numpy()
                                          for k, v in out[4].items()}


def _burst_cell(policy="fc", nodes=2, cores=6, intensity=15, seed=0,
                wcores=None, **kw):
    return tsweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed,
                            workload_cores=wcores, **kw)


# (name, cells): each a bucket of real-burst cells, padded with one idle cell
CASES = [
    *[(f"fail-{p}", [_burst_cell(p, 2, 6, 15, s, fail_at=10.0)
                     for s in range(3)]) for p in POLICIES],
    ("autoscale", [_burst_cell("fc", 1, 8, 40, s, autoscale=True,
                               provision_delay=15.0, scale_up=2.0,
                               max_nodes=6) for s in range(3)]),
    ("autoscale+fail", [_burst_cell("sept", 2, 8, 25, s, wcores=16,
                                    autoscale=True, provision_delay=12.0,
                                    scale_up=2.0, max_nodes=5, fail_at=20.0)
                        for s in range(3)]),
    ("two-kills-one-node", [_burst_cell("fc", 3, 6, 12, s,
                                        fail_spec=((0, 20.0), (0, 5.0)))
                            for s in range(3)]),
    ("kill-after-drain", [_burst_cell("fc", 2, 6, 15, s, fail_at=1e6)
                          for s in range(3)]),
    ("kill-not-float32", [_burst_cell("fc", 2, 6, 15, s, fail_at=7.3)
                          for s in range(3)]),
    ("speeds", [_burst_cell(p, 2, 4, 12, s, node_speeds=(1.0, 0.25))
                for s, p in enumerate(("sept", "rect", "fifo"))]),
    ("speeds-fc", [_burst_cell("fc", 2, 4, 12, s, node_speeds=(1.0, 0.3))
                   for s in range(3)]),
    ("episodes-not-powers-of-two", [
        _burst_cell(p, 3, 4, 12, s, node_speeds=(0.7, 1.0, 1.3),
                    degrade=((0, 1.0, 300.0, 5.0), (1, 10.0, 50.0, 6.0),
                             (2, 0.0, 30.0, 3.0)))
        for s, p in enumerate(("sept", "rect", "fifo"))]),
    ("episodes", [_burst_cell(p, 2, 4, 12, s,
                              degrade=((0, 5.0, 40.0, 4.0),
                                       (1, 20.0, 60.0, 2.0)))
                  for s, p in enumerate(("sept", "eect", "rect"))]),
    ("speeds+fail", [_burst_cell(p, 3, 4, 16, s, node_speeds=(0.2, 1.0),
                                 fail_spec=((1, 6.0),))
                     for s, p in enumerate(("sept", "fifo", "rect"))]),
    *[(f"episodes+autoscale+fail-{pp[0]}", [
        _burst_cell(p, 3, 6, 16, s, wcores=18, degrade=((0, 1.0, 300.0, 5.0),),
                    fail_spec=((0, 8.0),), autoscale=True,
                    provision_delay=5.0, scale_up=1.0, max_nodes=5)
        for s, p in enumerate(pp)])
      for pp in (("fc", "fc", "fc"), ("sept", "eect", "fifo"))],
]


@pytest.mark.parametrize("name,cells", CASES, ids=[c[0] for c in CASES])
def test_plain_scan_bit_identical_to_jax(name, cells):
    host, static, key = _bucket(cells)
    assert host["t"].dtype == np.float64
    clk, ctr, ref, summ = _jax_scan(host, static, key)
    assert clk.dtype == np.float64
    got, aux = _torch_scan(host, clk, ctr, static)
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{what} diverged ({name})")
    if static["dyn"]:
        for k in ("nfail", "ndone", "prov", "act_t", "dead"):
            np.testing.assert_array_equal(np.asarray(summ[k]), aux[k],
                                          err_msg=f"{k} diverged ({name})")
        assert (aux["ndone"][:len(cells)] == host["nreq"][:len(cells)]).all()
    if name.startswith("fail-") or name == "speeds+fail":
        assert aux["nfail"][:len(cells)].sum() > 0
    if name == "kill-after-drain":
        assert aux["nfail"].sum() == 0
    if name.startswith("autoscale"):
        assert (aux["prov"][:len(cells)] > host["nodes"][:len(cells)]).any()
    if name == "kill-not-float32":
        assert host["killt"][0, 0] == 7.3 != float(np.float32(7.3))


def test_overlapping_episodes_bit_identical_to_jax():
    """Two episodes of one node overlap (the profile class refuses it, so
    the bucket is changed by hand): the slowdown is their product."""
    cells = [_burst_cell(p, 2, 4, 12, s, degrade=((0, 5.0, 40.0, 4.0),
                                                   (1, 20.0, 60.0, 2.0)))
             for s, p in enumerate(("sept", "eect", "fifo"))]
    host, static, key = _bucket(cells)
    host["epn"][:, 1] = 0
    host["epf"][:, 1] = 3.0
    clk, ctr, ref, _ = _jax_scan(host, static, key)
    got, _ = _torch_scan(host, clk, ctr, static)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a[:, :key[1]], b[:, :key[1]])


@pytest.mark.parametrize("name,cells", [CASES[0], CASES[6], CASES[-1]],
                         ids=["fail", "two-kills", "het+dyn"])
def test_dyn_planes_equal_jax(name, cells):
    host, static, key = _bucket(cells)
    jclk, jctr, _, _ = _jax_scan(host, dict(static, n_steps=0), key)
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    clk, ctr = planes.make_planes(tens, n_nodes=static["n_nodes"],
                                  n_slots=static["n_slots"],
                                  window=static["window"], dyn=static["dyn"])
    assert clk.dtype == torch.float64 and ctr.dtype == torch.int32
    np.testing.assert_array_equal(clk.numpy(), jclk)
    np.testing.assert_array_equal(ctr.numpy(), jctr)
    assert clk.numpy().tobytes() == jclk.tobytes()
    with jax.enable_x64():
        jl = jfp._carry_layout(
            {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
             for k, v in dict(host, cnt=host["t"],
                              home0=host["fnid"], route=host["cores"]
                              ).items()},
            n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            window=static["window"], freeze=False, fc_push=False, dyn=True,
            het=static["het"], hedge=False, cold=False, dup=False,
            n_copies=1, fc_ring=1)
    tl = planes.carry_layout(n_nodes=static["n_nodes"],
                             n_slots=static["n_slots"],
                             window=static["window"],
                             n_fns=host["ring0"].shape[2],
                             n1=host["t"].shape[1], dyn=True)
    assert tl.fparts == jl.fparts and tl.iparts == jl.iparts


# -- sweep rows ---------------------------------------------------------------
def _grid_cuts():
    fr = dataclasses.replace(frontier_spec(quick=True), seeds=1,
                             intensities=(15,))
    st = [c for c in dataclasses.replace(straggler_spec(quick=True),
                                         seeds=1).cells()
          if c.assignment == "pull"]
    dup = dict(matrix_specs(quick=True))["dup"]
    # the pull half keeps its hedging, a no-op under pull (no backups)
    du = [c for c in dup.cells() if c.assignment == "pull"]
    return {"frontier": fr.cells(), "straggler-pull": st, "dup-pull": du}


@pytest.mark.parametrize("grid", ["frontier", "straggler-pull", "dup-pull"])
@pytest.mark.parametrize("metrics_only", [True, False])
def test_run_cells_scan_rows_equal_jax(grid, metrics_only):
    jcells = _grid_cuts()[grid]
    assert jcells and all(c.assignment == "pull" for c in jcells)
    want = jsweep.run_cells_scan(jcells, metrics_only=metrics_only)
    r0 = tops.DYN_REF_LAUNCHES
    got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                metrics_only=metrics_only, device="cpu")
    assert tops.DYN_REF_LAUNCHES > r0
    for c, w, g in zip(jcells, want, got):
        assert set(w) == set(g), c.label()
        assert w == g, (c.label(), {k: (w[k], g[k]) for k in w
                                    if w[k] != g[k]})
    if grid == "dup-pull":
        assert any(r["failures"] > 0 for r in got)
    if grid == "frontier":
        assert any(r["nodes_used"] > c.nodes for c, r in zip(jcells, got))


def test_write_back_equals_jax():
    """Written-back requests, failures, nodes used and the capacity
    timeline equal the JAX package's for an autoscaled, failing,
    degraded cell."""
    cell = _burst_cell("fc", 3, 6, 16, 0, wcores=18,
                       degrade=((0, 1.0, 300.0, 5.0),), fail_spec=((0, 8.0),),
                       autoscale=True, provision_delay=5.0, scale_up=1.0,
                       max_nodes=5)
    jc = jsweep.SweepCell(**dataclasses.asdict(cell))
    jr, tr = jsweep.make_workload(jc), tsweep.make_workload(cell)
    want = jfp.simulate_cluster_scan(
        jr, 3, 6, "fc", dynamics=jsweep._cell_dynamics(jc),
        profile=jsweep._cell_profile(jc))
    got = tfp.simulate_cluster_scan(
        tr, 3, 6, "fc", dynamics=tsweep._cell_dynamics(cell),
        profile=tsweep._cell_profile(cell), device="cpu")
    assert got.failures == want.failures > 0
    assert got.nodes_used == want.nodes_used > 3
    assert got.timeline.activate == want.timeline.activate
    assert got.timeline.deactivate == want.timeline.deactivate
    for a, b in zip(jr, tr):
        assert (a.start, a.finish, a.c, a.priority, a.node, a.r_prime) == \
            (b.start, b.finish, b.c, b.priority, b.node, b.r_prime)


def _ref_label(jcell) -> str:
    """A JAX package cell's label without its backend part (the port's
    cells have no backend field)."""
    return dataclasses.replace(jcell, backend="reference").label()


def test_spec_cells_equal_jax():
    """The port's SweepSpec yields the JAX package's cells, labels and
    order over the dynamics and speed axes; ``chip_smoke.py``'s grids are
    the JAX package's frontier grid, its 40-seed cut, and the straggler
    grid's pull half."""
    import chip_smoke

    jspec = frontier_spec()
    got = chip_smoke.frontier_cells(jspec.seeds)
    want = jspec.cells()
    assert len(want) == 80 == len(got)
    assert [_port_cell(c) for c in want] == got
    assert [_ref_label(c) for c in want] == [c.label() for c in got]
    cut = chip_smoke.frontier_cells(40)
    assert len(cut) == 640
    assert [_port_cell(c) for c in dataclasses.replace(jspec, seeds=40)
            .cells()] == cut
    st = [c for c in straggler_spec().cells() if c.assignment == "pull"]
    mine = chip_smoke.straggler_pull_cells()
    assert len(st) == 75 == len(mine)
    assert [_port_cell(c) for c in st] == mine
    assert [_ref_label(c) for c in st] == [c.label() for c in mine]


# -- against the reference Cluster -------------------------------------------
@pytest.fixture
def no_alias(monkeypatch):
    monkeypatch.delattr(jax.experimental, "enable_x64", raising=False)


REF_CELLS = [
    _burst_cell("fc", 2, 6, 15, 0, fail_at=10.0),
    _burst_cell("sept", 2, 8, 25, 1, wcores=16, autoscale=True,
                provision_delay=12.0, scale_up=2.0, max_nodes=5,
                fail_at=20.0),
    _burst_cell("fc", 4, 4, 15, 0, fail_spec=((0, 8.0), (1, 16.0))),
    _burst_cell("sept", 2, 4, 12, 0, degrade=((0, 5.0, 40.0, 4.0),
                                              (1, 20.0, 60.0, 2.0))),
    _burst_cell("fc", 3, 6, 16, 0, wcores=18, degrade=((0, 1.0, 300.0, 5.0),),
                fail_spec=((0, 8.0),)),
]


@pytest.mark.parametrize("cell", REF_CELLS, ids=lambda c: c.label())
def test_counts_exact_and_metrics_close_to_the_reference(no_alias, cell):
    ref = jsweep.run_cell(dataclasses.replace(
        jsweep.SweepCell(**dataclasses.asdict(cell)), backend="reference"))
    got = tsweep.run_cells_scan([cell], device="cpu")[0]
    for k in jsweep.CROSS_CHECK_EXACT:
        if k in ref and k in got:
            assert got[k] == ref[k], k
    for k in jsweep.CROSS_CHECK_KEYS:
        if k in ref:
            assert abs(got[k] - ref[k]) <= jsweep.CLUSTER_XCHECK_RTOL * max(
                abs(ref[k]), abs(got[k]), 1e-9), (k, got[k], ref[k])
    assert got["nodes_used"] == ref["nodes_used"]


# -- eligibility, refusals, budget --------------------------------------------
def test_eligibility_answers_as_jax():
    reqs = tsweep.make_workload(_burst_cell("fc", 2, 6, 15, 0))
    jreqs = jsweep.make_workload(jsweep.SweepCell(
        policy="fc", nodes=2, cores=6, intensity=15))
    prof = (tstrag.NodeSpeedProfile(speeds=(0.5, 1.0)),
            jstrag.NodeSpeedProfile(speeds=(0.5, 1.0)))
    wide = (tstrag.NodeSpeedProfile(speeds=(1.0, 0.5)),
            jstrag.NodeSpeedProfile(speeds=(1.0, 0.5)))
    cases = [
        (2, 6, "fc", "pull", "least_loaded",
         dict(fail=((0, 5.0), (1, 6.0))), None),
        (2, 6, "sept", "push", "home", dict(fail=((0, 5.0),)), None),
        (2, 6, "sept", "push", "home", None, None),
        (2, 6, "fc", "pull", "least_loaded", dict(fail=((0, 5.0),)), None),
        (2, 6, "fc", "pull", "least_loaded", dict(fail=((2, 5.0),)), None),
        (3, 6, "fc", "pull", "least_loaded", dict(fail=((0, -1.0),)), None),
        (2, 4, "fc", "pull", "least_loaded", dict(autoscale=True), prof),
        (2, 4, "fc", "push", "least_loaded", dict(autoscale=True), prof),
        (1, 4, "fc", "pull", "least_loaded", None, wide),
        (1, 4, "fc", "pull", "least_loaded", dict(autoscale=True,
                                                  max_nodes=3), wide),
    ]
    for nodes, cores, pol, asg, lb, dyn, pr in cases:
        td = ClusterDynamics(**dyn) if dyn else None
        jd = jcluster.ClusterDynamics(**dyn) if dyn else None
        a = tfp.cluster_scan_eligible(reqs, nodes, cores, pol,
                                      assignment=asg, lb=lb, dynamics=td,
                                      profile=pr and pr[0])
        b = jfp.cluster_scan_eligible(jreqs, nodes, cores, pol,
                                      assignment=asg, lb=lb, dynamics=jd,
                                      profile=pr and pr[1])
        assert a == b, (nodes, cores, pol, asg, lb, dyn)


def test_push_dynamics_raise_not_implemented():
    """Push cells with capacity dynamics, which raised before the float64
    frozen-priority scan, now run and equal the JAX package's results
    (``tests/test_torch_freeze64_scan.py`` holds them bit for bit); with
    the home balancer they stay outside the scan, as in the JAX package."""
    c = _burst_cell("fc", 2, 6, 15, 0)
    jc = jsweep.SweepCell(**dataclasses.asdict(c))
    reqs, jreqs = tsweep.make_workload(c), jsweep.make_workload(jc)
    got = tfp.simulate_cluster_scan(
        reqs, 2, 6, "fc", assignment="push",
        dynamics=ClusterDynamics(fail=((0, 5.0),)), device="cpu")
    want = jfp.simulate_cluster_scan(
        jreqs, 2, 6, "fc", assignment="push",
        dynamics=jcluster.ClusterDynamics(fail=((0, 5.0),)))
    assert got.failures == want.failures > 0
    assert [q.finish for q in reqs] == [q.finish for q in jreqs]
    cells = [_burst_cell("fc", 2, 6, 15, 0, assignment="push",
                         autoscale=True)]
    assert tsweep.run_cells_scan(cells, device="cpu") == \
        jsweep.run_cells_scan([jsweep.SweepCell(**dataclasses.asdict(x))
                               for x in cells])
    with pytest.raises(ValueError):
        tsweep.run_cells_scan([_burst_cell("fc", 2, 6, 15, 0,
                                           assignment="push", lb="home",
                                           autoscale=True)], device="cpu")


def test_an_exhausted_step_budget_raises(monkeypatch):
    cell = _scan_cells(CASES[5][1][0])[0]          # an autoscaled cell
    key = cell.bucket()
    real = tfp._scan_static
    monkeypatch.setattr(tfp, "_scan_static",
                        lambda k: {**real(k), "n_steps": len(cell.feats.t)})
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tfp._run_scan_bucket(key, [cell], torch.device("cpu"))


def test_profiles_and_schedules_equal_jax():
    for speeds, deg in [((0.5, 1.0), ()), ((), ((0, 1.0, 5.0, 2.0),
                                                (2, 3.0, 4.0, 8.0))),
                        ({1: 0.25}, ((1, 0.0, 9.0, 3.0),))]:
        t = tstrag.NodeSpeedProfile.from_any(speeds, deg)
        j = jstrag.NodeSpeedProfile.from_any(speeds, deg)
        assert t.max_slowdown() == j.max_slowdown()
        for x, y in zip(t.arrays(4, 4), j.arrays(4, 4)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert tstrag.NodeSpeedProfile.from_any((1.0, 1.0)) is None
    for bad in [dict(speeds=(0.0,)), dict(episodes=((0, 2.0, 1.0, 2.0),)),
                dict(episodes=((0, 1.0, 5.0, 2.0), (0, 4.0, 6.0, 2.0)))]:
        with pytest.raises(ValueError):
            tstrag.NodeSpeedProfile(**bad)
        with pytest.raises(ValueError):
            jstrag.NodeSpeedProfile(**bad)
    assert tstrag.rolling_restart(3, 8.0, 4.0) == \
        jstrag.rolling_restart(3, 8.0, 4.0)
    d = ClusterDynamics(autoscale=True, max_nodes=7)
    j = jcluster.ClusterDynamics(autoscale=True, max_nodes=7)
    for f in dataclasses.fields(ClusterDynamics):
        assert getattr(d, f.name) == getattr(j, f.name)
    assert d.capacity_bound(3) == j.capacity_bound(3) == 7
