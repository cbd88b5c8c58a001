"""The port's float64 frozen-priority scan (single-node and push cells with
capacity dynamics, node speeds or cold starts) against the JAX package, on
the CPU.

The JAX package scans these buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0 unless a line says otherwise):

* the carry planes of every new flag set (freeze with ``cold``, ``het``,
  ``dyn`` and their unions) have the JAX package's layout and bytes;
* the plain ``event_step`` with ``freeze`` and ``dyn`` / ``het`` /
  ``cold`` (``repro_torch.kernels.ops`` on CPU tensors) gives rows
  ``[:n]`` of start, finish, prio and node, the summary (calls lost and
  done, nodes provisioned, activation times, dead flags) and the cold
  starts, evictions and every row's cold-start flag bit-identical to the
  JAX oracle (``_scan_cell_kernel``'s float64 frozen-priority branches,
  its step records resolved last dispatch first) on buckets filled from
  real bursts: push least-loaded with a kill that loses running and
  queued calls, which re-arrive at one instant; push least-loaded with the
  autoscaler; push home with slow nodes; push least-loaded with speeds,
  failures and the autoscaler; push cold starts for FC and SEPT;
  single-node cold starts; push least-loaded cold starts with speeds,
  failures and the autoscaler; push home cold starts with slow nodes;
* the bucket keys equal the JAX package's; ``run_cells_scan`` rows, with
  ``metrics_only`` and written back, equal the JAX package's on the cold
  matrix's push half and a 1-seed cut of the straggler grid's unhedged
  push half; written-back results carry the JAX package's failures,
  nodes used, timeline, cold starts, evictions and each request's
  ``cold_start``;
* against the reference ``Cluster`` (no scan, no alias): ``cold`` and the
  ``CROSS_CHECK_EXACT`` counters equal, the ``CROSS_CHECK_KEYS`` within
  ``CLUSTER_XCHECK_RTOL``;
* eligibility answers as the JAX package's: push dynamics with the home
  balancer and failures on one node are refused (``ValueError``); a hedged
  cell is taken (steal), and refused in duplicate mode with dynamics; a
  step budget cut short raises; the kernel's plan (staged or wide,
  scratch words) follows from the shape.

The CUDA kernel is held against the plain version in
``tests/test_torch_freeze64_gpu.py``, on the card.
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

from repro.core import fastpath as jfp
from repro.core import sweep as jsweep
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import sweep as tsweep
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.engine_bench import matrix_specs, straggler_spec  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _port_cell(jcell) -> tsweep.SweepCell:
    return tsweep.SweepCell(**{f.name: getattr(jcell, f.name)
                               for f in dataclasses.fields(tsweep.SweepCell)
                               if f.name != "backend"})


def _cell(policy="fc", nodes=3, cores=4, intensity=20, seed=0, **kw):
    kw.setdefault("assignment", "push")
    return tsweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed, **kw)


def _pair(c):
    """The port's and the JAX package's prepared cell of one sweep cell
    (single-node when it is not cluster-shaped), on bursts made alike."""
    jc = jsweep.SweepCell(**dataclasses.asdict(c))
    asg = c.assignment if tsweep._cluster_shaped(c) else "single"
    out = []
    for fp, sw, cell in ((tfp, tsweep, c), (jfp, jsweep, jc)):
        reqs = sw.make_workload(cell)
        out.append(fp._ScanCell(
            requests=reqs, feats=fp._arrival_features(reqs),
            cores=c.cores, nodes=c.nodes, policy=c.policy, assignment=asg,
            lb=c.lb, warm=c.warm, dynamics=sw._cell_dynamics(cell),
            profile=sw._cell_profile(cell)))
    return out


def _bucket(cells):
    """The port's bucket of ``cells`` under the widest key, each cell's key
    checked against the JAX package's: host inputs, static arguments, key,
    prepared cells."""
    pairs = [_pair(c) for c in cells]
    for t, j in pairs:
        assert t.bucket() == j.bucket()
    keys = {t.bucket() for t, _ in pairs}
    assert len({k[0] for k in keys}) == 1
    key = tuple(max(col) for col in zip(*keys))
    prepared = [t for t, _ in pairs]
    return (tfp._fill_bucket(key, prepared), tfp._scan_static(key), key,
            prepared)


_SEG = ("n_nodes", "n_slots", "window", "freeze", "fc_push", "dyn", "het",
        "hedge", "cold", "dup", "fc_ring")


def _jax_scan(host, static, key):
    """The JAX oracle on the port's numpy bucket in float64, through the
    JAX package's own compiled ``(init, scan)`` pair for the bucket's key
    and batch (the one its ``run_cells_scan`` dispatches, which so reuses
    the compile): its initial (clk, ctr), rows (start, finish, prio, node;
    a ``dyn`` bucket's step records resolved last dispatch first, its prio
    and node the frozen values) and the summary."""
    B, n1 = host["t"].shape
    # the runner's step arguments are the JAX package's; the port's equal them
    assert static["horizon"] == jfp.DEFAULT_FC_HORIZON
    assert static["n_steps"] == 2 * key[1] + key[10]
    init_c, scan_c = jfp._scan_runner((*key, B))
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in host.items()}
        clk, ctr = init_c(arrs)
        # copies first: the scan donates the planes
        clk0, ctr0 = np.array(clk), np.array(ctr)
        out = jax.tree_util.tree_map(np.asarray, scan_c(clk, ctr, arrs))
    if not static["dyn"]:
        rows, summ = list(out[:4]), out[4]
    else:
        (j_s, es_s, fs_s, _, _), summ = out
        rows = [np.zeros((B, n1)), np.zeros((B, n1)),
                np.asarray(summ["prio"]), np.asarray(summ["node"])]
        for b in range(B):
            for r, v in zip(rows, (es_s, fs_s)):
                r[b, j_s[b]] = v[b]
    return clk0, ctr0, rows, summ


def _torch_scan(host, clk, ctr, static):
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    r0 = tops.FREEZE64_REF_LAUNCHES
    out = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)), tens, **static)
    assert tops.FREEZE64_REF_LAUNCHES == r0 + 1
    return [o.numpy() for o in out[:4]], {k: v.numpy()
                                          for k, v in out[4].items()}


STEAL = dict(degrade=((0, 1.0, 300.0, 5.0),), autoscale=True, scale_up=1.0,
             provision_delay=2.0, max_nodes=5)
# node 0 of 3 x 2 cores dies at 20 s with every slot busy and calls queued
# on it: both kinds are lost and re-arrive at one instant
FAIL = dict(workload_cores=12, fail_spec=((0, 20.0),))

# (name, cells): buckets of real-burst cells, one feature set each
CASES = [
    ("push-ll-fail", [_cell(p, 3, 2, 20, s, **FAIL)
                      for s, p in enumerate(("sept", "rect"))]),
    ("push-ll-fc-fail-autoscale", [
        _cell("fc", 3, 2, 20, 0, **FAIL),
        _cell("fc", 1, 4, 30, 1, workload_cores=8, autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=3)]),
    ("push-home-het", [_cell(p, 4, 4, 14, s, lb="home",
                             node_speeds=(0.7, 1.0, 1.3, 1.0),
                             degrade=((0, 2.0, 300.0, 6.0),))
                       for s, p in enumerate(("rect", "eect"))]),
    ("push-ll-het-dyn", [_cell("fc", 3, 6, 16, s, fail_spec=((1, 8.0),),
                               **STEAL) for s in range(2)]),
    # push SEPT and single-node FC and SEPT share a feature set
    ("cold", [_cell("sept", 2, 4, 16, 0, warm=False),
              _cell("sept", 2, 4, 16, 1, warm=False),
              _cell("fc", 1, 4, 20, 0, warm=False),
              _cell("sept", 1, 4, 20, 1, warm=False)]),
    ("push-cold-fc", [_cell("fc", 2, 4, 16, s, warm=False)
                      for s in range(2)]),
    ("push-ll-cold-het-dyn", [
        _cell(p, 3, 4, 16, s, warm=False, fail_spec=((0, 8.0),),
              degrade=((1, 1.0, 300.0, 5.0),), autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=5)
        for s, p in enumerate(("eect", "fifo", "sept"))]),
    ("push-home-cold-het", [
        _cell("rect", 3, 4, 16, s, lb="home", warm=False,
              node_speeds=(0.3, 1.0, 0.7), degrade=((0, 1.0, 300.0, 5.0),))
        for s in range(3)]),
]


@pytest.fixture(scope="module")
def scans():
    """Each case's bucket through the JAX oracle and the plain version,
    computed once for the tests below."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        for name, cells in CASES:
            host, static, key, prepared = _bucket(cells)
            clk, ctr, ref, summ = _jax_scan(host, static, key)
            got, aux = _torch_scan(host, clk, ctr, static)
            out[name] = (host, static, key, prepared, ref, summ, got, aux)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_plain_freeze64_scan_bit_identical_to_jax(scans, name):
    host, static, key, prepared, ref, summ, got, aux = scans[name]
    assert static["freeze"] and host["t"].dtype == np.float64
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{what} diverged ({name})")
    keys = (("nfail", "ndone", "prov", "act_t", "dead") if static["dyn"]
            else ()) + (("ncold", "nevt", "coldq") if static["cold"] else ())
    assert set(aux) == set(keys)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(summ[k]), aux[k],
                                      err_msg=f"{k} diverged ({name})")
    nc = len(prepared)
    finish = got[1]
    for b, c in enumerate(prepared):
        m = len(c.feats.t)
        assert np.isfinite(finish[b, :m]).all() and (finish[b, :m] > 0).all()
    if static["dyn"]:
        assert (aux["ndone"][:nc] == host["nreq"][:nc]).all()
    if static["cold"]:
        assert (aux["ncold"][:nc] > 0).all()
        if not static["dyn"]:
            assert (aux["coldq"][:nc].sum(1) == aux["ncold"][:nc]).all()
    cells = dict(CASES)[name]
    for b, c in enumerate(cells):
        if c.fail_spec == FAIL["fail_spec"]:
            # more calls lost than the node has slots: queued ones too
            assert aux["nfail"][b] > c.cores, (name, b)
        if c.autoscale:
            assert aux["prov"][b] > c.nodes, (name, b)
    if "single" in name or name == "cold":
        assert (host["nodes"][:nc] == [2, 2, 1, 1]).all()


def test_same_instant_rearrivals_replay_the_kill_order(scans, monkeypatch):
    """The lost calls re-arrive at one instant, ex-running first in launch
    order, then ex-queued by frozen priority, and the order decides where
    each goes: ranking them all by frozen priority instead (every rank
    taken as ex-queued) changes the rows."""
    from repro_torch.kernels import event_step as tev

    for name in ("push-ll-fail",):
        host, static, key, _, ref, _, got, aux = scans[name]
        assert (aux["nfail"][:2] > 2).all()
        tens = {k: torch.from_numpy(v) for k, v in host.items()}
        clk, ctr = planes.make_planes(
            tens, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            window=static["window"], freeze=True, fc_push=static["fc_push"],
            fc_ring=static["fc_ring"], dyn=True)
        monkeypatch.setattr(tev, "RORD_Q", 0)
        wrong = tops.event_step(clk, ctr, tens, **static)
        monkeypatch.undo()
        n = key[1]
        assert not all(np.array_equal(a[:, :n], w.numpy()[:, :n])
                       for a, w in zip(ref, wrong[:4])), name


@pytest.mark.parametrize("flags", [dict(cold=True), dict(het=True),
                                   dict(dyn=True), dict(het=True, dyn=True),
                                   dict(cold=True, het=True, dyn=True)],
                         ids=lambda f: "+".join(f))
def test_planes_equal_jax(flags):
    kw = dict(warm=not flags.get("cold"))
    if flags.get("het"):
        kw["degrade"] = ((0, 1.0, 9.0, 3.0),)
    if flags.get("dyn"):
        kw["fail_at"] = 5.0
    host, static, key, _ = _bucket([_cell("fc", 2, 4, 12, 0, **kw)])
    for f in ("cold", "het", "dyn"):
        assert static[f] == bool(flags.get(f)), f
    with jax.enable_x64():
        jclk, jctr = jax.jit(jax.vmap(partial(
            jfp._make_planes, n_copies=1, **{k: static[k] for k in _SEG})))(
                {k: jnp.asarray(v) for k, v in host.items()})
        jclk, jctr = np.asarray(jclk), np.asarray(jctr)
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    seg = {k: static[k] for k in ("freeze", "fc_push", "fc_ring", "dyn",
                                  "het", "cold")}
    clk, ctr = planes.make_planes(tens, n_nodes=static["n_nodes"],
                                  n_slots=static["n_slots"],
                                  window=static["window"], **seg)
    assert clk.dtype == torch.float64 and ctr.dtype == torch.int32
    assert clk.numpy().tobytes() == jclk.tobytes()
    np.testing.assert_array_equal(ctr.numpy(), jctr)
    with jax.enable_x64():
        jl = jfp._carry_layout(
            {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
             for k, v in host.items()}, n_copies=1,
            **{k: static[k] for k in _SEG})
    tl = planes.carry_layout(n_nodes=static["n_nodes"],
                             n_slots=static["n_slots"],
                             window=static["window"],
                             n_fns=host["ring0"].shape[2],
                             n1=host["t"].shape[1], **seg)
    assert tl.fparts == jl.fparts and tl.iparts == jl.iparts


# -- sweep rows ---------------------------------------------------------------
def _cold_push_half():
    """The cold matrix's push half: FC and SEPT on 4 x 8 cores, a 32-core
    burst at intensity 18 (638 calls), 5 seeds: 10 cells."""
    cold = dict(matrix_specs())["cold"]
    return [c for c in cold.cells() if c.assignment == "push"]


def _straggler_push_half():
    """A 1-seed cut of the straggler grid's unhedged push half: FC on 4 x 8
    cores (home balancer), a 32-core burst at intensity 18, node 0 healthy
    or 2 / 4 / 6 / 8x slow: 5 cells."""
    return [c for c in straggler_spec().cells()
            if c.assignment == "push" and c.hedge_multiple is None
            and c.seed == 0]


@pytest.fixture(scope="module")
def grid_rows():
    """The two grids' rows from the JAX package and the port, metrics-only,
    computed once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        for name, jcells in (("cold", _cold_push_half()),
                             ("straggler", _straggler_push_half())):
            want = jsweep.run_cells_scan(jcells, metrics_only=True)
            tops.reset_launches()
            got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                        metrics_only=True, device="cpu")
            out[name] = (jcells, want, got, tops.launches())
    return out


@pytest.mark.parametrize("grid", ["cold", "straggler"])
def test_run_cells_scan_rows_equal_jax(grid_rows, grid):
    jcells, want, got, counts = grid_rows[grid]
    assert len(jcells) == (10 if grid == "cold" else 5)
    assert counts["event_step_freeze64"]["plain"] > 0
    # the healthy straggler cell is a static warm bucket
    assert (counts["event_step_freeze"]["plain"] > 0) == (grid == "straggler")
    for c, w, g in zip(jcells, want, got):
        assert w == g, (c.label(), {k: (w[k], g[k]) for k in w
                                    if w[k] != g[k]})
        assert (g["cold"] > 0) == (grid == "cold")


@pytest.mark.parametrize("grid", ["cold", "straggler"])
def test_written_back_rows_equal_jax(grid_rows, grid):
    """A cell of each grid (cold: FC, seed 0; straggler: node 0 8x slow),
    written back: its row equals the metrics-only one."""
    jcells, want, _, _ = grid_rows[grid]
    pick = [0] if grid == "cold" else [4]
    got = tsweep.run_cells_scan([_port_cell(jcells[i]) for i in pick],
                                device="cpu")
    for i, g in zip(pick, got):
        assert g == want[i], jcells[i].label()


@pytest.mark.parametrize("case", ["push-cold-fc", "push-ll-het-dyn"])
def test_write_back_equals_jax(scans, case):
    """Each request's start, finish, priority, node and cold_start, and the
    failures, nodes used, timeline, cold starts and evictions, equal the
    JAX package's written-back result, on the cells of a bucket above (one
    key a bucket, so the JAX package reuses the compile of ``scans``)."""
    cells = dict(CASES)[case]
    key = scans[case][2]
    batches = []
    for fp, sw, cs in ((jfp, jsweep, [jsweep.SweepCell(
            **dataclasses.asdict(c)) for c in cells]), (tfp, tsweep, cells)):
        batches.append([(sw.make_workload(c), c.nodes, c.cores, c.policy,
                         "push", c.lb, sw._cell_dynamics(c),
                         sw._cell_profile(c), None, c.warm) for c in cs])
    assert {t.bucket() for t, _ in map(_pair, cells)} == {key}
    want = jfp.simulate_cluster_cells_scan(batches[0])
    got = tfp.simulate_cluster_cells_scan(batches[1], device="cpu")
    for c, w, g, jr, tr in zip(cells, want, got, (b[0] for b in batches[0]),
                               (b[0] for b in batches[1])):
        for k in ("cold_starts", "evictions", "failures", "nodes_used"):
            assert getattr(g, k) == getattr(w, k), (k, c.label())
        if not c.warm:
            assert g.cold_starts > 0
            assert sum(q.cold_start for q in tr) == g.cold_starts
        else:
            assert g.failures > 0 and g.nodes_used > c.nodes
            assert g.timeline.activate == w.timeline.activate
            assert g.timeline.deactivate == w.timeline.deactivate
        for a, b in zip(jr, tr):
            assert (a.start, a.finish, a.c, a.priority, a.node,
                    a.cold_start) == (b.start, b.finish, b.c, b.priority,
                                      b.node, b.cold_start)


def test_single_node_cold_rows_equal_jax():
    """Cold single-node cells through ``simulate_cells_scan``, written back,
    as the JAX package's; the port's metrics-only rows equal its
    written-back ones."""
    cells = [tsweep.SweepCell(policy=p, cores=10, intensity=30, seed=0,
                              warm=False) for p in ("fc", "sept")]
    jcell = jsweep.SweepCell(**dataclasses.asdict(cells[0]))
    jr, tr = jsweep.make_workload(jcell), tsweep.make_workload(cells[0])
    want = jfp.simulate_cells_scan([(jr, 10, p, False) for p in
                                    ("fc", "sept")], metrics_only=True)
    got = tfp.simulate_cells_scan([(tr, 10, p, False) for p in
                                   ("fc", "sept")], metrics_only=True,
                                  device="cpu")
    for a, b in zip(want, got):
        assert (a.cold_starts, a.evictions) == (b.cold_starts, b.evictions)
        assert a.cold_starts > 0
        np.testing.assert_array_equal(a.resp, b.resp)
    rows = tsweep.run_cells_scan(cells, metrics_only=True, device="cpu")
    assert tsweep.run_cells_scan(cells, device="cpu") == rows
    assert [r["cold"] for r in rows] == [a.cold_starts for a in want]


# -- against the reference Cluster -------------------------------------------
@pytest.fixture
def no_alias(monkeypatch):
    monkeypatch.delattr(jax.experimental, "enable_x64", raising=False)


REF_CELLS = [
    _cell("sept", 3, 4, 30, 0, fail_spec=((0, 6.0),)),
    _cell("fc", 3, 4, 16, 1, warm=False),
    _cell("fc", 1, 4, 30, 0, workload_cores=8, autoscale=True,
          provision_delay=5.0, scale_up=1.0, max_nodes=3),
    _cell("fc", 4, 4, 14, 0, lb="home", degrade=((0, 2.0, 300.0, 6.0),)),
]


def _ref_check(cell, metrics: bool):
    ref = jsweep.run_cell(dataclasses.replace(
        jsweep.SweepCell(**dataclasses.asdict(cell)), backend="reference"))
    got = tsweep.run_cells_scan([cell], device="cpu")[0]
    assert got["cold"] == ref["cold"]
    for k in jsweep.CROSS_CHECK_EXACT:
        if k in ref and k in got:
            assert got[k] == ref[k], k
    for k in jsweep.CROSS_CHECK_KEYS if metrics else ():
        if k in ref:
            assert abs(got[k] - ref[k]) <= jsweep.CLUSTER_XCHECK_RTOL * max(
                abs(ref[k]), abs(got[k]), 1e-9), (k, got[k], ref[k])
    return got, ref


@pytest.mark.parametrize("cell", REF_CELLS,
                         ids=lambda c: f"{c.label()}-s{c.seed}")
def test_counts_exact_and_metrics_close_to_the_reference(no_alias, cell):
    _ref_check(cell, metrics=True)


def test_queued_loss_counts_exact_against_the_reference(no_alias):
    """A kill that loses queued calls as well as running ones: the lost
    calls are counted exactly as the reference does.  The response times
    are not held to ``CLUSTER_XCHECK_RTOL`` here: on this cell the JAX
    package's scan, which the port equals bit for bit
    (``push-ll-fail`` above), is 15% above the reference's R_avg."""
    got, ref = _ref_check(CASES[0][1][0], metrics=False)
    assert got["failures"] == ref["failures"] > 2


# -- eligibility, refusals ----------------------------------------------------
def test_eligibility_answers_as_jax():
    """Push dynamics need the least-loaded balancer, failures a second
    node; a hedged cell is taken (steal), and refused in duplicate mode
    under push with dynamics.  The port's ``run_cells_scan``
    takes a cell exactly when the JAX package's capability matrix and
    ``cluster_scan_eligible`` do, and refuses the rest with
    ``ValueError``; a dynamics axis set to no event is refused as a set
    one, which ``cluster_scan_eligible`` alone would accept."""
    from repro.core.stragglers import HedgingSpec

    cases = [_cell("fc", 2, 4, 12, 0, lb="home", autoscale=True),
             _cell("fc", 2, 4, 12, 0, lb="home", fail_at=5.0),
             _cell("fc", 1, 4, 12, 0, fail_at=5.0),
             _cell("fc", 1, 4, 12, 0, assignment="pull", fail_at=5.0),
             _cell("fc", 2, 4, 12, 0, autoscale=True),
             _cell("fc", 2, 4, 12, 0, lb="home", degrade=((0, 1, 9, 3.0),)),
             _cell("fc", 2, 4, 12, 0, lb="home", warm=False),
             _cell("fc", 2, 40, 12, 0, warm=False),
             _cell("sept", 1, 4, 12, 0, warm=False),
             # dynamics axes set to no event count as set
             _cell("fc", 2, 4, 12, 0, lb="home", fail_spec=()),
             _cell("fc", 1, 4, 12, 0, fail_spec=()),
             _cell("fc", 2, 4, 12, 0, assignment="pull", fail_spec=())]
    reqs = tsweep.make_workload(cases[0])
    jreqs = jsweep.make_workload(jsweep.SweepCell(
        **dataclasses.asdict(cases[0])))
    for c in cases:
        jc = jsweep.SweepCell(**dataclasses.asdict(c))
        if tsweep._cluster_shaped(c):
            want = (jsweep._cluster_scan_capable(jc)
                    and jsweep._cluster_scan_ok(jc, jreqs, c.policy))
            got = tsweep._cluster_scan_capable(c) and tfp.cluster_scan_eligible(
                reqs, c.nodes, c.cores, c.policy, assignment=c.assignment,
                lb=c.lb, warm=c.warm, dynamics=tsweep._cell_dynamics(c),
                profile=tsweep._cell_profile(c))
        else:
            want = jfp.scan_eligible(jreqs, c.cores, c.policy, warm=c.warm)
            got = tfp.scan_eligible(reqs, c.cores, c.policy, warm=c.warm)
        assert got == want, c.label()
        if not got:
            with pytest.raises(ValueError):
                tsweep.run_cells_scan([c], metrics_only=True, device="cpu")
    assert [tsweep._cluster_scan_capable(c) for c in cases[:4]] == [False] * 4
    assert [tsweep._cluster_scan_capable(c) for c in cases[-3:]] == \
        [False, False, True]
    from repro_torch.core.cluster import ClusterDynamics
    from repro_torch.core.stragglers import HedgingSpec as THedgingSpec

    # a steal-mode hedged cell runs (the JAX package's answer too)
    assert jfp.cluster_scan_eligible(jreqs, 2, 4, "fc", assignment="push",
                                     hedging=HedgingSpec(multiple=2.0))
    res = tfp.simulate_cluster_cells_scan(
        [(reqs, 2, 4, "fc", "push", "least_loaded", None, None,
          THedgingSpec(multiple=2.0))], metrics_only=True, device="cpu")[0]
    assert len(res.resp) == len(reqs) and res.backups >= 0
    # duplicate mode under push with a failure is refused
    with pytest.raises(ValueError):
        tfp.simulate_cluster_cells_scan(
            [(reqs, 2, 4, "fc", "push", "least_loaded",
              ClusterDynamics(fail=((0, 5.0),)), None,
              THedgingSpec(multiple=2.0, mode="duplicate"))], device="cpu")


def test_an_exhausted_step_budget_raises(monkeypatch):
    cell = _pair(_cell("fc", 3, 2, 20, 0, **FAIL))[0]
    key = cell.bucket()
    real = tfp._scan_static
    monkeypatch.setattr(tfp, "_scan_static",
                        lambda k: {**real(k), "n_steps": len(cell.feats.t)})
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tfp._run_scan_bucket(key, [cell], torch.device("cpu"))


def test_freeze64_plan_by_shape():
    """The float64 frozen-priority kernel's plan: staged in shared memory
    at the push widths up to n_b ~5,000, the wide path past that or past
    64 slots or 32 nodes; the scratch holds the per-row dynamics arrays
    and the float64 FC rings."""
    plan = partial(tops.event_step_plan, n_fns=16, window=10, freeze=True,
                   f64=True)
    # the cold matrix's push bucket: 4 x 8 cores, n_b 1,024, FC rings of 64
    p = plan(n1=1025, n_nodes=4, n_slots=8, fc_push=True, fc_ring=64,
             dyn=False, cold=True)
    assert p == {"per_lane": 1, "wide": False, "staged": True,
                 "cell_bytes": tops.event_step_freeze64_cell_bytes(
                     True, 1025, 4, 16, 10, True),
                 "scratch_words": 2 * 4 * 16 * 64}
    assert p["cell_bytes"] % 16 == 0 and p["cell_bytes"] < 48 * 1024
    # the steal matrix's bucket: 8 x 8 slots (2 a lane), dynamics
    p = plan(n1=513, n_nodes=8, n_slots=8, fc_push=False, fc_ring=1,
             dyn=True, cold=False)
    assert (p["per_lane"], p["staged"]) == (2, True)
    assert p["scratch_words"] == 2 * 514 + 516
    # n_b 8,192 does not fit a block: the wide path, rows in place
    p = plan(n1=8193, n_nodes=4, n_slots=8, fc_push=False, fc_ring=1,
             dyn=False, cold=True)
    assert (p["per_lane"], p["wide"], p["staged"], p["cell_bytes"]) == \
        (1, True, False, 0)
    assert p["scratch_words"] == 32 * (6 + 12) + \
        tops.event_step_freeze64_cell_bytes(False, 8193, 4, 16, 10, True) // 4
    # 16 x 8 slots: past the staged widths (1 and 2 a lane), the wide path
    p = plan(n1=513, n_nodes=16, n_slots=8, fc_push=False, fc_ring=1,
             dyn=True, cold=False)
    assert (p["per_lane"], p["wide"], p["staged"]) == (4, True, False)
    # 16 x 18 cores pad to 512 slots: the wide path, 16 slots a lane
    p = plan(n1=1025, n_nodes=16, n_slots=32, fc_push=False, fc_ring=1,
             dyn=True, cold=False)
    assert (p["per_lane"], p["wide"]) == (16, True)
