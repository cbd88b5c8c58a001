"""The port's straggler hedging (steal and duplicate) through the float64
frozen-priority scan, against the JAX package, on the CPU.

The JAX package scans hedged buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0 unless a line says otherwise):

* the plain ``event_step`` with ``freeze`` and ``hedge`` (``dup``) gives
  rows ``[:n]`` of start, finish, prio and node, the backups, the calls
  stolen (or won by a copy), the calls done and each row's attempts
  bit-identical to the JAX oracle (``_scan_cell_kernel``'s hedge and dup
  branches in float64) on buckets filled from real bursts: steal under the
  home and the least-loaded balancer and on one node (the self-steal),
  for FC (push FC rings) and the other policies; steal with a kill that
  loses queued calls and with the autoscaler; duplicate racing; steal with
  cold starts and node speeds;
* the carry planes of the hedge and dup flag sets (dup's copy axis
  included) have the JAX package's layout and bytes;
* the bucket keys equal the JAX package's; ``run_cells_scan`` rows,
  metrics-only and written back, equal the JAX package's on 1-seed cuts
  of the steal matrix, the dup matrix (both halves) and the straggler
  grid's hedged push cells; written-back results carry its backups,
  steals and each request's attempts;
* against the reference ``Cluster`` (no scan, no alias): ``backups``,
  ``steals`` and ``failures`` equal, the ``CROSS_CHECK_KEYS`` within
  ``CLUSTER_XCHECK_RTOL``; on a push kill that loses queued calls the
  counts are held exactly and the metrics to the JAX scan only (ROADMAP
  §3's known deviation of the JAX scan there);
* a hedged bucket scans once, at the strict step budget, and a larger
  budget gives the same rows (the scan stops at its last event); a short
  one raises;
* eligibility answers as the JAX package's, duplicate mode under push
  with dynamics refused.

The CUDA kernels are held against the plain version in
``tests/test_torch_hedge_gpu.py``, on the card.
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
from repro.core.cluster import ClusterDynamics as JDynamics
from repro.core.stragglers import HedgingSpec as JHedging
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.core.stragglers import HedgingSpec
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


def _cell(policy="fc", nodes=3, cores=4, intensity=16, seed=0, **kw):
    kw.setdefault("assignment", "push")
    kw.setdefault("hedge_multiple", 2.0)
    return tsweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed, **kw)


def _pair(c):
    """The port's and the JAX package's prepared cell of one sweep cell, on
    bursts made alike."""
    jc = jsweep.SweepCell(**dataclasses.asdict(c))
    asg = c.assignment if tsweep._cluster_shaped(c) else "single"
    out = []
    for fp, sw, cell in ((tfp, tsweep, c), (jfp, jsweep, jc)):
        reqs = sw.make_workload(cell)
        out.append(fp._ScanCell(
            requests=reqs, feats=fp._arrival_features(reqs),
            cores=c.cores, nodes=c.nodes, policy=c.policy, assignment=asg,
            lb=c.lb, warm=c.warm, dynamics=sw._cell_dynamics(cell),
            profile=sw._cell_profile(cell), hedging=sw._cell_hedging(cell)))
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
    return (tfp._fill_bucket(key, prepared), tfp._bucket_static(key, prepared),
            key, prepared)


_SEG = ("n_nodes", "n_slots", "window", "freeze", "fc_push", "dyn", "het",
        "hedge", "cold", "dup", "fc_ring", "n_copies")
_HEDGE_AUX = ("nbk", "nstl", "att", "ndone")


def _jax_scan(host, static, key):
    """The JAX oracle on the port's numpy bucket in float64, through the
    JAX package's own compiled ``(init, scan)`` pair for the bucket's key
    and batch, at the key's (optimistic) step budget: its initial (clk,
    ctr), rows (start, finish, prio, node; a ``dyn`` bucket's step records
    resolved last dispatch first) and the summary.  The port scans at the
    strict budget, which is no smaller."""
    B, n1 = host["t"].shape
    assert static["horizon"] == jfp.DEFAULT_FC_HORIZON
    assert static["n_steps"] >= 2 * key[1] + key[10]
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
    r0 = tops.HEDGE_REF_LAUNCHES
    out = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)), tens, **static)
    assert tops.HEDGE_REF_LAUNCHES == r0 + 1
    return [o.numpy() for o in out[:4]], {k: v.numpy()
                                          for k, v in out[4].items()}


DEG5 = ((0, 1.0, 300.0, 5.0),)
DEG8 = ((0, 2.0, 300.0, 8.0),)
# (name, cells): buckets of real-burst cells, one feature set each
CASES = [
    # FC (the push FC rings): home balancer on 4 nodes, least-loaded on 3,
    # and one node, whose steals go back to the node itself
    ("steal-fc", [_cell("fc", 4, 4, 14, 0, lb="home", degrade=DEG8,
                        hedge_multiple=3.0),
                  _cell("fc", 3, 4, 16, 1, degrade=DEG5),
                  _cell("fc", 1, 4, 5, 0, degrade=((0, 2.0, 300.0, 4.0),),
                        hedge_multiple=3.0)]),
    ("steal-sept-rect", [_cell("sept", 3, 4, 16, 0, degrade=DEG5),
                         _cell("rect", 4, 4, 14, 1, lb="home",
                               degrade=DEG8, hedge_multiple=3.0)]),
    # two cells of the steal matrix (its 1-seed cut below shares their
    # compiled JAX scans): node 0 of 3 x 6 killed at 8 s, losing running
    # and queued calls; and the autoscaler
    ("steal-kill", [_cell("fc", 3, 6, 16, 0, degrade=DEG5,
                          fail_spec=((0, 8.0),))]),
    ("steal-autoscale", [_cell("fc", 3, 6, 16, 0, degrade=DEG5,
                               autoscale=True, scale_up=1.0,
                               provision_delay=2.0, max_nodes=5)]),
    # the dup matrix's push cell (its 1-seed cut below shares the compile)
    ("dup", [_cell("fc", 3, 6, 16, 0, degrade=DEG5,
                   hedge_mode="duplicate")]),
    ("cold-het", [_cell("fc", 3, 4, 16, 0, degrade=DEG5, warm=False)]),
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
def test_plain_hedge_scan_bit_identical_to_jax(scans, name):
    host, static, key, prepared, ref, summ, got, aux = scans[name]
    assert static["freeze"] and static["hedge"]
    assert host["t"].dtype == np.float64
    assert static["dup"] == (name == "dup")
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{what} diverged ({name})")
    keys = (_HEDGE_AUX
            + (("nfail", "prov", "act_t", "dead") if static["dyn"] else ())
            + (("ncold", "nevt", "coldq") if static["cold"] else ()))
    assert set(aux) == set(keys) | {"stepc"}
    for k in keys:
        np.testing.assert_array_equal(np.asarray(summ[k]), aux[k],
                                      err_msg=f"{k} diverged ({name})")
    nc = len(prepared)
    n_real = [len(c.feats.t) for c in prepared]
    assert (aux["ndone"][:nc] == n_real).all()
    # every cell issues backups and steals (or wins races)
    assert (aux["nbk"][:nc] > 0).all() and (aux["nstl"][:nc] > 0).all()
    assert (aux["att"][:nc].sum(1) >= aux["nbk"][:nc]).all()
    # each step takes one event: arrivals, completions (one a copy under
    # dup), kills and re-arrivals, and the deadline fires
    assert (aux["stepc"][:nc] >= 2 * np.array(n_real)).all()
    for b, c in enumerate(prepared):
        m = len(c.feats.t)
        assert np.isfinite(got[1][b, :m]).all() and (got[1][b, :m] > 0).all()
    if name == "steal-kill":
        # more calls lost than the node has slots: queued ones too
        assert aux["nfail"][0] > 6
    if name == "steal-autoscale":
        assert aux["prov"][0] > 3
    if name == "steal-fc":
        assert key[2] == 4 and host["nodes"][2] == 1


@pytest.mark.parametrize("flags", [dict(), dict(dyn=True), dict(dup=True),
                                   dict(cold=True, het=True)],
                         ids=lambda f: "+".join(["hedge", *f]))
def test_planes_equal_jax(flags):
    kw = dict(warm=not flags.get("cold"))
    if flags.get("het"):
        kw["degrade"] = ((0, 1.0, 9.0, 3.0),)
    if flags.get("dyn"):
        kw["fail_at"] = 5.0
    if flags.get("dup"):
        kw.update(hedge_mode="duplicate", hedge_max_backups=3)
    host, static, key, _ = _bucket([_cell("fc", 2, 4, 12, 0, **kw)])
    assert static["hedge"]
    for f in ("cold", "het", "dyn", "dup"):
        assert static[f] == bool(flags.get(f)), f
    assert static["n_copies"] == (4 if flags.get("dup") else 1)
    with jax.enable_x64():
        jclk, jctr = jax.jit(jax.vmap(partial(
            jfp._make_planes, **{k: static[k] for k in _SEG})))(
                {k: jnp.asarray(v) for k, v in host.items()})
        jclk, jctr = np.asarray(jclk), np.asarray(jctr)
        jl = jfp._carry_layout(
            {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
             for k, v in host.items()}, **{k: static[k] for k in _SEG})
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    seg = {k: static[k] for k in ("freeze", "fc_push", "fc_ring", "dyn",
                                  "het", "cold", "hedge", "dup",
                                  "n_copies")}
    clk, ctr = planes.make_planes(tens, n_nodes=static["n_nodes"],
                                  n_slots=static["n_slots"],
                                  window=static["window"], **seg)
    assert clk.dtype == torch.float64 and ctr.dtype == torch.int32
    assert clk.numpy().tobytes() == jclk.tobytes()
    np.testing.assert_array_equal(ctr.numpy(), jctr)
    tl = planes.carry_layout(n_nodes=static["n_nodes"],
                             n_slots=static["n_slots"],
                             window=static["window"],
                             n_fns=host["ring0"].shape[2],
                             n1=host["t"].shape[1], **seg)
    assert tl.fparts == jl.fparts and tl.iparts == jl.iparts


# -- sweep rows ---------------------------------------------------------------
def _grids():
    """1-seed cuts: the steal matrix (FC, intensity 16: failures x the
    autoscaler, 4 cells), the dup matrix (intensity 16: its pull half, 2
    cells with a kill or none, and its push half, 1 cell) and the
    straggler grid's hedged push cell at the claim's severity (node 0 8x
    slow, 1 cell)."""
    specs = dict(matrix_specs(quick=True))
    strag = [c for c in straggler_spec(quick=True).cells()
             if c.hedge_multiple is not None and c.seed == 0
             and c.degrade[0][3] == 8.0]
    return {"steal": specs["steal"].cells(), "dup": specs["dup"].cells(),
            "straggler": strag}


@pytest.fixture(scope="module")
def grid_rows():
    """The grids' rows from the JAX package and the port, metrics-only,
    computed once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        for name, jcells in _grids().items():
            want = jsweep.run_cells_scan(jcells, metrics_only=True)
            tops.reset_launches()
            got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                        metrics_only=True, device="cpu")
            out[name] = (jcells, want, got, tops.launches())
    return out


@pytest.mark.parametrize("grid", ["steal", "dup", "straggler"])
def test_run_cells_scan_rows_equal_jax(grid_rows, grid):
    jcells, want, got, counts = grid_rows[grid]
    assert len(jcells) == {"steal": 4, "dup": 3, "straggler": 1}[grid]
    assert all(c.hedge_multiple is not None for c in jcells)
    assert counts["event_step_hedge"]["plain"] > 0
    assert not any(v["kernel"] for v in counts.values())
    for c, w, g in zip(jcells, want, got):
        assert w == g, (c.label(), {k: (w[k], g[k]) for k in w
                                    if w[k] != g[k]})
        assert "hedge" in c.label()
        # hedging acts under push only: a pull cell issues no backup
        assert (g["backups"] > 0) == (c.assignment == "push")
    if grid == "steal":
        assert any(r["failures"] > 0 for r in got)
        assert any(r["nodes_used"] > 3 for r in got)
    if grid == "dup":
        # the pull half runs the float64 pull kernel's plain version
        assert counts["event_step_dyn"]["plain"] > 0


@pytest.mark.parametrize("grid", ["steal", "dup", "straggler"])
def test_written_back_rows_equal_jax(grid_rows, grid):
    """A push cell of each grid, written back: its row equals the
    metrics-only one."""
    jcells, want, _, _ = grid_rows[grid]
    i = next(i for i, c in enumerate(jcells) if c.assignment == "push")
    got = tsweep.run_cells_scan([_port_cell(jcells[i])], device="cpu")[0]
    assert got == want[i], jcells[i].label()


def test_write_back_equals_jax(scans):
    """Each request's start, finish, priority, node and attempts, and the
    backups, steals and failures, equal the JAX package's written-back
    result on the steal matrix's cell with a kill (the JAX package reuses
    the compile of ``scans``)."""
    cells = dict(CASES)["steal-kill"]
    batches = []
    for fp, sw, cs in ((jfp, jsweep, [jsweep.SweepCell(
            **dataclasses.asdict(c)) for c in cells]), (tfp, tsweep, cells)):
        batches.append([(sw.make_workload(c), c.nodes, c.cores, c.policy,
                         "push", c.lb, sw._cell_dynamics(c),
                         sw._cell_profile(c), sw._cell_hedging(c), c.warm)
                        for c in cs])
    want = jfp.simulate_cluster_cells_scan(batches[0])
    got = tfp.simulate_cluster_cells_scan(batches[1], device="cpu")
    for c, w, g, jr, tr in zip(cells, want, got, (b[0] for b in batches[0]),
                               (b[0] for b in batches[1])):
        assert (g.backups_issued, g.steals_won, g.failures) == \
            (w.backups_issued, w.steals_won, w.failures)
        assert g.backups_issued > 0
        # an attempt a backup or a loss
        assert sum(q.attempts for q in tr) == g.backups_issued + g.failures
        for a, b in zip(jr, tr):
            assert (a.start, a.finish, a.c, a.priority, a.node,
                    a.attempts) == (b.start, b.finish, b.c, b.priority,
                                    b.node, b.attempts)


# -- against the reference Cluster -------------------------------------------
@pytest.fixture
def no_alias(monkeypatch):
    monkeypatch.delattr(jax.experimental, "enable_x64", raising=False)


REF_CELLS = [
    _cell("fc", 4, 4, 14, 0, lb="home", degrade=DEG8, hedge_multiple=3.0),
    _cell("fc", 1, 4, 5, 0, degrade=((0, 2.0, 300.0, 4.0),),
          hedge_multiple=3.0),
    _cell("fc", 3, 4, 16, 0, degrade=DEG5, hedge_mode="duplicate"),
]


def _ref_check(cell, metrics: bool):
    ref = jsweep.run_cell(dataclasses.replace(
        jsweep.SweepCell(**dataclasses.asdict(cell)), backend="reference"))
    got = tsweep.run_cells_scan([cell], device="cpu")[0]
    for k in ("backups", "steals", "failures"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    for k in jsweep.CROSS_CHECK_EXACT:
        if k in ref and k in got:
            assert got[k] == ref[k], k
    for k in jsweep.CROSS_CHECK_KEYS if metrics else ():
        if k in ref:
            assert abs(got[k] - ref[k]) <= jsweep.CLUSTER_XCHECK_RTOL * max(
                abs(ref[k]), abs(got[k]), 1e-9), (k, got[k], ref[k])
    return got, ref


@pytest.mark.parametrize("cell", REF_CELLS,
                         ids=lambda c: f"{c.label()}-{c.hedge_mode}-s{c.seed}")
def test_counts_exact_and_metrics_close_to_the_reference(no_alias, cell):
    got, _ = _ref_check(cell, metrics=True)
    assert got["backups"] > 0


def test_queued_loss_counts_exact_against_the_reference(no_alias):
    """A kill that loses queued calls as well as running ones, with steals:
    the backups, steals and lost calls are counted exactly as the reference
    does; the response times are held to the JAX scan (bit for bit, in
    ``steal-kill`` above), which is where the known deviation of the JAX
    scan from the reference on such cells lies."""
    got, ref = _ref_check(dict(CASES)["steal-kill"][0], metrics=False)
    assert got["failures"] == ref["failures"] > 6
    assert got["backups"] == ref["backups"] > 0


# -- step budgets -------------------------------------------------------------
def _small_cell():
    """The one-node self-steal cell: 20 calls in 32 rows."""
    return _pair(dict(CASES)["steal-fc"][2])[0]


def test_a_hedged_bucket_scans_once_at_the_strict_budget(monkeypatch):
    """One scan a chunk, at the cells' strict step budget; four times that
    budget gives the same rows and counts, since the scan stops at its
    last event."""
    cell = _small_cell()
    key = cell.bucket()
    calls = []
    real = tops.event_step

    def counted(*a, **kw):
        calls.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(tfp._kops, "event_step", counted)
    want = tfp._run_scan_bucket(key, [cell], torch.device("cpu"))[0]
    assert calls == [2 * key[1] + tfp._pow2(cell.hedge_budget_full())]
    assert want[4]["backups"] > 0
    full = tfp._ScanCell.hedge_budget_full
    monkeypatch.setattr(tfp._ScanCell, "hedge_budget_full",
                        lambda self: 4 * full(self))
    got = tfp._run_scan_bucket(key, [cell], torch.device("cpu"))[0]
    assert calls[1] > calls[0]
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(a, b)
    assert {k: v for k, v in want[4].items() if k != "attempts"} == \
        {k: v for k, v in got[4].items() if k != "attempts"}
    np.testing.assert_array_equal(want[4]["attempts"], got[4]["attempts"])


def test_a_short_strict_budget_raises(monkeypatch):
    cell = _small_cell()
    real = tfp._bucket_static
    monkeypatch.setattr(tfp, "_bucket_static", lambda k, cs: {
        **real(k, cs), "n_steps": len(cell.feats.t)})
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tfp._run_scan_bucket(cell.bucket(), [cell], torch.device("cpu"))


def test_budgets_equal_jax():
    """The optimistic budget (the key's) and the strict one (the port's
    scans) and the ring size are the JAX package's, dynamics included."""
    for c in (dict(CASES)["steal-kill"] + dict(CASES)["steal-autoscale"]
              + dict(CASES)["dup"]
              + dict(CASES)["steal-fc"]):
        t, j = _pair(c)
        assert t.hedge_budget() == j.hedge_budget() > 0
        assert t.hedge_budget_full() == j.hedge_budget_full()
        assert (t.n_copies, t.dup) == (j.n_copies, j.dup)
        assert t.bucket() == j.bucket()


# -- eligibility --------------------------------------------------------------
def test_eligibility_answers_as_jax():
    """Steal and duplicate hedging under push and pull, with and without
    dynamics and node speeds: the port takes a cell exactly when the JAX
    package's capability matrix and ``cluster_scan_eligible`` do, refusing
    duplicate mode under push with dynamics and dynamics with the home
    balancer (``ValueError``); a one-node hedged cell is a cluster cell."""
    cases = [_cell("fc", 2, 4, 12, 0),
             _cell("fc", 2, 4, 12, 0, hedge_mode="duplicate"),
             _cell("fc", 2, 4, 12, 0, hedge_mode="duplicate", fail_at=5.0),
             _cell("fc", 2, 4, 12, 0, hedge_mode="duplicate",
                   autoscale=True),
             _cell("fc", 2, 4, 12, 0, assignment="pull",
                   hedge_mode="duplicate", fail_at=5.0),
             _cell("fc", 2, 4, 12, 0, fail_at=5.0),
             _cell("fc", 2, 4, 12, 0, lb="home", fail_at=5.0),
             _cell("fc", 2, 4, 12, 0, lb="home", degrade=DEG5),
             _cell("sept", 1, 4, 12, 0),
             _cell("fc", 2, 40, 12, 0, warm=False)]
    reqs = tsweep.make_workload(cases[0])
    jreqs = jsweep.make_workload(jsweep.SweepCell(
        **dataclasses.asdict(cases[0])))
    got_all = []
    for c in cases:
        jc = jsweep.SweepCell(**dataclasses.asdict(c))
        assert tsweep._cluster_shaped(c)
        want = (jsweep._cluster_scan_capable(jc)
                and jsweep._cluster_scan_ok(jc, jreqs, c.policy))
        got = tsweep._cluster_scan_capable(c) and tfp.cluster_scan_eligible(
            reqs, c.nodes, c.cores, c.policy, assignment=c.assignment,
            lb=c.lb, warm=c.warm, dynamics=tsweep._cell_dynamics(c),
            profile=tsweep._cell_profile(c),
            hedging=tsweep._cell_hedging(c))
        assert got == want, c.label()
        got_all.append(got)
        if not got:
            with pytest.raises(ValueError):
                tsweep.run_cells_scan([c], metrics_only=True, device="cpu")
    assert got_all == [True, True, False, False, True, True, False, True,
                       True, False]
    # the tuple form refuses duplicate mode under push with dynamics too
    with pytest.raises(ValueError):
        tfp.simulate_cluster_cells_scan(
            [(reqs, 2, 4, "fc", "push", "least_loaded",
              ClusterDynamics(fail=((0, 5.0),)), None,
              HedgingSpec(multiple=2.0, mode="duplicate"))], device="cpu")
    assert not tfp.cluster_scan_eligible(
        reqs, 2, 4, "fc", assignment="push", hedging=HedgingSpec(
            multiple=2.0, mode="duplicate"),
        dynamics=ClusterDynamics(fail=((0, 5.0),)))
    assert not jfp.cluster_scan_eligible(
        jreqs, 2, 4, "fc", assignment="push", hedging=JHedging(
            multiple=2.0, mode="duplicate"),
        dynamics=JDynamics(fail=((0, 5.0),)))


def test_hedging_spec_and_labels_equal_jax():
    """``HedgingSpec`` validates and sets deadlines as the JAX package's;
    hedged cells carry the ``hedge<m>`` label part and the spec's
    ``hedge_multiples`` axis and ``cell_filter`` yield the JAX package's
    cells in its order."""
    for kw in (dict(multiple=0.0), dict(floor_s=-1.0),
               dict(max_backups=-1), dict(mode="race")):
        with pytest.raises(ValueError):
            HedgingSpec(**kw)
        with pytest.raises(ValueError):
            JHedging(**kw)
    h, jh = HedgingSpec(multiple=2.5, floor_s=0.3), JHedging(multiple=2.5,
                                                             floor_s=0.3)
    for now, est in ((1.0, 0.1), (7.5, 2.25)):
        assert h.deadline(now, est) == jh.deadline(now, est)
    jspec = straggler_spec()
    tspec = tsweep.SweepSpec(**{
        f.name: getattr(jspec, f.name)
        for f in dataclasses.fields(tsweep.SweepSpec)
        if f.name != "backends"})
    want, got = jspec.cells(), tspec.cells()
    assert len(got) == len(want) == 120
    assert [_port_cell(c) for c in want] == got
    assert [dataclasses.replace(c, backend="reference").label()
            for c in want] == [c.label() for c in got]
    assert sum(c.hedge_multiple is not None for c in got) == 20


def test_chip_smoke_grids_are_the_benchmark_grids():
    """``chip_smoke.py``'s phase 3f paths are the JAX package's straggler
    grid (120 cells), steal matrix (32) and dup matrix (24), cell for cell
    and in order."""
    import chip_smoke

    specs = dict(matrix_specs())
    for want, got in ((straggler_spec().cells(),
                       chip_smoke.straggler_grid_cells()),
                      (specs["steal"].cells(),
                       chip_smoke.steal_matrix_cells()),
                      (specs["dup"].cells(), chip_smoke.dup_matrix_cells())):
        assert [_port_cell(c) for c in want] == got
        assert [dataclasses.replace(c, backend="reference").label()
                 for c in want] == [c.label() for c in got]
    assert [len(chip_smoke.straggler_grid_cells()),
            len(chip_smoke.steal_matrix_cells()),
            len(chip_smoke.dup_matrix_cells())] == [120, 32, 24]
