"""The port's request resilience (timeouts, retries with backoff, admission
shedding) through the float64 frozen-priority scan, against the JAX
package, on the CPU.

The JAX package scans resilience buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0):

* the plain ``event_step`` with ``freeze`` and ``res`` gives rows ``[:n]``
  of start, finish, prio and node, the timeouts, sheds, retries, wasted
  seconds, calls resolved and each row's failure flag, cause and
  submissions bit-identical to the JAX oracle (``_scan_cell_kernel``'s res
  branch in float64) on buckets filled from real bursts: the retry-storm
  benchmark's six client behaviours (1 seed), FC with backoff retries and
  shedding, the home balancer with immediate retries, an absolute timeout
  and one node;
* the carry planes of the res flag set have the JAX package's layout and
  bytes;
* the bucket keys equal the JAX package's; ``run_cells_scan`` rows,
  metrics-only and written back, equal the JAX package's on a 1-seed cut
  of the README's resilience grid and a cell where every call times out
  (the all-failed row);
* against the reference ``Cluster`` (no scan, no alias): ``timed_out``,
  ``shed`` and ``retries_issued``, the failed calls with their causes and
  each call's ``attempts`` equal;
* the port's ``resilience`` module answers as the JAX package's (delays,
  jitter draws, tensor form, validation; labels and ``SweepSpec.cells()``
  with the lifecycle axes);
* a resilience bucket scans once, at the strict step budget, and a larger
  budget gives the same rows; a short one raises;
* eligibility answers as the JAX package's: resilience under pull, cold
  starts, dynamics, hedging or node speeds is refused, and a metrics-only
  ``simulate_cluster_cells_scan`` of a resilience cell raises.

The CUDA kernel is held against the plain version in
``tests/test_torch_res_gpu.py``, on the card.
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

from _hypothesis_shim import given, settings, st
from repro.core import fastpath as jfp
from repro.core import resilience as jres
from repro.core import sweep as jsweep
from repro.core.cluster import simulate_cluster
from repro.core.workload import generate_trace_burst as j_trace_burst
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import resilience as tres
from repro_torch.core import sweep as tsweep
from repro_torch.core.workload import generate_trace_burst as t_trace_burst
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.engine_bench import STORM_SCENARIOS  # noqa: E402
from benchmarks.engine_bench import _storm_resilience  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _port_spec(spec):
    """The port's ResilienceSpec of one of the JAX package's."""
    if spec is None:
        return None
    conv = {jres.TimeoutSpec: tres.TimeoutSpec, jres.RetryPolicy:
            tres.RetryPolicy, jres.AdmissionPolicy: tres.AdmissionPolicy}
    parts = {f: getattr(spec, f) for f in ("timeout", "retry", "admission")}
    return tres.ResilienceSpec(**{
        f: None if p is None else conv[type(p)](**dataclasses.asdict(p))
        for f, p in parts.items()})


def _port_cell(jcell) -> tsweep.SweepCell:
    return tsweep.SweepCell(**{f.name: getattr(jcell, f.name)
                               for f in dataclasses.fields(tsweep.SweepCell)
                               if f.name != "backend"})


def _jax_cell(c) -> jsweep.SweepCell:
    return jsweep.SweepCell(**dataclasses.asdict(c))


def _cell(policy="sept", nodes=2, cores=4, intensity=30, seed=0, **kw):
    kw.setdefault("assignment", "push")
    return tsweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed, **kw)


def _pair_of(treqs, jreqs, nodes, cores, policy, lb, tspec, jspec):
    """The port's and the JAX package's prepared push cell of one burst
    (made alike) and lifecycle."""
    return [fp._ScanCell(requests=reqs, feats=fp._arrival_features(reqs),
                         cores=cores, nodes=nodes, policy=policy,
                         assignment="push", lb=lb, resilience=spec)
            for fp, reqs, spec in ((tfp, treqs, tspec), (jfp, jreqs, jspec))]


def _pair(c):
    """The pair of a sweep cell."""
    jc = _jax_cell(c)
    return _pair_of(tsweep.make_workload(c), jsweep.make_workload(jc),
                    c.nodes, c.cores, c.policy, c.lb,
                    tsweep._cell_resilience(c), jsweep._cell_resilience(jc))


def _storm_pairs(seed=0):
    """The storm's six cells (benchmarks/engine_bench.py::storm_rows): a
    ramp burst (T = 60 s, for 8 cores at intensity 14, 6x over [T/3,
    T/2)) on 2 x 4 push least-loaded SEPT under each client behaviour."""
    kw = dict(cores=8, intensity=14, seed=1000 + seed, kind="ramp",
              duration_s=60.0, burst_factor=6.0, burst_start_frac=1 / 3,
              burst_end_frac=1 / 2)
    treqs, jreqs = t_trace_burst(**kw), j_trace_burst(**kw)
    out = []
    for _, mode, shed in STORM_SCENARIOS:
        jspec = _storm_resilience(mode, shed)
        out.append(_pair_of(treqs, jreqs, 2, 4, "sept", "least_loaded",
                            _port_spec(jspec), jspec))
    return out


# (case, cells): the cases of the first contract, all of n_b 256.  The SEPT
# cases share one bucket (one JAX compile) and FC's the other; each case
# checks its rows
_SEPT_CASES = {
    "storm": None,                    # the six storm cells
    "home": [_cell("sept", 3, 4, 18, 0, lb="home", timeout_multiple=2.0,
                   timeout_floor_s=1.0, retry_attempts=3,
                   retry_mode="immediate")],
    "absolute": [_cell("sept", 2, 4, 28, 1, timeout_multiple=3.0,
                       timeout_absolute_s=0.5)],
    "one-node": [_cell("sept", 1, 4, 30, 0, timeout_multiple=2.0,
                       retry_attempts=2, shed_threshold=1.0)],
}
_FC_CASES = {
    "fc-backoff-shed": [_cell("fc", 2, 4, 28, s, timeout_multiple=3.0,
                              timeout_floor_s=2.0, retry_attempts=3,
                              shed_threshold=2.0) for s in range(2)],
}


def _bucket(pairs):
    """The port's bucket of the pairs' cells under the widest key, each
    cell's key checked against the JAX package's: host inputs, static
    arguments, key, prepared cells."""
    for t, j in pairs:
        assert t.bucket() == j.bucket()
    keys = {t.bucket() for t, _ in pairs}
    assert len({k[0] for k in keys}) == 1
    key = tuple(max(col) for col in zip(*keys))
    prepared = [t for t, _ in pairs]
    return (tfp._fill_bucket(key, prepared), tfp._bucket_static(key, prepared),
            key, prepared)


_SEG = ("n_nodes", "n_slots", "window", "freeze", "fc_push", "dyn", "het",
        "hedge", "cold", "dup", "fc_ring", "n_copies", "res")
_RES_AUX = ("nto", "nsh", "nrt", "wst", "nfl", "fcz", "ratt", "ndn")


def _jax_scan(host, static, key):
    """The JAX oracle on the port's numpy bucket in float64, through the
    JAX package's own compiled ``(init, scan)`` pair, at the port's strict
    step budget (a scan past its last event changes nothing): its initial
    (clk, ctr), rows (start and finish resolved last dispatch first, the
    frozen prio and node) and the summary."""
    B, n1 = host["t"].shape
    assert static["horizon"] == jfp.DEFAULT_FC_HORIZON
    xtra = static["n_steps"] - 2 * key[1]
    assert xtra >= key[10]
    init_c, scan_c = jfp._scan_runner((*key[:10], xtra, B))
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in host.items()}
        clk, ctr = init_c(arrs)
        # copies first: the scan donates the planes
        clk0, ctr0 = np.array(clk), np.array(ctr)
        out = jax.tree_util.tree_map(np.asarray, scan_c(clk, ctr, arrs))
    (j_s, es_s, fs_s, _, _), summ = out
    rows = [np.zeros((B, n1)), np.zeros((B, n1)),
            np.asarray(summ["prio"]), np.asarray(summ["node"])]
    for b in range(B):
        for r, v in zip(rows, (es_s, fs_s)):
            r[b, j_s[b]] = v[b]
    return clk0, ctr0, rows, summ


def _torch_scan(host, clk, ctr, static):
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    r0 = tops.RES_REF_LAUNCHES
    out = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)), tens, **static)
    assert tops.RES_REF_LAUNCHES == r0 + 1
    return [o.numpy() for o in out[:4]], {k: v.numpy()
                                          for k, v in out[4].items()}


@pytest.fixture(scope="module")
def scans():
    """The two buckets (SEPT: the storm, the home balancer, the absolute
    timeout, one node; FC) through the JAX oracle and the plain version,
    computed once: each case's cells' rows, summaries and prepared cells."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        for cases in (_SEPT_CASES, _FC_CASES):
            pairs, spans = [], {}
            for name, cells in cases.items():
                new = (_storm_pairs() if cells is None
                       else [_pair(c) for c in cells])
                spans[name] = range(len(pairs), len(pairs) + len(new))
                pairs += new
            host, static, key, prepared = _bucket(pairs)
            clk, ctr, ref, summ = _jax_scan(host, static, key)
            got, aux = _torch_scan(host, clk, ctr, static)
            for name, span in spans.items():
                out[name] = (static, key, [prepared[b] for b in span],
                             list(span), ref, summ, got, aux)
    return out


@pytest.mark.parametrize("name", [*_SEPT_CASES, *_FC_CASES])
def test_plain_res_scan_bit_identical_to_jax(scans, name):
    static, key, prepared, span, ref, summ, got, aux = scans[name]
    assert static["freeze"] and static["res"] and not static["hedge"]
    assert key[1] == 256
    assert static["fc_push"] == (name == "fc-backoff-shed")
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        np.testing.assert_array_equal(a[span, :n], b[span, :n],
                                      err_msg=f"{what} diverged ({name})")
    assert set(aux) == set(_RES_AUX) | {"stepc"}
    for k in _RES_AUX:
        np.testing.assert_array_equal(np.asarray(summ[k])[span],
                                      aux[k][span],
                                      err_msg=f"{k} diverged ({name})")
    n_real = np.array([len(c.feats.t) for c in prepared])
    assert (aux["ndn"][span] == n_real).all()
    # one step an event: arrivals, completions, timeouts, re-arrivals
    done = n_real - aux["nfl"][span].sum(1)
    assert (aux["stepc"][span] == n_real + done + aux["nto"][span]
            + aux["nrt"][span]).all()
    assert (aux["nto"][span] > 0).all()
    if name == "storm":
        # the behaviours' counts, seed 1000: no retries time out 54 calls;
        # naive retries with shedding shed 425 and retry 393
        assert aux["nto"][span][0] == 54 and aux["nrt"][span][0] == 0
        assert (aux["nsh"][span][3], aux["nrt"][span][3]) == (425, 393)
    if name == "absolute":
        assert aux["wst"][span][0] > 0 and aux["nfl"][span].any()
    if name == "fc-backoff-shed":
        assert (aux["nsh"][span] > 0).all() and (aux["nrt"][span] > 0).all()


def test_planes_equal_jax():
    pairs = [_pair(c) for c in _SEPT_CASES["home"]]
    host, static, key, _ = _bucket(pairs)
    assert static["res"]
    with jax.enable_x64():
        jclk, jctr = jax.jit(jax.vmap(partial(
            jfp._make_planes, **{k: static[k] for k in _SEG})))(
                {k: jnp.asarray(v) for k, v in host.items()})
        jclk, jctr = np.asarray(jclk), np.asarray(jctr)
        jl = jfp._carry_layout(
            {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
             for k, v in host.items()}, **{k: static[k] for k in _SEG})
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    seg = {k: static[k] for k in _SEG[3:]}
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
    assert {"zring", "qsq", "stp", "sst"} <= {k for k, *_ in
                                             tl.fparts + tl.iparts}


# -- sweep rows ---------------------------------------------------------------
def _readme_grid():
    """A 1-seed cut of the README's resilience grid (SEPT and FC on 2 x 4
    push, timeout None / 3x, retries None / 3, shedding None / 2.0: 16
    cells, 2 of them with no policy), and a cell where a 10 ms absolute
    timeout fails every call."""
    spec = jsweep.SweepSpec(policies=("sept", "fc"), nodes=(2,), cores=(4,),
                            assignments=("push",),
                            timeout_multiples=(None, 3.0),
                            retry_attempts=(None, 3),
                            shed_thresholds=(None, 2.0), seeds=1)
    cells = spec.cells()
    cells.append(jsweep.SweepCell(policy="sept", nodes=2, cores=4,
                                  assignment="push", timeout_multiple=3.0,
                                  timeout_absolute_s=0.01))
    return cells


@pytest.fixture(scope="module")
def grid_rows():
    """The grid's rows from the JAX package and the port, metrics-only,
    computed once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        jcells = _readme_grid()
        want = jsweep.run_cells_scan(jcells, metrics_only=True)
        tops.reset_launches()
        got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                    metrics_only=True, device="cpu")
        return jcells, want, got, tops.launches()


def test_bucket_keys_equal_jax():
    """Every cell of the grid (and the storm) has the JAX package's bucket
    key, budgets and FC ring size."""
    for c in _readme_grid():
        t, j = _pair(_port_cell(c))
        assert t.bucket() == j.bucket(), c.label()
        assert t.res == j.res
        assert (t.res_budget(), t.res_budget_full()) == \
            (j.res_budget(), j.res_budget_full())
    for t, j in _storm_pairs():
        assert t.bucket() == j.bucket()


def test_run_cells_scan_rows_equal_jax(grid_rows):
    jcells, want, got, counts = grid_rows
    assert len(jcells) == 17
    assert counts["event_step_res"]["plain"] > 0
    assert not any(v["kernel"] for v in counts.values())
    for c, w, g in zip(jcells, want, got):
        assert w == g, (c.label(), {k: (w.get(k), g.get(k)) for k in w
                                    if w.get(k) != g.get(k)})
    resil = [g for c, g in zip(jcells, got)
             if jsweep._cell_resilience(c) is not None]
    assert len(resil) == 15 and all("goodput" in g for g in resil)
    assert any(g["shed"] > 0 for g in resil)
    assert any(g["retries_issued"] > 0 for g in resil)
    # the all-failed row: every call timed out, zeros beside the counts
    last = got[-1]
    assert last["n"] == 0.0 and last["R_avg"] == 0.0
    assert last["timed_out"] == last["n_failed"] == 264.0


def test_written_back_rows_equal_jax(grid_rows):
    """The grid's cells with no policy and the all-failed cell, written
    back (``run_cells_scan`` without ``metrics_only``): their rows equal
    the JAX package's."""
    jcells, want, _, _ = grid_rows
    idx = [i for i, c in enumerate(jcells)
           if jsweep._cell_resilience(c) is None] + [len(jcells) - 1]
    assert len(idx) == 3
    got = tsweep.run_cells_scan([_port_cell(jcells[i]) for i in idx],
                                device="cpu")
    for i, g in zip(idx, got):
        assert g == want[i], jcells[i].label()


def test_write_back_equals_jax(grid_rows):
    """The grid's four SEPT cells with retries, through both packages'
    ``simulate_cluster_cells_scan`` (one bucket each; the JAX package's
    compile is the grid's): each request's start, finish, response,
    priority, node, failure and attempts, and the counters, equal the JAX
    package's, and the rows folded from them equal the grid's."""
    jcells, want, _, _ = grid_rows
    idx = [i for i, c in enumerate(jcells)
           if c.policy == "sept" and c.retry_attempts]
    assert len(idx) == 4
    batches, reqs = [], []
    for fp, sw, cs in ((jfp, jsweep, [jcells[i] for i in idx]),
                       (tfp, tsweep, [_port_cell(jcells[i]) for i in idx])):
        rs = [sw.make_workload(c) for c in cs]
        reqs.append(rs)
        batches.append([(r, 2, 4, "sept", "push", "least_loaded", None, None,
                         None, True, sw._cell_resilience(c))
                        for r, c in zip(rs, cs)])
    theirs = jfp.simulate_cluster_cells_scan(batches[0])
    mine = tfp.simulate_cluster_cells_scan(batches[1], device="cpu")
    n_failed = 0
    for i, w, g, jr, tr in zip(idx, theirs, mine, *reqs):
        for k in ("timed_out", "shed", "retries_issued", "wasted_work"):
            assert getattr(g, k) == getattr(w, k), k
        for a, b in zip(jr, tr):
            assert (a.start, a.finish, a.c, a.priority, a.node, a.attempts,
                    a.failed) == (b.start, b.finish, b.c, b.priority,
                                  b.node, b.attempts, b.failed)
            n_failed += b.failed is not None
        assert tsweep._cell_metrics(_port_cell(jcells[i]), g) == want[i]
    assert n_failed > 0 and any(g.shed > 0 for g in mine)
    assert any(g.retries_issued > 0 for g in mine)


# -- against the reference Cluster -------------------------------------------
@pytest.fixture
def no_alias(monkeypatch):
    monkeypatch.delattr(jax.experimental, "enable_x64", raising=False)


_REF_SPECS = {
    "timeout": jres.ResilienceSpec(
        timeout=jres.TimeoutSpec(multiple=3.0, floor_s=2.0)),
    "backoff": jres.ResilienceSpec(
        timeout=jres.TimeoutSpec(multiple=3.0, floor_s=2.0),
        retry=jres.RetryPolicy(max_attempts=3, mode="backoff",
                               base_delay_s=0.5, cap_delay_s=4.0,
                               jitter=0.5)),
    "immediate+shed": jres.ResilienceSpec(
        timeout=jres.TimeoutSpec(multiple=3.0, floor_s=2.0),
        retry=jres.RetryPolicy(max_attempts=2, mode="immediate"),
        admission=jres.AdmissionPolicy(threshold_s=1.0)),
}


@pytest.mark.parametrize("policy", ["sept", "fc"])
@pytest.mark.parametrize("spec", list(_REF_SPECS))
def test_counts_failures_and_attempts_exact_against_the_reference(
        no_alias, policy, spec):
    """As tests/test_resilience.py::_assert_exact_parity holds the JAX
    scan: the counters, the failed calls (by position) with their causes
    and each call's attempts equal the reference ``Cluster``'s."""
    kw = dict(cores=8, intensity=10, seed=7, kind="poisson",
              duration_s=30.0)
    jspec = _REF_SPECS[spec]
    jreqs, treqs = j_trace_burst(**kw), t_trace_burst(**kw)
    ref = simulate_cluster(jreqs, nodes=2, cores_per_node=4,
                           policy=policy, assignment="push", warm=True,
                           resilience=jspec, backend="reference")
    got = tfp.simulate_cluster_scan(treqs, nodes=2, cores_per_node=4,
                                    policy=policy, assignment="push",
                                    resilience=_port_spec(jspec),
                                    device="cpu")
    for k in ("timed_out", "shed", "retries_issued"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.timed_out > 0
    # the calls by their place in the burst (the two packages number
    # requests apart)
    pos = {r.id: i for i, r in enumerate(jreqs)}
    assert got.requests is treqs
    assert ({(pos[r.id], r.failed) for r in ref.requests if r.c is None}
            == {(i, r.failed) for i, r in enumerate(treqs) if r.c is None})
    assert {pos[r.id]: r.attempts for r in ref.requests} == \
        {i: r.attempts for i, r in enumerate(treqs)}


def test_chip_smoke_storm_and_grid_are_the_benchmarks():
    """``chip_smoke.py``'s phase 3g paths are the JAX package's: the
    storm's 60 cells as ``storm_rows`` builds them (bursts, fleet, policy
    and each behaviour's lifecycle, 10 seeds) and the README grid's 80
    cells."""
    import chip_smoke

    cells, items = chip_smoke.storm_items(range(10))
    assert len(items) == 60
    assert [c[:3] for c in cells[::10]] == [tuple(b) for b in
                                            STORM_SCENARIOS]
    for (_, mode, shed, s), it in zip(cells, items):
        assert it[1:10] == (2, 4, "sept", "push", "least_loaded", None,
                            None, None, True)
        assert it[10] == _port_spec(_storm_resilience(mode, shed))
    jb = j_trace_burst(cores=8, intensity=14, seed=1003, kind="ramp",
                       duration_s=60.0, burst_factor=6.0,
                       burst_start_frac=1 / 3, burst_end_frac=1 / 2)
    assert cells[3][3] == 3
    assert [(q.fn, q.r, q.p_true) for q in items[3][0]] == \
        [(q.fn, q.r, q.p_true) for q in jb]
    grid = jsweep.SweepSpec(policies=("sept", "fc"), nodes=(2,), cores=(4,),
                            assignments=("push",),
                            timeout_multiples=(None, 3.0),
                            retry_attempts=(None, 3),
                            shed_thresholds=(None, 2.0), seeds=5).cells()
    assert len(grid) == 80
    assert [_port_cell(c) for c in grid] == chip_smoke.res_grid_cells()


# -- the resilience module -----------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(seq=st.integers(0, 200000), attempt=st.integers(1, 16),
       base=st.floats(0.0, 10.0), cap=st.floats(0.0, 20.0),
       jitter=st.floats(0.0, 1.0),
       mode=st.sampled_from(["backoff", "immediate"]))
def test_delay_and_jitter_equal_jax(seq, attempt, base, cap, jitter, mode):
    kw = dict(max_attempts=16, mode=mode, base_delay_s=base,
              cap_delay_s=cap, jitter=jitter)
    assert tres.retry_jitter_u(seq, attempt) == \
        jres.retry_jitter_u(seq, attempt)
    assert tres.RetryPolicy(**kw).delay(seq, attempt) == \
        jres.RetryPolicy(**kw).delay(seq, attempt)


@settings(max_examples=60, deadline=None)
@given(mult=st.floats(-1.0, 8.0), floor=st.floats(-1.0, 4.0),
       absolute=st.sampled_from([None, -1.0, 0.0, 0.01, 2.5,
                                 float("inf")]),
       attempts=st.integers(0, 18), mode=st.sampled_from(
           ["backoff", "immediate", "linear"]),
       base=st.floats(-1.0, 2.0), jitter=st.floats(-0.5, 1.5),
       on=st.sampled_from([("timeout",), ("shed", "kill"), ("bogus",)]),
       thr=st.floats(-1.0, 4.0))
def test_specs_arrays_and_validation_equal_jax(mult, floor, absolute,
                                               attempts, mode, base, jitter,
                                               on, thr):
    """The same arguments build in both packages or raise ``ValueError``
    in both, and built specs have equal tensor forms and estimates."""
    def build(mod):
        out = []
        for cls, kw in ((mod.TimeoutSpec, dict(multiple=mult, floor_s=floor,
                                               absolute_s=absolute)),
                        (mod.RetryPolicy, dict(max_attempts=attempts,
                                               mode=mode, base_delay_s=base,
                                               jitter=jitter, retry_on=on)),
                        (mod.AdmissionPolicy, dict(threshold_s=thr))):
            try:
                out.append(cls(**kw))
            except ValueError:
                out.append(None)
        return out

    mine, theirs = build(tres), build(jres)
    assert [m is None for m in mine] == [t is None for t in theirs]
    spec_t = tres.ResilienceSpec(*mine)
    spec_j = jres.ResilienceSpec(*theirs)
    assert spec_t.is_null == spec_j.is_null
    assert spec_t.max_attempts == spec_j.max_attempts
    for a, b in zip(spec_t.arrays(), spec_j.arrays()):
        np.testing.assert_array_equal(a, b)
    if mine[0] is not None:
        assert mine[0].deadline(3.0, 0.7) == theirs[0].deadline(3.0, 0.7)
    if mine[2] is not None:
        assert mine[2].shed(5.0, 2) == theirs[2].shed(5.0, 2)
    assert (tres.ResilienceSpec.from_any(mine[0]) is None) == \
        (jres.ResilienceSpec.from_any(theirs[0]) is None)


def test_labels_and_cells_equal_jax():
    """``SweepSpec.cells()`` with the lifecycle axes: the JAX package's
    cells in its order (the retry mode collapsed on cells without retries,
    the duplicates dropped), with its labels and lifecycle."""
    kw = dict(policies=("sept", "fc"), nodes=(2,), cores=(4,),
              assignments=("push",), intensities=(20, 40),
              timeout_multiples=(None, 3.0), retry_attempts=(None, 3),
              retry_modes=("backoff", "immediate"),
              shed_thresholds=(None, 2.0), timeout_floor_s=2.0,
              timeout_absolute_s=None, retry_base_s=0.25, retry_cap_s=4.0,
              retry_jitter=0.3, retry_on=("timeout",), seeds=2)
    mine = tsweep.SweepSpec(**kw).cells()
    theirs = jsweep.SweepSpec(**kw).cells()
    assert len(mine) == len(theirs) == 2 * 2 * 2 * 3 * 2 * 2
    for a, b in zip(mine, theirs):
        assert a == _port_cell(b)
        assert a.label() == b.label()
        assert tsweep._cell_resilience(a) == _port_spec(
            jsweep._cell_resilience(b))
    absolute = dict(kw, timeout_absolute_s=0.5)
    for a, b in zip(tsweep.SweepSpec(**absolute).cells(),
                    jsweep.SweepSpec(**absolute).cells()):
        assert a.label() == b.label()
    assert any("to0.5s" in c.label()
               for c in tsweep.SweepSpec(**absolute).cells())


# -- step budgets -------------------------------------------------------------
def test_a_res_bucket_scans_once_at_the_strict_budget(monkeypatch):
    """One scan a chunk, at the cell's strict step budget; four times that
    budget gives the same rows and counts, since the scan stops at its
    last event."""
    cell = _pair(_cell("sept", 2, 4, 6, 0, timeout_multiple=2.0,
                       retry_attempts=3, shed_threshold=1.0))[0]
    key = cell.bucket()
    calls = []
    real = tops.event_step

    def counted(*a, **kw):
        calls.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(tfp._kops, "event_step", counted)
    want = tfp._run_scan_bucket(key, [cell], torch.device("cpu"))[0]
    assert calls == [2 * key[1] + tfp._pow2(cell.res_budget_full())]
    assert want[4]["timed_out"] > 0
    full = tfp._ScanCell.res_budget_full
    monkeypatch.setattr(tfp._ScanCell, "res_budget_full",
                        lambda self: 4 * full(self))
    got = tfp._run_scan_bucket(key, [cell], torch.device("cpu"))[0]
    assert calls[1] > calls[0]
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(a, b)
    for k, v in want[4].items():
        np.testing.assert_array_equal(v, got[4][k])


def test_a_short_strict_budget_raises(monkeypatch):
    cell = _pair(_cell("sept", 2, 4, 6, 0, timeout_multiple=2.0,
                       retry_attempts=3))[0]
    real = tfp._bucket_static
    monkeypatch.setattr(tfp, "_bucket_static", lambda k, cs: {
        **real(k, cs), "n_steps": len(cell.feats.t)})
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tfp._run_scan_bucket(cell.bucket(), [cell], torch.device("cpu"))


# -- eligibility --------------------------------------------------------------
def test_eligibility_answers_as_jax():
    """Resilience under push, warm, on a fixed uniform fleet: taken;
    under pull, cold, with dynamics, hedging or node speeds: refused, as
    the JAX package's capability matrix and ``cluster_scan_eligible``
    answer; a one-node resilience cell is a cluster cell."""
    res = dict(timeout_multiple=3.0, retry_attempts=3)
    cases = [_cell("sept", 2, 4, 12, 0, **res),
             _cell("fc", 1, 4, 12, 0, shed_threshold=2.0),
             _cell("sept", 2, 4, 12, 0, lb="home", **res),
             _cell("sept", 2, 4, 12, 0, assignment="pull", **res),
             _cell("sept", 1, 4, 12, 0, assignment="pull", **res),
             _cell("sept", 2, 40, 12, 0, warm=False, **res),
             _cell("sept", 2, 4, 12, 0, fail_at=5.0, **res),
             _cell("sept", 2, 4, 12, 0, autoscale=True, **res),
             _cell("sept", 2, 4, 12, 0, hedge_multiple=2.0, **res),
             _cell("sept", 2, 4, 12, 0, degrade=((0, 1.0, 9.0, 3.0),),
                   **res)]
    reqs = tsweep.make_workload(cases[0])
    jreqs = jsweep.make_workload(_jax_cell(cases[0]))
    answers = []
    for c in cases:
        jc = _jax_cell(c)
        assert tsweep._cluster_shaped(c)
        want = (jsweep._cluster_scan_capable(jc)
                and jsweep._cluster_scan_ok(jc, jreqs, c.policy))
        got = tsweep._cluster_scan_capable(c) and tfp.cluster_scan_eligible(
            reqs, c.nodes, c.cores, c.policy, assignment=c.assignment,
            lb=c.lb, warm=c.warm, dynamics=tsweep._cell_dynamics(c),
            profile=tsweep._cell_profile(c),
            hedging=tsweep._cell_hedging(c),
            resilience=tsweep._cell_resilience(c))
        assert got == want, c.label()
        answers.append(got)
    assert answers == [True] * 3 + [False] * 7
    with pytest.raises(ValueError, match="not scan-eligible"):
        tsweep.run_cells_scan([cases[3]], device="cpu")


def test_metrics_only_simulate_on_a_res_cell_raises():
    c = _cell("sept", 2, 4, 12, 0, timeout_multiple=3.0)
    item = (tsweep.make_workload(c), 2, 4, "sept", "push", "least_loaded",
            None, None, None, True, tsweep._cell_resilience(c))
    with pytest.raises(ValueError, match="metrics_only is not supported"):
        tfp.simulate_cluster_cells_scan([item], metrics_only=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="cluster scan covers"):
        tfp.simulate_cluster_cells_scan(
            [(*item[:4], "pull", *item[5:])], device="cpu")
