"""The port's cold-start regime on pull (``warm=False``: no warm-up, every
miss served from the prewarm pool) against the JAX package, on the CPU.

The JAX package scans ``cold`` buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0 unless a line says otherwise):

* the ``cold`` carry planes have the JAX package's layout and bytes;
* the plain ``event_step`` with ``cold`` (``repro_torch.kernels.ops`` on
  CPU tensors) gives rows ``[:n]`` of start, finish, prio and node, the
  cold starts, the evictions and every row's cold-start flag bit-identical
  to the JAX oracle (``_scan_cell_kernel``'s float64 ``cold`` branch) on
  buckets filled from real bursts: each of the five policies, cold with a
  failure, with the autoscaler, with a slowed node, with all three, and a
  carry whose releases hit the ``cores`` bound (evictions);
* the bucket keys equal the JAX package's; ``run_cells_scan`` rows, with
  ``metrics_only`` and written back (each request's ``cold_start`` too),
  equal the JAX package's on the cold matrix's pull half at intensity 18;
* against the reference ``Cluster`` (no scan, no alias): ``cold`` and the
  ``CROSS_CHECK_EXACT`` counters equal, the ``CROSS_CHECK_KEYS`` within
  ``CLUSTER_XCHECK_RTOL``;
* ``scan_eligible`` and ``cluster_scan_eligible`` answer as the JAX
  package's, the trace replay's cells included (never eligible: 32
  functions do not fit a node warm); cold push and single-node cells run
  and equal the JAX package's results (``tests/test_torch_freeze64_
  scan.py`` holds that regime bit for bit).

The CUDA kernel is held against the plain version in
``tests/test_torch_cold_gpu.py``, on the card.
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
from repro.core import sweep as jsweep
from repro.kernels import ops as jops
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import sweep as tsweep
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.engine_bench import matrix_specs  # noqa: E402
from benchmarks.trace_replay import spec as trace_spec  # noqa: E402

POLICIES = ("fifo", "sept", "eect", "rect", "fc")


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _port_cell(jcell) -> tsweep.SweepCell:
    return tsweep.SweepCell(**{f.name: getattr(jcell, f.name)
                               for f in dataclasses.fields(tsweep.SweepCell)})


def _cell(policy="fc", nodes=2, cores=4, intensity=12, seed=0, **kw):
    return tsweep.SweepCell(policy=policy, nodes=nodes, cores=cores,
                            intensity=intensity, seed=seed, warm=False, **kw)


def _bucket(cells):
    """The port's bucket of ``cells`` (cold pull SweepCells) under the
    widest key, each cell's key checked against the JAX package's: host
    inputs, static arguments, key."""
    prepared = []
    for c in cells:
        jc = jsweep.SweepCell(**dataclasses.asdict(c))
        pair = []
        for fp, sw, cell in ((tfp, tsweep, c), (jfp, jsweep, jc)):
            reqs = sw.make_workload(cell)
            pair.append(fp._ScanCell(
                requests=reqs, feats=fp._arrival_features(reqs),
                cores=c.cores, nodes=c.nodes, policy=c.policy,
                assignment="pull", warm=False,
                dynamics=sw._cell_dynamics(cell),
                profile=sw._cell_profile(cell)))
        assert pair[0].bucket() == pair[1].bucket(), c.label()
        prepared.append(pair[0])
    keys = {c.bucket() for c in prepared}
    assert len({k[0] for k in keys}) == 1
    key = tuple(max(col) for col in zip(*keys))
    return tfp._fill_bucket(key, prepared), tfp._scan_static(key), key


def _jax_scan(host, static, key, preset=None):
    """The JAX oracle on the port's numpy bucket in float64: its initial
    (clk, ctr) (``preset`` edits the carry dict first), rows (start,
    finish, prio, node; a ``dyn`` bucket's step records resolved last
    dispatch first) and the cold summary (ncold, nevt, coldq)."""
    inp = dict(host)
    B, n1 = host["t"].shape
    inp.update(cnt=np.zeros((B, n1)), home0=np.zeros((B, n1), np.int32),
               route=np.zeros(B, np.int32))
    st = {k: static[k] for k in ("n_nodes", "n_slots", "window",
                                 "freeze", "fc_push", "dyn", "het",
                                 "hedge", "cold", "dup", "fc_ring")}
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in inp.items()}
        clk, ctr = jax.vmap(partial(jfp._make_planes, n_copies=1,
                                    **st))(arrs)
        if preset is not None:
            layout = jfp._carry_layout(
                {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                 for k, v in arrs.items()}, n_copies=1, **st)
            carry = jax.vmap(layout.unpack)(clk, ctr)
            carry = {k: np.array(v) for k, v in carry.items()}
            preset(carry)
            clk, ctr = jax.vmap(layout.pack)(
                {k: jnp.asarray(v) for k, v in carry.items()})
        out = jops.event_step(clk, ctr, arrs, force="ref", n_copies=1,
                              n_ep=key[8], use_fc=static["use_fc"],
                              horizon=static["horizon"],
                              n_steps=static["n_steps"], **st)
        out = jax.tree_util.tree_map(np.asarray, out)
    if not static["dyn"]:
        rows, summ = list(out[:4]), out[4]
    else:
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


def _preset_full_pools(carry):
    """Every (node, function) pool starts with cores + 1 free containers,
    so each release finds it full and evicts.  From an empty pool the
    regime never evicts: a node's containers of a function never outnumber
    its slots, so a release finds at most cores - 1 free."""
    carry["freec"][...] = 5


# (name, cells, carry preset): buckets of real-burst cells (4 cores a node)
CASES = [
    *[(f"cold-{p}", [_cell(p, seed=s) for s in range(2)], None)
      for p in POLICIES],
    ("cold+fail", [_cell("sept", 3, 4, 12, s, fail_at=8.0)
                   for s in range(2)], None),
    ("cold+autoscale", [_cell("fc", 1, 4, 30, s, workload_cores=8,
                              autoscale=True, provision_delay=5.0,
                              scale_up=1.0, max_nodes=3) for s in range(2)],
     None),
    ("cold+slow-node", [_cell(p, 2, 4, 12, s, node_speeds=(0.7, 1.0),
                              degrade=((0, 1.0, 300.0, 5.0),))
                        for s, p in enumerate(("fc", "fc"))], None),
    ("cold+fail+autoscale+slow", [
        _cell(p, 3, 4, 16, s, workload_cores=12, fail_spec=((0, 8.0),),
              degrade=((1, 2.0, 40.0, 3.0),), autoscale=True,
              provision_delay=5.0, scale_up=1.0, max_nodes=4)
        for s, p in enumerate(("sept", "eect"))], None),
    ("cold+evictions", [_cell(p, seed=s) for s, p in
                        enumerate(("sept", "rect"))], _preset_full_pools),
]


@pytest.mark.parametrize("name,cells,preset", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_cold_scan_bit_identical_to_jax(name, cells, preset):
    host, static, key = _bucket(cells)
    assert static["cold"] and host["t"].dtype == np.float64
    clk, ctr, ref, summ = _jax_scan(host, static, key, preset)
    got, aux = _torch_scan(host, clk, ctr, static)
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{what} diverged ({name})")
    for k in ("ncold", "nevt", "coldq"):
        np.testing.assert_array_equal(np.asarray(summ[k]), aux[k],
                                      err_msg=f"{k} diverged ({name})")
    nc = len(cells)
    # full pools: every dispatch is a warm hit
    assert (aux["ncold"][:nc] > 0).all() == (preset is None)
    # a call's flag is its last dispatch's: the flags count the cold
    # starts unless a kill lost a call after it started cold
    if not static["dyn"]:
        assert (aux["coldq"][:nc].sum(1) == aux["ncold"][:nc]).all()
    assert (aux["nevt"] > 0).any() == (preset is not None)
    if static["dyn"]:
        for k in ("nfail", "ndone", "prov"):
            np.testing.assert_array_equal(np.asarray(summ[k]), aux[k])
        assert (aux["ndone"][:nc] == host["nreq"][:nc]).all()
    if "fail" in name:
        assert aux["nfail"][:nc].sum() > 0
    if "autoscale" in name:
        assert (aux["prov"][:nc] > host["nodes"][:nc]).any()


def test_cold_planes_equal_jax():
    host, static, key = _bucket(CASES[0][1])
    jclk, jctr, _, _ = _jax_scan(host, dict(static, n_steps=0), key)
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    clk, ctr = planes.make_planes(tens, n_nodes=static["n_nodes"],
                                  n_slots=static["n_slots"],
                                  window=static["window"], cold=True)
    assert clk.dtype == torch.float64 and ctr.dtype == torch.int32
    assert clk.numpy().tobytes() == jclk.tobytes()
    np.testing.assert_array_equal(ctr.numpy(), jctr)
    with jax.enable_x64():
        jl = jfp._carry_layout(
            {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
             for k, v in dict(host, cnt=host["t"], home0=host["fnid"],
                              route=host["cores"]).items()},
            n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            window=static["window"], freeze=False, fc_push=False, dyn=False,
            het=False, hedge=False, cold=True, dup=False, n_copies=1,
            fc_ring=1)
    tl = planes.carry_layout(n_nodes=static["n_nodes"],
                             n_slots=static["n_slots"],
                             window=static["window"],
                             n_fns=host["ring0"].shape[2],
                             n1=host["t"].shape[1], cold=True)
    assert tl.fparts == jl.fparts and tl.iparts == jl.iparts


# -- sweep rows ---------------------------------------------------------------
def _cold_pull_18():
    """The cold matrix's pull half at intensity 18, seed 0: FC and SEPT on
    4 x 8 cores, a 32-core burst (638 calls)."""
    cold = dict(matrix_specs())["cold"]
    return [c for c in cold.cells() if c.assignment == "pull"
            and c.intensity == 18 and c.seed == 0]


@pytest.mark.parametrize("metrics_only", [True, False])
def test_run_cells_scan_rows_equal_jax(metrics_only):
    jcells = _cold_pull_18()
    assert len(jcells) == 2 and not any(c.warm for c in jcells)
    want = jsweep.run_cells_scan(jcells, metrics_only=metrics_only)
    r0 = tops.DYN_REF_LAUNCHES
    got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                metrics_only=metrics_only, device="cpu")
    assert tops.DYN_REF_LAUNCHES > r0
    for c, w, g in zip(jcells, want, got):
        assert w == g, (c.label(), {k: (w[k], g[k]) for k in w
                                    if w[k] != g[k]})
        assert g["cold"] > 0


def test_write_back_equals_jax():
    """Each request's cold_start, start, finish and node, and the cold
    starts and evictions, equal the JAX package's written-back result."""
    jc = _cold_pull_18()[1]
    cell = _port_cell(jc)
    jr, tr = jsweep.make_workload(jc), tsweep.make_workload(cell)
    want = jfp.simulate_cluster_scan(jr, 4, 8, jc.policy, warm=False)
    got = tfp.simulate_cluster_scan(tr, 4, 8, cell.policy, warm=False,
                                    device="cpu")
    assert got.cold_starts == want.cold_starts > 0
    assert got.evictions == want.evictions
    for a, b in zip(jr, tr):
        assert (a.start, a.finish, a.c, a.priority, a.node, a.cold_start) \
            == (b.start, b.finish, b.c, b.priority, b.node, b.cold_start)
    assert sum(q.cold_start for q in tr) == got.cold_starts


# -- against the reference Cluster -------------------------------------------
@pytest.fixture
def no_alias(monkeypatch):
    monkeypatch.delattr(jax.experimental, "enable_x64", raising=False)


REF_CELLS = [_cell("sept", 2, 4, 12, s) for s in range(2)] + [
    _cell("fc", 2, 4, 12, 0), _cell("fifo", 3, 4, 12, 1, fail_at=8.0)]


@pytest.mark.parametrize("cell", REF_CELLS,
                         ids=lambda c: f"{c.label()}-s{c.seed}")
def test_counts_exact_and_metrics_close_to_the_reference(no_alias, cell):
    ref = jsweep.run_cell(dataclasses.replace(
        jsweep.SweepCell(**dataclasses.asdict(cell)), backend="reference"))
    got = tsweep.run_cells_scan([cell], device="cpu")[0]
    assert got["cold"] == ref["cold"] > 0
    for k in jsweep.CROSS_CHECK_EXACT:
        if k in ref and k in got:
            assert got[k] == ref[k], k
    for k in jsweep.CROSS_CHECK_KEYS:
        if k in ref:
            assert abs(got[k] - ref[k]) <= jsweep.CLUSTER_XCHECK_RTOL * max(
                abs(ref[k]), abs(got[k]), 1e-9), (k, got[k], ref[k])


# -- eligibility, refusals ----------------------------------------------------
def test_eligibility_answers_as_jax():
    """The JAX package's own cases (tests/test_fastpath.py, tests/
    test_scan_cluster.py) and the cold matrix's sizes."""
    from repro.core.workload import generate_burst as jburst
    from repro_torch.core.workload import generate_burst as tburst

    single = [(dict(cores=10, intensity=20, seed=0),
               [dict(cores=10), dict(cores=20), dict(cores=10, warm=False),
                dict(cores=10, warm=False, memory_mb=512),
                dict(cores=10, mode="baseline")])]
    for bk, cases in single:
        jreqs, treqs = jburst(**bk), tburst(**bk)
        for kw in cases:
            assert (tfp.scan_eligible(treqs, policy="sept", **kw)
                    == jfp.scan_eligible(jreqs, policy="sept", **kw)), kw
    jreqs, treqs = (jburst(cores=12, intensity=15, seed=0),
                    tburst(cores=12, intensity=15, seed=0))
    cases = [(2, 18, {}), (2, 6, dict(warm=False)),
             (2, 6, dict(warm=False, memory_mb=512)),
             (4, 8, dict(warm=False)), (2, 40, dict(warm=False)),
             (2, 6, dict(warm=False, assignment="push", lb="home")),
             (2, 6, dict(warm=False, dynamics="fail"))]
    for nodes, cores, kw in cases:
        tkw, jkw = dict(kw), dict(kw)
        if kw.get("dynamics") == "fail":
            tkw["dynamics"] = ClusterDynamics(fail=((0, 5.0),))
            jkw["dynamics"] = jcluster.ClusterDynamics(fail=((0, 5.0),))
        a = tfp.cluster_scan_eligible(treqs, nodes, cores, "fc", **tkw)
        b = jfp.cluster_scan_eligible(jreqs, nodes, cores, "fc", **jkw)
        assert a == b, (nodes, cores, kw)
    assert tfp.cluster_scan_eligible(treqs, 2, 6, "fc", warm=False)
    assert not tfp.cluster_scan_eligible(treqs, 2, 40, "fc", warm=False)


def test_trace_replay_cells_are_ineligible_as_in_jax():
    """benchmarks/trace_replay.py's cells (32 functions on 10 cores): 10
    warm containers of each do not fit the node, so no cell is eligible,
    in the JAX package as in the port."""
    jcells = trace_spec().cells()
    assert len(jcells) == 18
    reqs = {}
    for jc in jcells:
        c = _port_cell(jc)
        key = tsweep._workload_key(c)
        if key not in reqs:
            reqs[key] = (jsweep.make_workload(jc), tsweep.make_workload(c))
        jr, tr = reqs[key]
        assert len({q.fn for q in tr}) == 32
        for warm in (True, False):
            want = jfp.scan_eligible(jr, jc.cores, jc.policy, warm=warm)
            got = tfp.scan_eligible(tr, c.cores, c.policy, warm=warm)
            assert got == want
            assert not got or not warm
    # as run: warm, none eligible
    assert not any(tfp.scan_eligible(reqs[tsweep._workload_key(
        _port_cell(jc))][1], jc.cores, jc.policy) for jc in jcells)


def test_cold_push_and_single_node_raise_not_implemented():
    """Cold push and single-node cells, which raised before the float64
    frozen-priority scan, now run and equal the JAX package's results
    (``tests/test_torch_freeze64_scan.py`` holds them bit for bit)."""
    c = _cell("fc", 2, 4, 12, 0)
    jc = jsweep.SweepCell(**dataclasses.asdict(c))
    reqs, jreqs = tsweep.make_workload(c), jsweep.make_workload(jc)
    got = tfp.simulate_cluster_scan(reqs, 2, 4, "fc", assignment="push",
                                    warm=False, device="cpu")
    want = jfp.simulate_cluster_scan(jreqs, 2, 4, "fc", assignment="push",
                                     warm=False)
    assert (got.cold_starts, got.evictions) == (want.cold_starts,
                                                want.evictions)
    assert [(q.finish, q.cold_start) for q in reqs] == \
        [(q.finish, q.cold_start) for q in jreqs]
    got = tfp.simulate_cells_scan([(reqs, 4, "sept", False)],
                                  metrics_only=True, device="cpu")[0]
    want = jfp.simulate_cells_scan([(jreqs, 4, "sept", False)],
                                   metrics_only=True)[0]
    assert got.cold_starts == want.cold_starts > 0
    np.testing.assert_array_equal(got.resp, want.resp)
    cells = [_cell("fc", 2, 4, 12, 0, assignment="push", lb="home"),
             _cell("sept", 1, 4, 12, 0)]
    assert tsweep.run_cells_scan(cells, metrics_only=True, device="cpu") \
        == jsweep.run_cells_scan([jsweep.SweepCell(**dataclasses.asdict(x))
                                  for x in cells], metrics_only=True)
    key = (1 | 1 << 3,) + (256, 1, 4, 16, 1, 10, 1, 1, 1, 0)
    flags = tfp._key_flags(key)
    assert flags["freeze"] and flags["cold"] and not flags["dyn"]
