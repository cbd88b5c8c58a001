"""The port's sweep runner (``repro_torch.core.sweep.run_sweep``,
``run_cell``, ``SweepResult``) against the JAX package's, on the CPU.

Contracts (tolerance 0: rows are compared with ``==``, key for key):

* ``run_sweep(..., device="cpu")`` gives the JAX package's cells, rows and
  ``meta`` (``cells``, ``scan_batched``, ``degraded``, ``failed``,
  ``errors``, ``xcheck_sampled``, ``xcheck_skipped_degraded``) on
  ``examples/sweep_grid.py``'s quick spec (reference, vectorized and its
  cross-check form), on a cross-checked cut of the mega grid's axes on
  the scan (sampled cells dual-run against the reference ``Cluster``,
  ``xcheck_err`` equal), and on a scan grid mixing batched cells, the
  stock baseline and round-robin push, which degrade as in the JAX
  package;
* a scan cell over ``STREAM_CELL_THRESHOLD`` rows (lowered in both
  packages' modules) replays through the chunked stream in ``run_cell``,
  and its row equals the JAX package's, and the whole-burst row;
* the push-kill cell whose JAX scan leaves ``CLUSTER_XCHECK_RTOL`` (SEPT,
  3 push nodes of 2 cores, a 12-core burst at intensity 20, node 0 killed
  at 20 s, seed 0) raises ``BackendMismatchError`` from ``run_cell`` in
  both packages, on the same metric and values, each with a triage
  report naming the same event; ``run_sweep`` records it as a ``failed``
  row with that message in both; so does a pull cell of the mega grid
  (SEPT, 2 x 8, intensity 30, seed 18) whose float32 scan leaves the
  budget on R_p50;
* ``SweepResult.aggregate`` / ``find`` / ``rows`` / ``to_csv`` text equal
  the JAX package's; ``workers=2`` gives the rows of ``workers=1``;
* a failing scan launch raises out of ``run_sweep`` and
  ``run_cells_scan(strict=False)`` -- never a ``failed`` or ``degraded``
  row -- and no cell that reaches the scan runs in a pool worker.

The JAX package's float64 scan enters ``jax.experimental.enable_x64``,
which JAX 0.9.0 lacks; an autouse fixture aliases ``jax.enable_x64`` for
the tests of this file alone.
"""

import dataclasses
import os
import re

import jax
import pytest
import torch

from repro.core import sweep as jsweep
from repro_torch.core import fastpath as tfp
from repro_torch.core import sweep as tsweep
from torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ("fifo", "sept", "eect", "rect", "fc")
QUICK = dict(policies=POLICIES, intensities=(30,), cores=(5,),
             arrivals=("uniform", "poisson"), seeds=2)
MEGA_CUT = dict(policies=POLICIES, nodes=(2,), cores=(4,),
                intensities=(10, 20), seeds=2, workload_cores=8,
                backends=("scan",), validate="cross-check",
                validate_stride=3)
MIXED = dict(policies=("sept", "fc"), modes=("ours", "baseline"),
             assignments=("pull", "push"),
             lbs=("least_loaded", "round_robin"), nodes=(1, 3), cores=(3,),
             intensities=(12,), seeds=1, backends=("scan",))
# pools spawn here: this process runs JAX's threads, and a fork could
# copy a lock one of them holds
SPAWN = "spawn"
PUSH_KILL = dict(policies=("sept",), assignments=("push",), nodes=(3,),
                 cores=(2,), intensities=(20,), workload_cores=12,
                 failures=(20.0,), seeds=(0,), backends=("scan",),
                 validate="cross-check")


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _both(axes, workers=1):
    want = jsweep.run_sweep(jsweep.SweepSpec(**axes), workers=1)
    got = tsweep.run_sweep(tsweep.SweepSpec(**axes), workers=workers,
                           executor=SPAWN, device="cpu")
    return want, got


def _same(want, got):
    assert [dataclasses.asdict(cr.cell) for cr in want.results] == \
        [dataclasses.asdict(cr.cell) for cr in got.results]
    assert [cr.metrics for cr in want.results] == \
        [cr.metrics for cr in got.results]
    assert want.meta == got.meta


@pytest.mark.parametrize("backend", ["reference", "vectorized",
                                     "cross-check"])
def test_quick_spec_equals_jax(backend):
    axes = dict(QUICK, backends=(backend,))
    want, got = _both(axes)
    _same(want, got)
    assert got.meta["cells"] == 20
    if backend == "cross-check":
        assert got.meta["xcheck_sampled"] == 20
        assert all(cr.metrics["xcheck_err"] == 0.0 for cr in got.results)


@pytest.fixture(scope="module")
def mega_cut():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        return _both(MEGA_CUT)


def test_cross_checked_scan_grid_equals_jax(mega_cut):
    want, got = mega_cut
    _same(want, got)
    meta = got.meta
    assert meta["cells"] == 20 and meta["failed"] == 0
    assert meta["degraded"] == 0
    assert 0 < meta["xcheck_sampled"] < 20
    assert meta["scan_batched"] == 20 - meta["xcheck_sampled"]
    errs = [cr.metrics["xcheck_err"] for cr in got.results
            if cr.cell.cross_check]
    assert len(errs) == meta["xcheck_sampled"]
    assert max(errs) <= tsweep.CLUSTER_XCHECK_RTOL


def test_result_views_equal_jax(mega_cut, tmp_path):
    want, got = mega_cut
    assert got.aggregate() == want.aggregate()
    assert got.rows("mega") == want.rows("mega")
    assert got.find(policy="fc", intensity=20) == \
        want.find(policy="fc", intensity=20)
    with pytest.raises(KeyError):
        got.find(policy="fc")
    want.to_csv(tmp_path / "want.csv")
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()
    got.to_json(tmp_path / "got.json")
    assert (tmp_path / "got.json").stat().st_size > 0


def test_mixed_scan_grid_degrades_as_jax():
    """Batched single-node and cluster cells, the stock baseline and
    round-robin push (off the scan: ``degraded``), in one grid."""
    want, got = _both(MIXED, workers=2)
    _same(want, got)
    meta = got.meta
    assert meta["scan_batched"] > 0 and meta["degraded"] > 0
    assert meta["failed"] == 0


def test_workers_give_the_rows_of_one_worker():
    axes = dict(QUICK, backends=("reference",))
    one = tsweep.run_sweep(tsweep.SweepSpec(**axes), workers=1)
    two = tsweep.run_sweep(tsweep.SweepSpec(**axes), workers=2,
                           executor=SPAWN)
    assert [cr.metrics for cr in one.results] == \
        [cr.metrics for cr in two.results]
    assert one.meta == two.meta and two.workers == 2


def test_stream_routed_cell_equals_jax(monkeypatch):
    monkeypatch.setattr(jsweep, "STREAM_CELL_THRESHOLD", 40)
    monkeypatch.setattr(tsweep, "STREAM_CELL_THRESHOLD", 40)
    axes = dict(policies=("sept",), nodes=(2,), cores=(2,),
                intensities=(10,), seeds=1, backends=("scan",),
                validate="cross-check")
    want, got = _both(axes)
    _same(want, got)
    assert got.meta["xcheck_sampled"] == 1
    cell = got.results[0].cell
    reqs = tsweep.make_workload(cell)
    assert len(reqs) == 44 > tsweep.STREAM_CELL_THRESHOLD
    assert tsweep._stream_routable(cell, reqs, None, None, None, None)
    calls = []
    real = tsweep._run_stream_cell

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    monkeypatch.setattr(tsweep, "_run_stream_cell", spy)
    plain = dataclasses.replace(cell, cross_check=False)
    row = tsweep.run_cell(plain, device="cpu")
    assert calls == ["cpu"]
    assert row == jsweep.run_cell(jsweep.SweepCell(
        **dataclasses.asdict(plain)))
    whole = tsweep.run_cells_scan([plain], device="cpu")[0]
    assert row == whole


def _split(err):
    head, _, tail = str(err).partition("\n")
    return head


def _no_ids(msg):
    """A message with its request ids blanked (each package numbers its
    requests with its own counter)."""
    return re.sub(r"req=\d+", "req=?", msg)


def test_push_kill_cell_raises_in_both():
    cell = jsweep.SweepSpec(**PUSH_KILL).cells()[0]
    assert cell.cross_check and cell.fail_at == 20.0
    with pytest.raises(jsweep.BackendMismatchError) as jerr:
        jsweep.run_cell(cell)
    with pytest.raises(tsweep.BackendMismatchError) as terr:
        tsweep.run_cell(tsweep.SweepCell(**dataclasses.asdict(cell)),
                        device="cpu")
    assert _split(terr.value) == _split(jerr.value)
    assert "R_avg" in _split(terr.value)
    jr, tr = jerr.value.report, terr.value.report
    assert tr is not None and jr is not None
    assert (tr.kind, tr.fld, tr.ref_value, tr.got_value, tr.occurrence) == \
        (jr.kind, jr.fld, jr.ref_value, jr.got_value, jr.occurrence)
    assert _no_ids(str(terr.value)) == _no_ids(str(jerr.value))
    # run_sweep: a failed row in both, the same message in meta["errors"]
    want, got = _both(PUSH_KILL)
    assert [cr.metrics for cr in got.results] == \
        [cr.metrics for cr in want.results] == [{"failed": 1.0}]
    assert {k: v for k, v in got.meta.items() if k != "errors"} == \
        {k: v for k, v in want.meta.items() if k != "errors"}
    assert got.meta["failed"] == 1
    assert {k: _no_ids(v) for k, v in got.meta["errors"].items()} == \
        {k: _no_ids(v) for k, v in want.meta["errors"].items()}
    (msg,) = got.meta["errors"].values()
    assert msg.startswith("BackendMismatchError: " + _split(terr.value))


def test_pull_tie_cell_raises_in_both():
    """SEPT on 2 pull nodes of 8 cores, a 16-core burst at intensity 30,
    seed 18 (a cell of the mega grid): the float32 scan's near-tie order
    leaves ``CLUSTER_XCHECK_RTOL`` on R_p50 (7.8%) against the reference
    ``Cluster`` in both packages, on the same metric and values; the
    port's scan row equals the JAX package's."""
    cell = jsweep.SweepCell(policy="sept", nodes=2, cores=8, intensity=30,
                            workload_cores=16, seed=18, backend="scan",
                            cross_check=True)
    with pytest.raises(jsweep.BackendMismatchError) as jerr:
        jsweep.run_cell(cell)
    tcell = tsweep.SweepCell(**dataclasses.asdict(cell))
    with pytest.raises(tsweep.BackendMismatchError) as terr:
        tsweep.run_cell(tcell, device="cpu")
    assert _split(terr.value) == _split(jerr.value)
    assert "R_p50" in _split(terr.value)
    assert _no_ids(str(terr.value)) == _no_ids(str(jerr.value))
    plain = dataclasses.replace(tcell, cross_check=False)
    assert tsweep.run_cell(plain, device="cpu") == jsweep.run_cell(
        dataclasses.replace(cell, cross_check=False))


def _fail(*a, **kw):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("entry", ["simulate_cells_scan",
                                   "simulate_cluster_cells_scan"])
def test_failing_launch_raises(monkeypatch, entry):
    """A scan that fails raises out of the runner: no failed row, no
    degraded row, whatever the path (batched, cross-checked, strict off)."""
    monkeypatch.setattr(tfp, entry, _fail)
    axes = dict(policies=("fc",), nodes=(1,), cores=(3,), intensities=(8,),
                seeds=2, backends=("scan",))
    if entry == "simulate_cluster_cells_scan":
        axes["nodes"] = (2,)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            tsweep.run_sweep(tsweep.SweepSpec(**axes,
                                              validate="cross-check"),
                             workers=2, executor=SPAWN, device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tsweep.run_sweep(tsweep.SweepSpec(**axes), workers=2,
                         executor=SPAWN, device="cpu")
    cells = tsweep.SweepSpec(**axes).cells()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tsweep.run_cell(dataclasses.replace(cells[0], cross_check=True),
                        device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tsweep.run_cells_scan(cells, strict=False, device="cpu")


def test_failing_stream_launch_raises(monkeypatch):
    from repro_torch.core import streamscan
    monkeypatch.setattr(tsweep, "STREAM_CELL_THRESHOLD", 10)
    monkeypatch.setattr(streamscan, "simulate_cluster_stream", _fail)
    cell = tsweep.SweepCell(policy="sept", nodes=2, cores=2, intensity=10,
                            backend="scan")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tsweep.run_cell(cell, device="cpu")


def test_scan_cells_stay_out_of_the_pool(monkeypatch):
    """With ``workers=2`` every cell that reaches the scan runs in the
    sweep's own process: the batch and each cross-checked cell call the
    scan here; the pool gets the host-engine cells (the baseline)."""
    calls = []
    real = tfp.simulate_cluster_cells_scan

    def here(*a, **kw):
        calls.append(os.getpid())
        return real(*a, **kw)

    monkeypatch.setattr(tfp, "simulate_cluster_cells_scan", here)
    res = tsweep.run_sweep(tsweep.SweepSpec(
        policies=("fifo", "fc"), modes=("ours", "baseline"), nodes=(2,),
        cores=(3,), intensities=(8,), seeds=2,
        backends=("scan", "reference"), validate="cross-check",
        validate_stride=2), workers=2, executor=SPAWN, device="cpu")
    meta = res.meta
    assert meta["failed"] == 0 and meta["xcheck_sampled"] > 0
    assert meta["scan_batched"] > 0
    assert calls == [os.getpid()] * (1 + meta["xcheck_sampled"])
    assert tsweep._pool_method(None) == "fork"
    assert tsweep._pool_method("spawn") == "spawn"


def test_device_rule():
    """No card here: a scan cell without ``device=`` raises; a host-engine
    grid runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tsweep.run_sweep(tsweep.SweepSpec(policies=("fc",), nodes=(2,),
                                          cores=(3,), intensities=(8,),
                                          seeds=1, backends=("scan",)),
                         workers=1)
    res = tsweep.run_sweep(tsweep.SweepSpec(policies=("fc",), nodes=(2,),
                                            cores=(3,), intensities=(8,),
                                            seeds=1), workers=1)
    assert res.meta["failed"] == 0
