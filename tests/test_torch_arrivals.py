"""The port's workloads -- every arrival process, Fig 5's fairness burst,
Azure-style traces -- and the per-function metric columns, against the JAX
package on the CPU.

Contracts (tolerance 0):

* ``make_workload`` gives the JAX package's requests call for call (``fn``,
  ``r``, ``p_true``) for every arrival kind: uniform, Poisson, diurnal,
  MMPP, ramp, fairness, and the trace at repeat 1 and 2 and scale 1 and
  1.5; the generators take the same keyword knobs; ``profile_for`` maps
  every function of the trace as the JAX package's;
* ``SweepSpec.cells()`` yields the JAX package's cells, labels and order
  for Fig 5 (``benchmarks/fig5_fairness.py``), the arrival-stress grid
  (``examples/sweep_grid.py::build_spec``, full and quick) and the cold
  matrix's pull half, and ``chip_smoke.py``'s grids are those;
  ``_workload_key`` groups cells as the JAX package's;
* ``run_cells_scan`` rows, with ``metrics_only`` and written back, equal the
  JAX package's on a cut of Fig 5 (its per-function columns included) and
  on the quick arrival-stress grid.

The JAX float64 scan is not used here (these cells are warm); the cold
regime's tests are in ``tests/test_torch_cold_scan.py``.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

from repro.core import sweep as jsweep
from repro.core import traces as jtraces
from repro.core import workload as jworkload
from repro_torch.core import sweep as tsweep
from repro_torch.core import traces as ttraces
from repro_torch.core import workload as tworkload

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "examples"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from benchmarks.engine_bench import matrix_specs  # noqa: E402
from benchmarks.fig5_fairness import spec as fig5_spec  # noqa: E402
from sweep_grid import build_spec  # noqa: E402

TRACE = str(ROOT / "data" / "azure_trace_slice.csv")


def _port_cell(jcell) -> tsweep.SweepCell:
    """The port's cell of a JAX package cell (the port's fields)."""
    return tsweep.SweepCell(**{f.name: getattr(jcell, f.name)
                               for f in dataclasses.fields(tsweep.SweepCell)})


def _ref_label(jcell) -> str:
    return dataclasses.replace(jcell, backend="reference").label()


def _same_requests(want, got):
    assert len(want) == len(got) > 0
    assert [(q.fn, q.r, q.p_true) for q in want] == \
        [(q.fn, q.r, q.p_true) for q in got]


# -- workloads ----------------------------------------------------------------
WORKLOADS = {
    "uniform": dict(arrival="uniform", cores=5, intensity=30),
    "poisson": dict(arrival="poisson", cores=5, intensity=30, seed=3),
    "diurnal": dict(arrival="diurnal", cores=4, intensity=40, seed=1),
    "mmpp": dict(arrival="mmpp", cores=5, intensity=60, seed=2),
    "ramp": dict(arrival="ramp", cores=4, intensity=20, seed=4),
    "fairness": dict(arrival="fairness", cores=10, intensity=90, seed=1),
    "fairness-cluster": dict(arrival="fairness", nodes=2, cores=4,
                             intensity=30),
    "poisson-workload-cores": dict(arrival="poisson", nodes=3, cores=4,
                                   intensity=25, workload_cores=16),
    **{f"trace-r{r}-s{s:g}": dict(arrival="trace", cores=10, intensity=0,
                                  trace_path=TRACE, trace_repeat=r,
                                  trace_scale=s, seed=r)
       for r in (1, 2) for s in (1.0, 1.5)},
}


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
def test_make_workload_equals_jax(kind):
    cell = tsweep.SweepCell(**WORKLOADS[kind])
    want = jsweep.make_workload(jsweep.SweepCell(**dataclasses.asdict(cell)))
    _same_requests(want, tsweep.make_workload(cell))


KNOBS = {
    "diurnal": dict(period_s=20.0, depth=0.3),
    "mmpp": dict(burst_factor=8.0, burst_fraction=0.1, burst_sojourn_s=2.0),
    "ramp": dict(burst_factor=3.0, burst_start_frac=0.5, burst_end_frac=0.9),
}


@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_arrival_knobs_equal_jax(kind):
    kw = dict(cores=6, intensity=20, seed=7, kind=kind, duration_s=30.0,
              functions=["sleep", "graph-bfs", "thumbnailer"], **KNOBS[kind])
    _same_requests(jworkload.generate_trace_burst(**kw),
                   tworkload.generate_trace_burst(**kw))


def test_arrival_kinds_and_refusals_equal_jax():
    assert tworkload.ARRIVAL_KINDS == jworkload.ARRIVAL_KINDS
    for bad in (dict(kind="nope"), dict(kind="diurnal", depth=2.0),
                dict(kind="mmpp", burst_factor=0.5),
                dict(kind="ramp", burst_start_frac=0.6,
                     burst_end_frac=0.5)):
        for mod in (jworkload, tworkload):
            with pytest.raises(ValueError):
                mod.generate_trace_burst(cores=2, intensity=5, seed=0, **bad)
    with pytest.raises(ValueError, match="trace_path"):
        tsweep.make_workload(tsweep.SweepCell(arrival="trace"))


def test_trace_loading_and_profiles_equal_jax():
    want, got = jtraces.load_azure_trace(TRACE), ttraces.load_azure_trace(TRACE)
    assert want == got and len(got) == 32
    for fn in list(got) + list(tworkload.FUNCTIONS) + ["x", "my-fn-7"]:
        assert ttraces.profile_for(fn) == jtraces.profile_for(fn), fn
    assert ttraces.tile_trace(got, 3, 0.7) == jtraces.tile_trace(want, 3, 0.7)
    _same_requests(jtraces.requests_from_trace(want, 5, max_minutes=4),
                   ttraces.requests_from_trace(got, 5, max_minutes=4))


# -- cells and keys -----------------------------------------------------------
def _specs():
    cold = dict(matrix_specs())["cold"]
    return {
        "fig5": fig5_spec().cells(),
        "arrival-stress": build_spec(False).cells(),
        "arrival-stress-quick": build_spec(True).cells(),
        "cold-pull": [c for c in cold.cells() if c.assignment == "pull"],
    }


def test_spec_cells_equal_jax():
    """The port's SweepSpec yields the JAX package's cells, labels and order
    on the three grids, and ``chip_smoke.py``'s grids are them."""
    import chip_smoke

    mine = {"fig5": chip_smoke.fig5_cells(5),
            "arrival-stress": chip_smoke.arrival_cells(),
            "arrival-stress-quick": tsweep.SweepSpec(
                policies=("fifo", "sept", "eect", "rect", "fc"),
                intensities=(30,), cores=(5,),
                arrivals=("uniform", "poisson"), seeds=2).cells(),
            "cold-pull": chip_smoke.cold_pull_cells()}
    sizes = {"fig5": 10, "arrival-stress": 270, "arrival-stress-quick": 20,
             "cold-pull": 30}
    for name, want in _specs().items():
        got = mine[name]
        assert len(want) == sizes[name] == len(got), name
        assert [_port_cell(c) for c in want] == got, name
        assert [_ref_label(c) for c in want] == [c.label() for c in got]
    cut = chip_smoke.fig5_cells(40)
    assert [_port_cell(c) for c in dataclasses.replace(
        fig5_spec(), seeds=40).cells()] == cut
    assert all(c.per_function == ("dna-visualisation", "graph-bfs")
               for c in cut)
    assert all(not c.warm for c in mine["cold-pull"])


def test_workload_key_groups_as_jax():
    jcells = [c for want in _specs().values() for c in want]
    jcells += [jsweep.SweepCell(arrival="trace", trace_path=TRACE,
                                trace_repeat=r, trace_scale=s, seed=k)
               for r in (1, 2) for s in (1.0, 1.5) for k in (0, 1)]
    for c in jcells:
        assert tsweep._workload_key(_port_cell(c)) == jsweep._workload_key(c)


# -- rows ---------------------------------------------------------------------
def _grid(name):
    if name == "fig5":
        # Fig 5's cells cut to 6 cores and one seed (594 calls a cell)
        return dataclasses.replace(fig5_spec(quick=True), seeds=1,
                                   cores=(6,)).cells()
    return build_spec(True).cells()


@pytest.mark.parametrize("grid", ["fig5", "arrival-stress-quick"])
@pytest.mark.parametrize("metrics_only", [True, False])
def test_run_cells_scan_rows_equal_jax(grid, metrics_only):
    jcells = _grid(grid)
    want = jsweep.run_cells_scan(jcells, metrics_only=metrics_only)
    got = tsweep.run_cells_scan([_port_cell(c) for c in jcells],
                                metrics_only=metrics_only, device="cpu")
    for c, w, g in zip(jcells, want, got):
        assert set(w) == set(g), c.label()
        assert w == g, (c.label(), {k: (w[k], g[k]) for k in w
                                    if w[k] != g[k]})
    if grid == "fig5":
        for r in got:
            assert {"R_avg:dna-visualisation", "S_avg:dna-visualisation",
                    "R_avg:graph-bfs", "S_avg:graph-bfs"} <= set(r)
