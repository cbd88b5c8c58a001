"""Fig 6's grid through the port's ``run_sweep`` against the JAX package's,
on the CPU (``benchmarks/fig6_multinode.py::spec``, 2 seeds).

FC on 2, 3 and 4 pull nodes of 18 cores and the stock baseline on 4, one
72-core burst at intensity 30.  On the ``"scan"`` backend every cell of
this grid runs on the reference event loop in both packages and is marked
``degraded``: the baseline is never scanned, and 18 cores on the
cluster's 40 GB nodes leave the warm regime the scan models (which holds
up to 13 cores for the eleven SeBS functions).

Contracts (tolerance 0): the port's rows and ``meta`` equal the JAX
package's under ``backends=("scan",)``; under ``("reference",)`` the port's
rows equal the JAX package's rows of the same cells without their
``degraded`` key (the JAX package ran them on its reference loop), and
nothing is degraded; ``SweepResult.find`` gives the four configurations
the benchmark reads.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

from repro.core import sweep as jsweep
from repro_torch.core import fastpath as tfp
from repro_torch.core import sweep as tsweep

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.fig6_multinode import spec as fig6_spec  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

AXES = ("policies", "modes", "nodes", "cores", "intensities",
        "workload_cores", "seeds", "cell_filter")


@pytest.fixture(scope="module")
def fig6():
    # the pool spawns: this process runs JAX's threads, and a fork could
    # copy a lock one of them holds
    jspec = dataclasses.replace(fig6_spec(quick=True), backends=("scan",))
    axes = {k: getattr(jspec, k) for k in AXES}
    want = jsweep.run_sweep(jspec, workers=1)
    got = {be: tsweep.run_sweep(tsweep.SweepSpec(**axes, backends=(be,)),
                                workers=2, executor="spawn", device="cpu")
           for be in ("scan", "reference")}
    return want, got


def test_scan_rows_and_meta_equal_jax(fig6):
    want, got = fig6
    mine = got["scan"]
    assert [dataclasses.asdict(c.cell) for c in want.results] == \
        [dataclasses.asdict(c.cell) for c in mine.results]
    assert [c.metrics for c in want.results] == \
        [c.metrics for c in mine.results]
    assert want.meta == mine.meta
    assert mine.meta["cells"] == 8 == mine.meta["degraded"]
    assert mine.meta["scan_batched"] == 0 and mine.meta["failed"] == 0
    cell = next(c.cell for c in mine.results if c.cell.mode == "ours")
    assert tsweep._cluster_scan_capable(cell)
    assert not tfp.cluster_scan_eligible(tsweep.make_workload(cell),
                                         cell.nodes, cell.cores, "fc")
    assert tfp.cluster_scan_eligible(tsweep.make_workload(cell),
                                     cell.nodes, 13, "fc")


def test_reference_rows_equal_jax(fig6):
    want, got = fig6
    mine = got["reference"]
    assert [{k: v for k, v in c.metrics.items() if k != "degraded"}
            for c in want.results] == [c.metrics for c in mine.results]
    assert mine.meta["degraded"] == 0 and mine.meta["failed"] == 0


def test_find_gives_the_four_configurations(fig6):
    want, got = fig6
    for mode, nodes in (("baseline", 4), ("ours", 4), ("ours", 3),
                        ("ours", 2)):
        assert got["scan"].find(mode=mode, nodes=nodes) == \
            want.find(mode=mode, nodes=nodes)
        row = got["reference"].find(mode=mode, nodes=nodes)
        assert row["seeds"] == 2 and row["R_avg"] > 0
