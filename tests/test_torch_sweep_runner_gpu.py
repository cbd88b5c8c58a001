"""The port's sweep runner on the card: ``run_sweep`` / ``run_cell`` with
the ``event_step`` kernels.  A CUDA kernel has no CPU mode, so these tests
carry the ``gpu`` marker and skip where there is no card; run them on a
card with

    python -m pytest -q -m gpu tests/test_torch_sweep_runner_gpu.py

This file imports no JAX (``tests/test_torch_sweep_runner.py`` holds the
runner to the JAX package on the CPU).  Tolerance 0 throughout:

* a cell over ``STREAM_CELL_THRESHOLD`` rows (lowered here) that
  ``run_cell`` replays through the chunked stream on the card gives the
  row of ``run_cells_scan``'s whole-burst bucket on the card, and of the
  plain version;
* a kernel that does not build raises out of ``run_sweep`` on the card --
  batched, cross-checked, ``run_cells_scan(strict=False)`` -- and never
  becomes a ``failed`` or ``degraded`` row;
* a cross-checked 2 x 4 pull grid on the card: ``failed`` and ``degraded``
  0, the sampled cells within ``CLUSTER_XCHECK_RTOL`` of the reference
  ``Cluster`` with exact counts, the kernel's launches counted, no plain
  launch, and the card's rows equal the plain version's.
"""

import dataclasses

import pytest
import torch

from repro_torch.core import sweep as tsweep
from repro_torch.kernels import build, ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernels are CUDA only")
    return torch.device("cuda")


def test_stream_routed_row_equals_whole_burst(cuda, monkeypatch):
    monkeypatch.setattr(tsweep, "STREAM_CELL_THRESHOLD", 1024)
    cell = tsweep.SweepCell(policy="sept", nodes=16, cores=8, intensity=60,
                            workload_cores=128, backend="scan")
    reqs = tsweep.make_workload(cell)
    assert len(reqs) == 8448      # over the stream's 8,192-row chunks
    ops.reset_launches()
    row = tsweep.run_cell(cell, device=cuda)
    counts = ops.launches()
    assert counts["event_step_stream"]["kernel"] > 1
    assert all(c["plain"] == 0 for c in counts.values())
    whole = tsweep.run_cells_scan([cell], device=cuda)[0]
    assert row == whole
    assert whole == tsweep.run_cells_scan([cell], device="cpu")[0]


def _broken_build(monkeypatch):
    """Every event_step source fails to build in this process."""
    monkeypatch.setattr(ops, "_event_step_fns", {})
    monkeypatch.setattr(build, "_LIBS", {})
    for src in set(ops.EVENT_STEP_SOURCES.values()) | {"event_step"}:
        monkeypatch.setitem(build._FAILED, src, "forced build failure")


def test_failing_build_raises(cuda, monkeypatch):
    _broken_build(monkeypatch)
    axes = dict(policies=("fc",), nodes=(2,), cores=(4,), intensities=(10,),
                seeds=2, backends=("scan",))
    for extra in ({}, {"validate": "cross-check"}):
        with pytest.raises(RuntimeError, match="forced build failure"):
            tsweep.run_sweep(tsweep.SweepSpec(**axes, **extra), workers=2,
                             device=cuda)
    cells = tsweep.SweepSpec(**axes).cells()
    with pytest.raises(RuntimeError, match="forced build failure"):
        tsweep.run_cells_scan(cells, strict=False, device=cuda)


def test_cross_checked_grid_on_the_card(cuda):
    spec = tsweep.SweepSpec(policies=("fifo", "sept", "eect", "rect", "fc"),
                            nodes=(2,), cores=(4,), intensities=(10, 20, 30),
                            seeds=4, workload_cores=8, backends=("scan",),
                            validate="cross-check", validate_stride=2)
    ops.reset_launches()
    res = tsweep.run_sweep(spec, workers=2, device=cuda)
    counts = ops.launches()
    meta = res.meta
    assert meta["cells"] == 60 and meta["failed"] == 0
    assert meta["degraded"] == 0
    assert meta["scan_batched"] + meta["xcheck_sampled"] == 60
    assert meta["xcheck_sampled"] > 0
    errs = [cr.metrics["xcheck_err"] for cr in res.results
            if cr.cell.cross_check]
    assert max(errs) <= tsweep.CLUSTER_XCHECK_RTOL
    assert counts["event_step"]["kernel"] > 0
    assert all(c["plain"] == 0 for c in counts.values())
    plain = [dataclasses.replace(cr.cell, cross_check=False)
             for cr in res.results]
    assert tsweep.run_cells_scan(plain, device="cpu") == \
        [{k: v for k, v in cr.metrics.items() if k != "xcheck_err"}
         for cr in res.results]
