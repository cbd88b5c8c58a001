"""The port's base-pull cluster scan, end to end, against the JAX package.

Contracts (tolerance 0 throughout -- every comparison is ``==``):

* ``repro_torch.core.workload.generate_burst`` gives the JAX package's
  burst, call for call, for several seeds;
* ``simulate_cluster_cells_scan(..., device="cpu")`` writes back the same
  per-request start, finish, priority and node as
  ``repro.core.fastpath.simulate_cluster_cells_scan``, for all five
  policies on 1, 2 and 4 nodes at several intensities;
* ``run_cells_scan(metrics_only=True)`` rows equal the JAX package's
  ``run_cells_scan`` rows, every key, on a grid of the mega grid's shape,
  and equal the port's own write-back rows;
* ``SweepSpec.cells()`` yields the JAX package's cells in its order;
* importing the port and running a cell loads no ``jax`` module and nothing
  of ``repro``;
* with no card, an entry point called without ``device=`` raises.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro.core import sweep as jsweep
from repro.core.workload import generate_burst as jax_burst
from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core import sweep as tsweep
from repro_torch.core.workload import generate_burst

ROOT = Path(__file__).resolve().parent.parent
POLICIES = ("fifo", "sept", "eect", "rect", "fc")


def _mega_shaped(mod, seeds, **kw):
    """The mega grid's axes (``benchmarks/engine_bench.py::mega_spec``),
    cut to a few seeds, as a SweepSpec of ``mod``."""
    axes = dict(policies=POLICIES, nodes=(2, 4), cores=(8,),
                intensities=(10, 15, 20, 25, 30), seeds=seeds,
                workload_cores=16)
    axes.update(kw)
    if mod is jsweep:
        axes["backends"] = ("scan",)
    return mod.SweepSpec(**axes)


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_generate_burst_matches_jax(seed):
    a = jax_burst(cores=16, intensity=20, seed=seed)
    b = generate_burst(cores=16, intensity=20, seed=seed)
    assert [(q.fn, q.r, q.p_true) for q in a] == \
        [(q.fn, q.r, q.p_true) for q in b]
    c = generate_burst(cores=16, intensity=20,
                       rng=np.random.default_rng(seed))
    assert [(q.fn, q.r, q.p_true) for q in c] == \
        [(q.fn, q.r, q.p_true) for q in b]


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_write_back_matches_jax(policy):
    grid = [(nodes, inten) for nodes in (1, 2, 4) for inten in (6, 15)]
    batch_j = [(jax_burst(cores=4, intensity=v, seed=s), nodes, 4, policy)
               for s, (nodes, v) in enumerate(grid)]
    batch_t = [(generate_burst(cores=4, intensity=v, seed=s), nodes, 4,
                policy) for s, (nodes, v) in enumerate(grid)]
    res_j = jfp.simulate_cluster_cells_scan(batch_j)
    res_t = tfp.simulate_cluster_cells_scan(batch_t, device="cpu")
    for (nodes, v), rj, rt in zip(grid, res_j, res_t):
        assert rt.nodes_used == rj.nodes_used == nodes
        got = [(q.start, q.finish, q.priority, q.node, q.c)
               for q in rt.requests]
        want = [(q.start, q.finish, q.priority, q.node, q.c)
                for q in rj.requests]
        assert got == want, (policy, nodes, v)


def test_single_cell_wrapper_matches_batch():
    a = generate_burst(cores=4, intensity=10, seed=3)
    b = generate_burst(cores=4, intensity=10, seed=3)
    one = tfp.simulate_cluster_scan(a, nodes=2, cores_per_node=4,
                                    policy="rect", device="cpu")
    (many,) = tfp.simulate_cluster_cells_scan([(b, 2, 4, "rect")],
                                              device="cpu")
    assert [(q.start, q.finish, q.node) for q in one.requests] == \
        [(q.start, q.finish, q.node) for q in many.requests]


def test_metrics_rows_match_jax():
    cells_j = _mega_shaped(jsweep, 2, policies=("fifo", "sept", "fc"),
                           intensities=(10, 20)).cells()
    cells_t = _mega_shaped(tsweep, 2, policies=("fifo", "sept", "fc"),
                           intensities=(10, 20)).cells()
    assert not any(c.cross_check for c in cells_j)
    rows_j = jsweep.run_cells_scan(cells_j, metrics_only=True)
    rows_t = tsweep.run_cells_scan(cells_t, metrics_only=True,
                                   device="cpu")
    assert rows_t == rows_j
    # the write-back path gives the same rows as the metrics-only one
    sample = cells_t[::5]
    assert tsweep.run_cells_scan(sample, device="cpu") == rows_t[::5]


def test_sweep_cells_match_jax_order():
    cells_j = _mega_shaped(jsweep, 20).cells()
    cells_t = _mega_shaped(tsweep, 20).cells()
    assert len(cells_t) == len(cells_j) == 5 * 2 * 5 * 20
    names = [f.name for f in dataclasses.fields(tsweep.SweepCell)]
    for cj, ct in zip(cells_j, cells_t):
        assert {k: getattr(cj, k) for k in names} == \
            dataclasses.asdict(ct)


def test_ineligible_cells_raise():
    reqs = generate_burst(cores=4, intensity=5, seed=0)
    for item in ((reqs, 2, 4, "fc", "push", "round_robin"),
                 (reqs, 2, 4, "fc", "pull", "least_loaded", None, None,
                  object()),
                 # cold, beyond the ample-memory prewarm regime
                 (reqs, 2, 64, "fc", "pull", "least_loaded", None, None, None,
                  False),
                 (reqs, 2, 4, "baseline"),
                 (reqs, 2, 64, "sept")):       # beyond the warm regime
        with pytest.raises(ValueError):
            tfp.simulate_cluster_cells_scan([item], device="cpu")
    with pytest.raises(ValueError):            # no such arrival process
        tsweep.run_cells_scan([tsweep.SweepCell(nodes=1, cores=4,
                                                intensity=5,
                                                arrival="bursty")],
                              device="cpu")


def test_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "from repro_torch.core.sweep import SweepCell, run_cells_scan\n"
        "rows = run_cells_scan([SweepCell(policy='fc', nodes=2, cores=4,"
        " intensity=5)], metrics_only=True, device='cpu')\n"
        "assert rows[0]['n'] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    reqs = generate_burst(cores=4, intensity=5, seed=0)
    cell = tsweep.SweepCell(policy="sept", nodes=2, cores=4, intensity=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.run_cells_scan([cell], metrics_only=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfp.simulate_cluster_cells_scan([(reqs, 2, 4, "sept")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tfp.simulate_cluster_scan(reqs, nodes=2, cores_per_node=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        bucket_from_numpy({"t": np.zeros((1, 2), dtype=np.float32)})
