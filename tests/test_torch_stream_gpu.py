"""The pull kernels' stream instantiations (``csrc/event_step_stream.cu``:
``event_step_kernel`` and ``dyn_kernel`` with STREAM) against the plain
version, on the card.  A CUDA kernel has no CPU mode, so these tests carry
the ``gpu`` marker and skip where there is no card; run them on a card
with

    python -m pytest -q -m gpu tests/test_torch_stream_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_stream_scan.py`` holds the plain version to the JAX
package's stream on the CPU).  Tolerance: 0 -- in every chunk of a replay,
the kernel and the plain version start from the chunk's handed-off planes
and inputs, and rows ``[:n]`` of start / finish / prio / node, the summary
and the final carry planes ``clk`` / ``ctr`` are ``torch.equal``; the
replay on the card equals the replay on the CPU.

Inputs: seeded request streams replayed in chunks small enough to hand off
a backlog several times: float32 SEPT and FC (FC with history rows) at 1,
2, 4 and 8 slots a lane and on 20 nodes x 18 cores (the wide path);
float64 with the autoscaler, with a kill and node speeds, and cold starts;
34 nodes autoscaling to 40 (the float64 wide path); and the planet fleet's
first chunks (benchmarks/engine_bench.py::_planet_fleet: 10,000 functions,
96 nodes autoscaling to 128, chunk 512).  The float64 wide path's dispatch
from group summaries (``tests/wide_dispatch_cases.py``): 300 and 2,100
functions under all five policies with a kill, chunks small enough that
each hands calls still queued to the next; cold starts on 300 functions;
and the EECT burst whose two bases merge once ``now`` is added.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import streamscan, synth
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.core.request import Request
from repro_torch.core.stragglers import NodeSpeedProfile
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from wide_dispatch_cases import (  # noqa: E402
    TIE_CORES,
    TIE_NODES,
    many_fn_requests,
    merged_bases_requests,
)

FNS = ("dynamic-html", "uploader", "thumbnailer", "compression")
TRACE = (Path(__file__).resolve().parent.parent / "data"
         / "azure_trace_slice.csv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _requests(n, seed, span=25.0):
    rng = np.random.default_rng(seed)
    return [Request(fn=FNS[int(rng.integers(0, len(FNS)))], r=float(r),
                    p_true=float(rng.uniform(0.05, 0.9)))
            for r in np.sort(rng.uniform(0, span, n))]


def _replay_checked(stream, cuda, chunk, **kw):
    """Replay ``stream`` on the card, holding the kernel to the plain
    version on every chunk's start planes.  Returns the result and each
    chunk's plan."""
    plans = []

    def hook(i, inp, clk, ctr, static):
        n = inp["t"].shape[1] - 1
        k0, r0 = ops.STREAM_LAUNCHES, ops.STREAM_REF_LAUNCHES
        ref = ops.event_step(clk, ctr, inp, force="ref", **static)
        got = ops.event_step(clk, ctr, inp, **static)
        torch.cuda.synchronize()
        assert (ops.STREAM_LAUNCHES, ops.STREAM_REF_LAUNCHES) == (k0 + 1,
                                                                 r0 + 1)
        for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
            assert a.dtype == b.dtype, name
            assert torch.equal(a[:, :n], b[:, :n]), f"chunk {i}: {name}"
        assert ref[4].keys() == got[4].keys()
        for k in ref[4]:
            assert torch.equal(ref[4][k], got[4][k]), f"chunk {i}: {k}"
        plans.append(ops.event_step_plan(
            n1=n + 1, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            n_fns=inp["ring0"].shape[2], window=static["window"],
            f64=clk.dtype == torch.float64, dyn=static["dyn"],
            cold=static["cold"], stream=True))

    res = streamscan.simulate_cluster_stream(stream, chunk=chunk,
                                             device=cuda, chunk_hook=hook,
                                             **kw)
    assert len(plans) == res.chunks > 1
    return res, plans


def _equal_results(a, b):
    for f in ("start", "finish", "prio", "node", "cold"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f
    assert a.counters == b.counters
    assert (a.nodes_used, a.chunks, a.peak_rows) == (b.nodes_used, b.chunks,
                                                     b.peak_rows)


def _check(reqs, cuda, chunk, **kw):
    stream, _ = streamscan.stream_from_requests(reqs)
    got, plans = _replay_checked(stream, cuda, chunk, **kw)
    cpu = streamscan.simulate_cluster_stream(stream, chunk=chunk,
                                             device="cpu", **kw)
    _equal_results(got, cpu)
    assert np.isfinite(got.finish).all()
    return got, plans


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ("sept", "fc"))
@pytest.mark.parametrize("nodes,cores,per_lane", [(2, 4, 1), (4, 16, 2),
                                                  (8, 16, 4), (16, 16, 8)])
def test_stream_f32_narrow(cuda, policy, nodes, cores, per_lane):
    n = max(200, 5 * nodes * cores)
    _, plans = _check(_requests(n, seed=nodes + cores, span=20.0), cuda, 64,
                      nodes=nodes, cores_per_node=cores, policy=policy)
    assert {p["per_lane"] for p in plans} == {per_lane}
    assert all(p["staged"] and not p["wide"] for p in plans)


@pytest.mark.gpu
def test_stream_f32_wide(cuda):
    _, plans = _check(_requests(900, seed=3, span=10.0), cuda, 256,
                      nodes=20, cores_per_node=18, policy="fc")
    assert all(p["wide"] for p in plans)


@pytest.mark.gpu
def test_stream_f64_autoscale(cuda):
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=2.0,
                          scale_up_queue_per_slot=1.0, provision_delay_s=3.0,
                          max_nodes=6)
    got, plans = _check(_requests(260, seed=1), cuda, 32, nodes=2,
                        cores_per_node=2, policy="fifo", dynamics=dyn)
    assert got.nodes_used > 2
    assert all(not p["wide"] for p in plans)


@pytest.mark.gpu
def test_stream_f64_failure_speeds(cuda):
    dyn = ClusterDynamics(fail=((1, 6.0),), failure_detect_s=0.5)
    got, _ = _check(_requests(160, seed=7), cuda, 32, nodes=3,
                    cores_per_node=2, policy="sept", dynamics=dyn,
                    profile=NodeSpeedProfile(speeds=(1.0, 0.3, 5.0)))
    assert got.counters["failures"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ("sept", "fc"))
def test_stream_f64_cold(cuda, policy):
    got, _ = _check(_requests(140, seed=6), cuda, 32, nodes=2,
                    cores_per_node=2, policy=policy, warm=False)
    assert got.counters["cold_starts"] > 0


@pytest.mark.gpu
def test_stream_f64_wide(cuda):
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=1.0,
                          scale_up_queue_per_slot=0.5, provision_delay_s=2.0,
                          max_nodes=40)
    got, plans = _check(_requests(700, seed=9, span=12.0), cuda, 128,
                        nodes=34, cores_per_node=1, policy="rect",
                        dynamics=dyn)
    assert got.nodes_used > 34
    assert all(p["wide"] for p in plans)


@pytest.mark.gpu
def test_stream_planet_chunks(cuda):
    """The planet fleet's first chunks at chunk 512: 16,384 functions and
    128 nodes, the float64 kernel's wide path."""
    model = synth.expand_catalog(synth.fit_azure_csv(TRACE), 10_000,
                                 rate_scale=40.0, tail_alpha=0.7)
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=15.0,
                          scale_up_queue_per_slot=0.5, provision_delay_s=60.0,
                          max_nodes=128)
    got, plans = _replay_checked(
        model.stream(7, max_invocations=1200), cuda, 512, nodes=96,
        cores_per_node=1, policy="sept", assignment="pull", warm=True,
        container_mb=4, dynamics=dyn)
    assert all(p["wide"] and p["per_lane"] == 4 for p in plans)
    assert np.isfinite(got.finish).all() and got.n == 1200


POLICIES = ("fifo", "sept", "eect", "rect", "fc")


def _check_handoffs(reqs, cuda, chunk, **kw):
    """``_check``, and the chunks' log: some chunk starts with calls still
    queued (more carried rows than the slots could hold)."""
    log: list = []
    got, plans = _check(reqs, cuda, chunk, chunk_log=log, **kw)
    slots = kw["nodes"] * kw["cores_per_node"]
    assert max(c["carried"] for c in log) > slots
    assert all(p["wide"] for p in plans)
    return got, plans


@pytest.mark.gpu
@pytest.mark.parametrize("n_fns", [300, 2100])
@pytest.mark.parametrize("policy", POLICIES)
def test_stream_f64_wide_functions(cuda, policy, n_fns):
    dyn = ClusterDynamics(fail=((1, 6.0),), failure_detect_s=0.5)
    got, _ = _check_handoffs(
        many_fn_requests(Request, n_fns + 300, n_fns, seed=11, span=25.0),
        cuda, 256, nodes=3, cores_per_node=4, policy=policy, dynamics=dyn)
    assert got.counters["failures"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ("sept", "fc"))
def test_stream_f64_wide_functions_cold(cuda, policy):
    got, _ = _check_handoffs(
        many_fn_requests(Request, 600, 300, seed=12, span=25.0), cuda, 128,
        nodes=3, cores_per_node=4, policy=policy, warm=False,
        container_mb=4)
    assert got.counters["cold_starts"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("same_group", (True, False))
def test_stream_f64_eect_merged_bases(cuda, same_group):
    dyn = ClusterDynamics(fail=((0, 1e6),))
    got, plans = _check(merged_bases_requests(Request, same_group), cuda, 4,
                        nodes=TIE_NODES, cores_per_node=TIE_CORES,
                        policy="eect", dynamics=dyn)
    assert all(p["wide"] for p in plans)
    # events 4 and 5 are B's and A's second calls: B's went first
    assert got.start[4] < got.start[5]
