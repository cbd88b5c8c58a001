"""The frozen-priority kernels' stream instantiations
(``csrc/event_step_freeze_stream.cu``: ``freeze_kernel`` and
``freeze64_kernel`` with STREAM) against the plain version, on the card.  A
CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_freeze_stream_gpu.py

This file imports no JAX, so it runs where only the port is installed
(``tests/test_torch_freeze_stream_scan.py`` holds the plain version to the
JAX package's stream on the CPU).  Tolerance: 0 -- in every chunk of a
replay, the kernel and the plain version start from the chunk's handed-off
planes and inputs, and rows ``[:n]`` of start / finish / prio / node, the
summary and the final carry planes ``clk`` / ``ctr`` are ``torch.equal``;
the replay on the card equals the replay on the CPU.

Inputs: seeded request streams replayed in chunks small enough to hand off
a backlog several times, each as in the CPU file: float32 push FC at 1, 2,
4 and 8 slots a lane, push home SEPT, single-node FC (the static counts)
and 16 nodes x 18 cores (the wide path); float64 push SEPT with a kill,
steal hedging on nodes of speeds (1.0, 0.7, 1.3) (and with a kill and the
autoscaler), resilience with jittered retries, cold push FC, and 34 nodes
autoscaling to 40 (the float64 stream sets all take the wide path); and
the planet fleet's first two chunks under push
(benchmarks/engine_bench.py::_planet_fleet: 10,000 functions, 96 nodes
autoscaling to 128, chunk 512).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import streamscan, synth
from repro_torch.core.cluster import ClusterDynamics
from repro_torch.core.resilience import (AdmissionPolicy, ResilienceSpec,
                                         RetryPolicy, TimeoutSpec)
from repro_torch.core.request import Request
from repro_torch.core.stragglers import HedgingSpec, NodeSpeedProfile
from repro_torch.kernels import ops

FNS = ("dynamic-html", "uploader", "thumbnailer", "compression")
TRACE = (Path(__file__).resolve().parent.parent / "data"
         / "azure_trace_slice.csv")
HEDGE = HedgingSpec(mode="steal", multiple=3.0, floor_s=0.5)
SPEEDS = NodeSpeedProfile(speeds=(1.0, 0.7, 1.3))
RES = ResilienceSpec(
    timeout=TimeoutSpec(multiple=3.0, floor_s=0.4),
    retry=RetryPolicy(max_attempts=3, base_delay_s=0.3, cap_delay_s=2.0,
                      jitter=0.5),
    admission=AdmissionPolicy(threshold_s=1.5))


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


def _replay_checked(stream, cuda, chunk, max_chunks=None, **kw):
    """Replay ``stream`` on the card, holding the kernel to the plain
    version on every chunk's start planes (the first ``max_chunks``).
    Returns the result and each checked chunk's plan and static
    arguments."""
    seen = []

    def hook(i, inp, clk, ctr, static):
        if max_chunks is not None and i >= max_chunks:
            return
        n = inp["t"].shape[1] - 1
        k0 = ops.FREEZE_STREAM_LAUNCHES
        r0 = ops.FREEZE_STREAM_REF_LAUNCHES
        ref = ops.event_step(clk, ctr, inp, force="ref", **static)
        got = ops.event_step(clk, ctr, inp, **static)
        torch.cuda.synchronize()
        assert (ops.FREEZE_STREAM_LAUNCHES,
                ops.FREEZE_STREAM_REF_LAUNCHES) == (k0 + 1, r0 + 1)
        for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
            assert a.dtype == b.dtype, name
            assert torch.equal(a[:, :n], b[:, :n]), f"chunk {i}: {name}"
        assert ref[4].keys() == got[4].keys()
        for k in ref[4]:
            assert torch.equal(ref[4][k], got[4][k]), f"chunk {i}: {k}"
        plan = ops.event_step_plan(
            n1=n + 1, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            n_fns=inp["ring0"].shape[2], window=static["window"],
            freeze=True, fc_push=static["fc_push"],
            fc_ring=static["fc_ring"], f64=clk.dtype == torch.float64,
            dyn=static["dyn"], cold=static["cold"], hedge=static["hedge"],
            res=static["res"], stream=True)
        seen.append((plan, dict(static)))

    ops.reset_launches()
    res = streamscan.simulate_cluster_stream(stream, chunk=chunk,
                                             device=cuda, chunk_hook=hook,
                                             **kw)
    counts = ops.launches()
    # the replay's own launches: one stream kernel a chunk, nothing else
    assert counts["event_step_freeze_stream"]["kernel"] == (
        res.chunks + len(seen))
    assert counts["event_step_freeze_stream"]["plain"] == len(seen)
    assert all(v["kernel"] == 0 and v["plain"] == 0
               for k, v in counts.items() if k != "event_step_freeze_stream")
    assert len(seen) == (res.chunks if max_chunks is None
                         else min(max_chunks, res.chunks)) > 1
    return res, seen


def _equal_results(a, b):
    for f in ("start", "finish", "prio", "node", "cold", "failed",
              "attempts"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f
    assert a.counters == b.counters
    assert (a.nodes_used, a.chunks, a.peak_rows) == (b.nodes_used, b.chunks,
                                                     b.peak_rows)


def _check(reqs, cuda, chunk, **kw):
    stream, _ = streamscan.stream_from_requests(reqs)
    got, seen = _replay_checked(stream, cuda, chunk, assignment="push", **kw)
    cpu = streamscan.simulate_cluster_stream(stream, chunk=chunk,
                                             device="cpu", assignment="push",
                                             **kw)
    _equal_results(got, cpu)
    return got, [p for p, _ in seen], [s for _, s in seen]


@pytest.mark.gpu
@pytest.mark.parametrize("nodes,cores,per_lane", [(3, 2, 1), (4, 16, 2),
                                                  (8, 16, 4), (16, 16, 8)])
def test_freeze_stream_f32_push_fc(cuda, nodes, cores, per_lane):
    n = max(200, 5 * nodes * cores)
    got, plans, statics = _check(_requests(n, seed=nodes + cores, span=20.0),
                                 cuda, 64, nodes=nodes, cores_per_node=cores,
                                 policy="fc")
    assert {p["per_lane"] for p in plans} == {per_lane}
    assert all(not p["wide"] for p in plans)
    assert all(s["fc_push"] for s in statics)
    assert np.isfinite(got.finish).all()


@pytest.mark.gpu
def test_freeze_stream_f32_home(cuda):
    got, _, _ = _check(_requests(140, seed=5), cuda, 17, nodes=3,
                       cores_per_node=2, policy="sept", lb="home")
    assert np.isfinite(got.finish).all()


@pytest.mark.gpu
def test_freeze_stream_f32_one_node_fc(cuda):
    got, _, statics = _check(_requests(140, seed=4), cuda, 17, nodes=1,
                             cores_per_node=4, policy="fc")
    assert not any(s["fc_push"] for s in statics)    # the static counts
    assert np.isfinite(got.finish).all()


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ("sept", "fc"))
def test_freeze_stream_f32_wide(cuda, policy):
    _, plans, _ = _check(_requests(900, seed=3, span=10.0), cuda, 256,
                         nodes=16, cores_per_node=18, policy=policy)
    assert all(p["wide"] for p in plans)


@pytest.mark.gpu
def test_freeze_stream_f64_kill(cuda):
    dyn = ClusterDynamics(fail=((1, 6.0),), failure_detect_s=0.5)
    got, plans, _ = _check(_requests(140, seed=7), cuda, 17, nodes=3,
                           cores_per_node=2, policy="sept", dynamics=dyn)
    assert got.counters["failures"] > 0
    # the float64 stream sets take the wide path at every width
    assert all(p["wide"] and p["per_lane"] == 1 for p in plans)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ("sept", "fc"))
def test_freeze_stream_f64_steal(cuda, policy):
    got, _, _ = _check(_requests(140, seed=8, span=12.0), cuda, 17, nodes=3,
                       cores_per_node=2, policy=policy, profile=SPEEDS,
                       hedging=HEDGE)
    assert got.counters["backups_issued"] > 0


@pytest.mark.gpu
def test_freeze_stream_f64_steal_kill_autoscale(cuda):
    dyn = ClusterDynamics(fail=((1, 4.0),), failure_detect_s=0.5,
                          autoscale=True, autoscale_interval_s=2.0,
                          max_nodes=5)
    got, _, _ = _check(_requests(140, seed=8, span=10.0), cuda, 17, nodes=3,
                       cores_per_node=2, policy="fc", profile=SPEEDS,
                       hedging=HEDGE, dynamics=dyn)
    assert got.counters["failures"] > 0
    assert got.counters["backups_issued"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", (17, 64))
def test_freeze_stream_f64_res(cuda, chunk):
    got, _, _ = _check(_requests(160, seed=9, span=12.0), cuda, chunk,
                       nodes=2, cores_per_node=2, policy="sept",
                       resilience=RES)
    c = got.counters
    assert c["retries_issued"] > 0 and c["timed_out"] > 0 and c["shed"] > 0


@pytest.mark.gpu
def test_freeze_stream_f64_cold(cuda):
    got, _, _ = _check(_requests(140, seed=6), cuda, 17, nodes=2,
                       cores_per_node=2, policy="fc", warm=False)
    assert got.counters["cold_starts"] > 0


@pytest.mark.gpu
def test_freeze_stream_f64_wide(cuda):
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=1.0,
                          scale_up_queue_per_slot=0.5, provision_delay_s=2.0,
                          max_nodes=40)
    got, plans, _ = _check(_requests(700, seed=9, span=12.0), cuda, 128,
                           nodes=34, cores_per_node=1, policy="sept",
                           dynamics=dyn)
    assert got.nodes_used > 34
    assert all(p["wide"] for p in plans)


@pytest.mark.gpu
def test_freeze_stream_planet_chunks(cuda):
    """The planet fleet under push, its first two chunks at chunk 512:
    16,384 functions and 128 nodes, the float64 kernel's wide path."""
    model = synth.expand_catalog(synth.fit_azure_csv(TRACE), 10_000,
                                 rate_scale=40.0, tail_alpha=0.7)
    dyn = ClusterDynamics(autoscale=True, autoscale_interval_s=15.0,
                          scale_up_queue_per_slot=0.5, provision_delay_s=60.0,
                          max_nodes=128)
    got, seen = _replay_checked(
        model.stream(7, max_invocations=1200), cuda, 512, max_chunks=2,
        nodes=96, cores_per_node=1, policy="sept", assignment="push",
        warm=True, container_mb=4, dynamics=dyn)
    assert all(p["wide"] and p["per_lane"] == 4 for p, _ in seen)
    assert np.isfinite(got.finish).all() and got.n == 1200
