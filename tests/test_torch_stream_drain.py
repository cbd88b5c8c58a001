"""The stream's drain check on float32 planes, against both packages'
whole-burst scans, on the CPU.

A chunk's scan stops at its first event at or past its horizon
``t_stop``, compared in the planes' dtype: on a float32 plane, an event at
``float32(t_stop)`` is the next chunk's even when ``t_stop`` (float64) lies
just above it.  The host's drain check compares as the scan does, so such
a chunk is not refused with ``StreamBudgetError``.

Inputs: a 140-call burst of seed 52 on 3 nodes of 2 cores, chunk 17, whose
first horizon rounds down in float32 onto a call's finish: pull FIFO,
SEPT, RECT and FC (float32 planes) and push FC and SEPT.  Each replay (the
plain version) equals the port's whole-burst scan and the JAX package's,
call for call: start, finish, priority and node (tolerance 0).  The JAX package's
own stream raises on this burst, so it is not the reference here.
"""

import numpy as np
import pytest

from repro.core import fastpath as jfp
from repro.core.request import Request as JReq
from repro_torch.core import fastpath as tfp
from repro_torch.core import streamscan as ts
from repro_torch.core.request import Request as TReq
from torch_threads import one_torch_thread  # noqa: E402,F401

FNS = ("dynamic-html", "uploader", "thumbnailer", "compression")
CELL = dict(nodes=3, cores_per_node=2)
CHUNK = 17


def _requests(req, n=140, seed=52, span=25.0):
    rng = np.random.default_rng(seed)
    return [req(fn=FNS[int(rng.integers(0, len(FNS)))], r=float(r),
                p_true=float(rng.uniform(0.05, 0.9)))
            for r in np.sort(rng.uniform(0, span, n))]


def _rows(result, order):
    """start, finish, priority and node of a whole-burst result, in the
    stream's event order."""
    reqs = result.requests
    out = {f: np.array([getattr(r, f) for r in reqs])[order]
           for f in ("start", "finish", "priority")}
    out["node"] = np.array([int(r.node[4:]) for r in reqs])[order]
    return out


def test_the_first_horizon_rounds_onto_a_completion():
    """The burst's point: its first chunk's horizon rounds down in float32
    onto a call's finish, which the float64 horizon lies above."""
    stream, _ = ts.stream_from_requests(_requests(TReq))
    log: list = []
    got = ts.simulate_cluster_stream(stream, chunk=CHUNK, policy="sept",
                                     device="cpu", chunk_log=log, **CELL)
    t_stop = log[0]["t_stop"]
    t32 = np.float32(t_stop)
    assert float(t32) < t_stop
    assert (got.finish == float(t32)).any()


@pytest.mark.parametrize("assignment,policy", [
    ("pull", "fifo"), ("pull", "sept"), ("pull", "rect"), ("pull", "fc"),
    ("push", "fc"), ("push", "sept")])
def test_stream_drains_and_equals_both_whole_burst_scans(assignment,
                                                         policy):
    reqs = _requests(TReq)
    stream, order = ts.stream_from_requests(reqs)
    got = ts.simulate_cluster_stream(stream, chunk=CHUNK, policy=policy,
                                     assignment=assignment, device="cpu",
                                     **CELL)
    assert got.chunks > 2
    port = tfp.simulate_cluster_scan(
        [TReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs],
        policy=policy, assignment=assignment, device="cpu", **CELL)
    jax_side = jfp.simulate_cluster_scan(
        [JReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs],
        policy=policy, assignment=assignment, **CELL)
    have = {"start": got.start, "finish": got.finish, "priority": got.prio,
            "node": got.node}
    for ref in (_rows(port, order), _rows(jax_side, order)):
        for f, want in ref.items():
            assert np.array_equal(have[f], want.astype(have[f].dtype)), f
