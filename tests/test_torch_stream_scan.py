"""The port's chunked stream replay on the pull regime against the JAX
package, on the CPU.

The JAX package scans ``dyn`` / ``het`` / ``cold`` buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).  The JAX
package's replays are made once a module (``jax_runs``), so its compiles
are shared.

Contracts (tolerance 0):

* the stream carry planes have the JAX package's layout (the ``qcnt``
  segment at the JAX package's offsets);
* the synthesizer (``fit_azure_csv``, ``expand_catalog``,
  ``SynthModel.stream``) and the lazy tiled trace make the JAX package's
  streams, chunk for chunk and array for array;
* the tie-safe rebatcher cuts where the JAX package's does, and
  ``stream_supported`` answers as the JAX package's;
* ``simulate_cluster_stream(device="cpu")`` (the plain version) equals the
  JAX package's replay -- every call's start, finish, priority, node and
  cold-start flag, the counters, the nodes used, the chunks and peak rows,
  and the summary but its wall time, rate and bytes (the port counts its
  own device footprint) -- at two chunk budgets that hand off a backlog
  several times, on pull SEPT and FC (float32; FC with history rows), the
  autoscaler, a kill with node speeds, and cold starts; the same replays
  equal the port's whole-burst scan; and on the planet fleet at full width
  (benchmarks/engine_bench.py::_planet_fleet: 10,000 functions, 96 nodes
  autoscaling to 128) over a 3,000-invocation prefix at chunk 1,024;
* a push stream replays (``tests/test_torch_freeze_stream_scan.py`` holds
  it to the JAX package's), a duplicate-hedging stream raises
  ``ValueError``, and a chunk whose step budget runs out
  ``StreamBudgetError``.

The CUDA kernels are held against the plain version in
``tests/test_torch_stream_gpu.py``, on the card.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import fastpath as jfp
from repro.core import streamscan as js
from repro.core import synth as jsy
from repro.core import traces as jtr
from repro.core.cluster import ClusterDynamics as JDyn
from repro.core.request import Request as JReq
from repro.core.stragglers import HedgingSpec as JHedge
from repro.core.stragglers import NodeSpeedProfile as JProf
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import streamscan as ts
from repro_torch.core import synth as tsy
from repro_torch.core import traces as ttr
from repro_torch.core.cluster import ClusterDynamics as TDyn
from repro_torch.core.request import Request as TReq
from repro_torch.core.stragglers import HedgingSpec as THedge
from repro_torch.core.stragglers import NodeSpeedProfile as TProf
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TRACE = ROOT / "data" / "azure_trace_slice.csv"
FNS = ("dynamic-html", "uploader", "thumbnailer", "compression")
CHUNKS = (32, 64)
# (cell arguments, dynamics, speeds): each with 140 calls of seed 4
CASES = {
    "sept": (dict(nodes=3, cores_per_node=2, policy="sept"), None, None),
    "fc": (dict(nodes=3, cores_per_node=2, policy="fc"), None, None),
    "autoscale": (dict(nodes=2, cores_per_node=2, policy="fifo"),
                  dict(autoscale=True, autoscale_interval_s=2.0,
                       scale_up_queue_per_slot=1.0, provision_delay_s=3.0,
                       max_nodes=6), None),
    "fail_speeds": (dict(nodes=3, cores_per_node=2, policy="sept"),
                    dict(fail=((1, 6.0),), failure_detect_s=0.5),
                    (1.0, 0.3, 5.0)),
    "cold": (dict(nodes=2, cores_per_node=2, policy="sept", warm=False),
             None, None),
}
PLANET = dict(nodes=96, cores_per_node=1, policy="sept", assignment="pull",
              warm=True, container_mb=4)
PLANET_DYN = dict(autoscale=True, autoscale_interval_s=15.0,
                  scale_up_queue_per_slot=0.5, provision_delay_s=60.0,
                  max_nodes=128)


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _requests(req, n=140, seed=4, span=25.0):
    rng = np.random.default_rng(seed)
    return [req(fn=FNS[int(rng.integers(0, len(FNS)))], r=float(r),
                p_true=float(rng.uniform(0.05, 0.9)))
            for r in np.sort(rng.uniform(0, span, n))]


def _kwargs(case, jax_side: bool) -> dict:
    kw, dyn, speeds = CASES[case]
    kw = dict(kw)
    if dyn is not None:
        kw["dynamics"] = (JDyn if jax_side else TDyn)(**dyn)
    if speeds is not None:
        kw["profile"] = (JProf if jax_side else TProf)(speeds=speeds)
    return kw


def _planet(sy):
    return sy.expand_catalog(sy.fit_azure_csv(TRACE), 10_000,
                             rate_scale=40.0, tail_alpha=0.7)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's replays, made once: each case at each chunk
    budget, and the planet prefix."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        out = {}
        for case in CASES:
            for chunk in CHUNKS:
                stream, _ = js.stream_from_requests(_requests(JReq))
                out[case, chunk] = js.simulate_cluster_stream(
                    stream, chunk=chunk, **_kwargs(case, True))
        out["planet"] = js.simulate_cluster_stream(
            _planet(jsy).stream(7, max_invocations=3000), chunk=1024,
            dynamics=JDyn(**PLANET_DYN), **PLANET)
    return out


def _equal_replays(got, want):
    for f in ("t", "fnid", "p", "start", "finish", "prio", "node", "cold",
              "failed", "attempts", "resp", "stretch"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=True), f
    assert got.counters == want.counters
    assert (got.nodes_used, got.n, got.chunks, got.peak_rows) == (
        want.nodes_used, want.n, want.chunks, want.peak_rows)
    skip = ("wall_s", "rate", "peak_bytes")
    sg, sw = got.summary(), want.summary()
    assert {k: v for k, v in sg.items() if k not in skip} == \
        {k: v for k, v in sw.items() if k not in skip}
    if want.timeline is not None:
        assert got.timeline.activate == want.timeline.activate
        assert got.timeline.deactivate == want.timeline.deactivate


@pytest.mark.parametrize("dyn,cold", [(False, False), (True, True)])
def test_stream_layout_matches_jax(dyn, cold):
    n1, NN, NS, F, W = 65, 4, 2, 8, 10
    mask = (1 << 9) | (1 << 7 if dyn else 0) | (1 << 3 if cold else 0)
    key = (mask, n1 - 1, NN, NS, F, 1, W, 1, 1, 1, 64)
    spec = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
            for k, v in jfp._alloc_bucket_inputs(key, 1).items()}
    with jax.enable_x64(dyn or cold):
        ref = jfp._carry_layout(spec, n_nodes=NN, n_slots=NS, window=W,
                                freeze=False, fc_push=False, dyn=dyn,
                                het=False, hedge=False, cold=cold, dup=False,
                                n_copies=1, fc_ring=1, stream=True)
    got = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F,
                              n1=n1, dyn=dyn, cold=cold, stream=True)
    assert got.fparts == ref.fparts and got.iparts == ref.iparts
    # the bucket inputs: the JAX package's keys and shapes, but the JAX
    # package's frozen-priority dummies (cnt, home0, route)
    mine = tfp._alloc_bucket_inputs(key, 1)
    theirs = jfp._alloc_bucket_inputs(key, 1)
    for k, v in mine.items():
        assert v.shape == theirs[k].shape and v.dtype == theirs[k].dtype, k
    assert set(theirs) - set(mine) == {"cnt", "home0", "route"}


def test_synth_equals_jax():
    jm, tm = jsy.fit_azure_csv(TRACE), tsy.fit_azure_csv(TRACE)
    for a, b in ((jm, tm), (_planet(jsy), _planet(tsy))):
        assert a.fns == b.fns and a.profile_names == b.profile_names
        assert a.zipf_alpha == b.zipf_alpha and a.minute_s == b.minute_s
        assert np.array_equal(a.popularity, b.popularity)
        assert np.array_equal(a.minute_rate, b.minute_rate)
        assert a.mean_rate_per_s == b.mean_rate_per_s
    for model, n_min in ((jm, 2), (_planet(jsy), 1)):
        want = list(model.stream(7, max_invocations=5000).iter_chunks())
        mine = tm if model is jm else _planet(tsy)
        got = list(mine.stream(7, max_invocations=5000).iter_chunks())
        assert len(got) == len(want) >= n_min
        for g, w in zip(got, want):
            for f in ("r", "fn", "p"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert sum(len(c.r) for c in got) == 5000
    with pytest.raises(ValueError):
        tsy.SynthModel.stream(tm)


def test_tiled_stream_equals_jax():
    trace = {"dynamic-html": [3, 0, 5], "graph-bfs": [1, 4], "x-fn": [2]}
    want = list(jtr.tiled_stream(trace, seed=3, repeat=3,
                                 scale=1.5).iter_chunks())
    got = list(ttr.tiled_stream(trace, seed=3, repeat=3,
                                scale=1.5).iter_chunks())
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for f in ("r", "fn", "p"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f


@pytest.mark.parametrize("hint", [1, 3, 7, 50])
def test_batches_equal_jax(hint):
    """Runs of equal times (each minute's arrivals at a few instants) are
    never cut; the cuts and horizons are the JAX package's."""
    rng = np.random.default_rng(hint)
    t = np.sort(rng.integers(0, 12, 60).astype(np.float64))
    fn, p = rng.integers(0, 3, 60), rng.uniform(0.1, 1.0, 60)

    def chunks(mod):
        return mod.ArrivalStream(fns=("a", "b", "c"), chunks=lambda: (
            mod.StreamChunk(r=t[lo:lo + 9], fn=fn[lo:lo + 9],
                            p=p[lo:lo + 9]) for lo in range(0, 60, 9)))

    want = list(js._batches(chunks(js), hint))
    got = list(ts._batches(chunks(ts), hint))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            assert np.array_equal(a, b)
        assert g[3:] == w[3:]
        if not g[4]:
            assert g[0][-1] < g[3]        # the horizon splits no tie


def test_stream_supported_equals_jax():
    dyn = (None, JDyn(), JDyn(autoscale=True))
    hed = (None, "steal", "duplicate")
    for policy in ("fc", "sept", "lottery"):
        for assignment in ("pull", "push", "round_robin"):
            for lb in ("least_loaded", "home", "random"):
                for warm in (True, False):
                    for d in dyn:
                        for h in hed:
                            kw = dict(policy=policy, assignment=assignment,
                                      lb=lb, warm=warm)
                            want = js.stream_supported(
                                dynamics=d, hedging=h and JHedge(mode=h),
                                **kw)
                            got = ts.stream_supported(
                                dynamics=d and TDyn(**vars(d)),
                                hedging=h and THedge(mode=h), **kw)
                            assert got == want, (kw, d, h)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_jax(jax_runs, case, chunk):
    stream, _ = ts.stream_from_requests(_requests(TReq))
    got = ts.simulate_cluster_stream(stream, chunk=chunk, device="cpu",
                                     **_kwargs(case, False))
    want = jax_runs[case, chunk]
    assert want.chunks > 2
    _equal_replays(got, want)
    if case == "autoscale":
        assert got.nodes_used > 2
    if case == "fail_speeds":
        assert got.counters["failures"] > 0
    if case == "cold":
        assert got.counters["cold_starts"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_whole_burst_scan(case):
    """The replay is event for event the port's whole-burst scan."""
    reqs = _requests(TReq)
    stream, order = ts.stream_from_requests(reqs)
    got = ts.simulate_cluster_stream(stream, chunk=CHUNKS[0], device="cpu",
                                     **_kwargs(case, False))
    ref = tfp.simulate_cluster_scan(
        [TReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs],
        device="cpu", **_kwargs(case, False))
    for f in ("start", "finish", "node", "priority"):
        want = np.array([getattr(r, f) for r in ref.requests])[order]
        if f == "node":
            want = np.array([int(w[4:]) for w in want])
        have = got.prio if f == "priority" else getattr(got, f)
        assert np.array_equal(have, want.astype(have.dtype)), f
    assert np.array_equal(got.cold, np.array(
        [r.cold_start for r in ref.requests])[order])
    assert got.counters["failures"] == ref.failures
    assert got.counters["cold_starts"] == ref.cold_starts
    assert got.counters["evictions"] == ref.evictions
    assert got.nodes_used == ref.nodes_used
    # write-back gives the whole-burst scan's requests
    back = [TReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs]
    got.write_back(back, order)
    for a, b in zip(back, ref.requests):
        assert (a.start, a.finish, a.node, a.c) == (b.start, b.finish,
                                                    b.node, b.c)


def test_planet_prefix_equals_jax(jax_runs):
    """The planet fleet at full width: 3,000 invocations at chunk 1,024."""
    got = ts.simulate_cluster_stream(
        _planet(tsy).stream(7, max_invocations=3000), chunk=1024,
        dynamics=TDyn(**PLANET_DYN), device="cpu", **PLANET)
    want = jax_runs["planet"]
    assert (want.chunks, want.peak_rows, want.nodes_used) == (4, 1024, 97)
    _equal_replays(got, want)


def test_push_stream_replays_and_duplicate_refused():
    """A push stream replays (``tests/test_torch_freeze_stream_scan.py``
    holds it to the JAX package's); duplicate hedging is refused."""
    stream, _ = ts.stream_from_requests(_requests(TReq, n=20))
    got = ts.simulate_cluster_stream(stream, nodes=2, cores_per_node=2,
                                     policy="sept", assignment="push",
                                     chunk=8, device="cpu")
    assert got.n == 20 and got.chunks > 1
    assert np.isfinite(got.finish).all() and (got.failed == 0).all()
    with pytest.raises(ValueError):
        ts.simulate_cluster_stream(stream, nodes=2, cores_per_node=2,
                                   policy="sept", device="cpu",
                                   hedging=THedge(mode="duplicate"))


def test_step_budget_cut_short_raises(monkeypatch):
    """A chunk that does not drain is refused, never run again."""
    stream, _ = ts.stream_from_requests(_requests(TReq))
    runs = []

    def short(key):
        static = tfp._scan_static(key)
        runs.append(key)
        return dict(static, n_steps=static["n_steps"] // 8)

    monkeypatch.setattr(ts, "_scan_static", short)
    with pytest.raises(ts.StreamBudgetError):
        ts.simulate_cluster_stream(stream, chunk=64, device="cpu",
                                   **_kwargs("sept", False))
    assert len(runs) == 1
